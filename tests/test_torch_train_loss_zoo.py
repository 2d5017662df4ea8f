"""``models.model.loss_fn`` of the port against ``jax.value_and_grad`` of
the JAX package's for the rest of the zoo (MoE, MLA, xLSTM, zamba2's
Mamba2 and shared block), reduced, B 2, S 32, f32, at the tolerances of
``test_torch_train_loss.py`` (xLSTM at the reference's bfloat16 2e-2), and
remat bit for bit the loss without it.
"""
import pytest

from _torch_train_common import ARCHS, DENSE, check_loss_and_grads

ZOO = [a for a in ARCHS if a not in DENSE]


@pytest.mark.parametrize("arch", ZOO)
def test_zoo_loss_and_every_gradient_match_jax(arch):
    check_loss_and_grads(arch)
