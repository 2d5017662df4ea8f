"""``models.model.loss_fn`` of the port against ``jax.value_and_grad`` of
the JAX package's, for each of the ten reduced families (B 2, S 32, f32):
the dense-attention configs here, the rest of the zoo in
``test_torch_train_loss_zoo.py``.

The JAX package's weights cross through ``models.bridge``; the loss, its
metrics (``nll``, ``aux``, ``ntok``) and every gradient leaf are held at
rtol 1e-4, atol 1e-5, except xLSTM, whose chunk scan rounds its operands to
bfloat16 in both packages (the reference's own tolerance, rtol = atol =
2e-2; the loss at 1e-3). The port's loss with ``remat=True`` (a
``torch.utils.checkpoint`` per group) gives the same loss and gradients as
without, bit for bit. Also: the embedding's deterministic backward
(``common.segment_sum_rows``).
"""
import numpy as np
import pytest
import torch

from _torch_train_common import (DENSE, assert_grads_close, batch,
                                 check_loss_and_grads, jax_loss_grads,
                                 models, port_loss_grads, port_params)
from repro_torch.models import common


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_every_gradient_match_jax(arch):
    check_loss_and_grads(arch)


def test_labels_below_zero_are_masked_as_the_reference_masks_them():
    jcfg, tcfg, jp, npp = models("llama3-8b")
    nb = batch(jcfg, seed=3)
    nb["labels"][0, :20] = -1
    jl, jm, jg = jax_loss_grads(jcfg, jp, nb)
    tl, tm, tg = port_loss_grads(tcfg, port_params(tcfg, npp), nb,
                                 remat=False)
    assert int(tm["ntok"]) == int(jm["ntok"]) == 2 * 32 - 22
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    assert_grads_close(tg, jg, 1e-4, 1e-5)


@pytest.mark.parametrize("n,d", [(1, 3), (50, 4), (1000, 16)])
def test_segment_sum_rows_sums_each_id_once_the_same_every_run(n, d):
    rng = np.random.default_rng(n)
    rows = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    ids = torch.from_numpy(rng.zipf(1.3, n) % 37)
    got = common.segment_sum_rows(rows, ids, 40)
    want = np.zeros((40, d))
    np.add.at(want, ids.numpy(), rows.numpy().astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert got.dtype == torch.float32
    assert not got[40 - 3:].any() or (ids >= 37).any()
    assert torch.equal(got, common.segment_sum_rows(rows, ids, 40))


def test_embed_gathers_and_its_gradient_sums_repeated_ids():
    table = torch.randn(11, 5, generator=torch.Generator().manual_seed(0),
                        requires_grad=True)
    tok = torch.tensor([[3, 3, 0], [10, 3, 0]])
    ctx = common.Ctx(compute_dtype=torch.float32)
    out = common.embed({"embedding": table}, tok, ctx)
    assert torch.equal(out, table[tok])
    g = torch.randn(2, 3, 5, generator=torch.Generator().manual_seed(1))
    (got,) = torch.autograd.grad(out, table, g)
    (want,) = torch.autograd.grad(table[tok], table, g)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
