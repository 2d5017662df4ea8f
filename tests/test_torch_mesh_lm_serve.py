"""The LM path's serving over a mesh, on 4 gloo ranks of the CPU, held to
the JAX package's one-device ``Engine`` on the same numpy inputs.

One group of 4 ranks runs per module (``tests/_torch_mesh_lm_worker.py
... serve``, which imports ``repro_torch`` only): ``Engine(mesh=).generate``,
dense and clustered, for llama3-8b on 2x2 (kv heads over ``model``) and
starcoder2 on 1x4 (two kv heads: the split-KV specs), the tokens equal to
the JAX ``Engine``'s (the clustered caches' fits start from the JAX draw),
and the forward's logits on the mesh within 1e-4 of one device's.
``launch/serve.py --mesh 1x2 --mode dense|clustered --reduced`` runs on 2
ranks under a ``torchrun``-like environment
(``tests/test_torch_mesh_lm.py`` holds the training half).
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import jax_draws, models, port_params, torchrun
from repro.serve.engine import Engine as JEngine, ServeConfig as JServeConfig
from repro_torch.models import model as TM
from repro_torch.models.common import Ctx

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_mesh_lm_worker as W  # noqa: E402

B, S = 4, 32


def _prompt(cfg, name):
    return np.random.default_rng(40 + len(name)).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params, prompts = {}, {}
    for name, arch, _ in W.SERVE:
        jcfg, _, _, npp = models(arch)
        params[f"serve/{name}"] = npp
        prompts[name] = _prompt(jcfg, name)
    inp = {"params": params, "prompts": prompts, "draws": jax_draws((S,))}
    return inp, W.run_ranks(tmp_path_factory.mktemp("mesh_lm_serve"),
                            "serve", inp)


@pytest.mark.parametrize("case", W.SERVE, ids=[c[0] for c in W.SERVE])
@pytest.mark.parametrize("mode", ["dense", "clustered"])
def test_engine_on_the_mesh_matches_the_jax_engine(ranks, case, mode):
    inp, res = ranks
    name, arch, _ = case
    jcfg, _, jp, _ = models(arch)
    want = JEngine(jcfg, jp, JServeConfig(mode=mode, **W.ENGINE),
                   compute_dtype=jnp.float32).generate(
        jnp.asarray(inp["prompts"][name]), W.GEN)
    for r in res:
        np.testing.assert_array_equal(r[f"engine/{name}/{mode}"],
                                      np.asarray(want))


@pytest.mark.parametrize("case", W.SERVE, ids=[c[0] for c in W.SERVE])
def test_forward_logits_on_the_mesh_match_one_device(ranks, case):
    inp, res = ranks
    name, arch, _ = case
    _, tcfg, _, npp = models(arch)
    want = TM.forward(port_params(tcfg, npp),
                      torch.from_numpy(inp["prompts"][name]),
                      Ctx(compute_dtype=torch.float32, device="cpu"), tcfg)
    np.testing.assert_allclose(res[0][f"forward/{name}"], want.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["dense", "clustered"])
def test_launcher_serves_an_lm_on_a_1x2_mesh(tmp_path, mode):
    """``launch/serve.py --mesh 1x2 --mode dense|clustered`` on 2 ranks:
    both ranks generate the one-device launcher's ids."""
    from repro_torch.launch import serve
    argv = ["--arch", "llama3-8b", "--reduced", "--mode", mode, "--device",
            "cpu", "--batch", "2", "--prompt-len", "32", "--gen", "6",
            "--recent", "4"]
    outs, logs = torchrun(tmp_path, 2, "serve", ("ids",),
                           [*argv, "--mesh", "1x2"])
    one = serve.main(argv)
    assert all(o["ids"] == one["ids"].tolist() for o in outs)
    assert "sample ids" in logs[0] and "sample ids" not in logs[1]
