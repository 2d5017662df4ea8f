"""Shared helpers of the port's training tests (``tests/test_torch_train_*``):
the JAX package's reduced model and its weights carried to the port through
``models.bridge``, one batch made with numpy, and the two packages' loss
and gradients."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import base as jbase
from repro.core.init import random_init
from repro.models import model as JM
from repro.models.common import Ctx as JCtx
from repro_torch.configs import base as tbase
from repro_torch.models import bridge
from repro_torch.models import model as TM
from repro_torch.models.common import Ctx
from repro_torch.utils.tree import tree_leaves, tree_map

JC = JCtx(mesh=None, compute_dtype=jnp.float32)
TC = Ctx(compute_dtype=torch.float32, device="cpu")
ARCHS = sorted(jbase.all_configs())
DENSE = ["gemma2-27b", "llama3-8b", "phi-3-vision-4.2b", "starcoder2-3b",
         "whisper-base"]
B, S = 2, 32


@functools.lru_cache(maxsize=None)
def models(arch, **replace):
    """(JAX cfg, port cfg, JAX params, the port's copy as numpy)."""
    import dataclasses
    jcfg = dataclasses.replace(jbase.get_config(arch).reduced(), **replace)
    tcfg = dataclasses.replace(tbase.get_config(arch).reduced(), **replace)
    jp, _ = JM.init_model(jax.random.PRNGKey(0), jcfg, max_pos=64)
    return jcfg, tcfg, jp, jax.tree_util.tree_map(np.asarray, jp)


def port_params(tcfg, np_params):
    return bridge.params_from_numpy(tcfg, np_params, "cpu")


def batch(cfg, seed=0, b=B, s=S):
    """numpy tokens, next-token labels (the last -1) and, where the config
    has one, the frontend."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    lab = np.roll(tok, -1, 1)
    lab[:, -1] = -1
    out = {"tokens": tok, "labels": lab}
    if cfg.frontend:
        out["frontend"] = rng.normal(
            size=(b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return out


def jax_batch(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def jax_loss_grads(jcfg, jp, nb, remat=False):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, jax_batch(nb), JC, jcfg, remat=remat),
        has_aux=True)(jp)
    return loss, metrics, grads


def port_loss_grads(tcfg, tp, nb, remat, ctx=TC):
    """(loss, metrics, grads in ``jax.tree_util`` leaf order); a leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives it."""
    ps = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss, metrics = TM.loss_fn(ps, torch_batch(nb), ctx, tcfg, remat=remat)
    leaves = tree_leaves(ps)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), metrics, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, grads)]


def jax_routing_c0(x, kc, seed=0):
    """The reference's initial centroids of every routed head:
    ``random_init`` with one PRNG key for all (the port's
    ``kmeans_attention.initial_centroids`` stand-in)."""
    c0 = jax.vmap(lambda v: random_init(jax.random.PRNGKey(seed), v, kc))(
        jnp.asarray(x.detach().numpy()))
    return torch.from_numpy(np.asarray(c0))


def assert_grads_close(got, want, rtol, atol, what=""):
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(want)]
    want = jax.tree_util.tree_leaves(want)
    assert len(got) == len(want), what
    for g, w, path in zip(got, want, paths):
        g = g.detach().float().numpy()
        assert g.shape == np.shape(w), (what, path)
        assert np.isfinite(g).all(), (what, path)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


def _tols(cfg):
    """(loss, grads) as (rtol, atol)."""
    if cfg.family == "ssm":
        return (1e-3, 1e-3), (2e-2, 2e-2)
    return (1e-4, 1e-5), (1e-4, 1e-5)


def check_loss_and_grads(arch):
    """The loss, its metrics and every gradient leaf of ``arch`` against
    the reference's; with remat the same bits as without."""
    jcfg, tcfg, jp, npp = models(arch)
    nb = batch(jcfg)
    jl, jm, jg = jax_loss_grads(jcfg, jp, nb)
    tp = port_params(tcfg, npp)
    tl, tm, tg = port_loss_grads(tcfg, tp, nb, remat=False)
    (lr, la), (gr, ga) = _tols(tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=lr, atol=la)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]), rtol=lr,
                               atol=la)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=1e-4, atol=1e-6)
    assert int(tm["ntok"]) == int(jm["ntok"]) == nb["labels"].size - B
    assert_grads_close(tg, jg, gr, ga, arch)
    # remat recomputes each group in the backward: the same bits
    rl, _, rg = port_loss_grads(tcfg, tp, nb, remat=True)
    assert torch.equal(rl, tl)
    for a, b in zip(rg, tg):
        assert torch.equal(a, b), arch
