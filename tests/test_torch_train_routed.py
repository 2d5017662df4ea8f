"""The train-time cluster-routed attention of the port, differentiated,
against the JAX package's on the CPU.

``kmeans_routed_attention`` is differentiable in q, k and v in both
packages (the clustering detached); its output and gradients are held to
``jax.grad`` of the reference's ``impl="ref"`` path on the same numpy
inputs, the JAX draw of the initial centroids handed to the port (``c0``,
or ``kmeans_attention.initial_centroids`` patched). Through the model,
``loss_fn`` with ``kmeans_attn`` (the reference's
``test_kmeans_routed_train_step``: llama3-8b reduced, 4 clusters) matches
``jax.value_and_grad`` leaf for leaf, and remat gives the same bits. f32,
rtol 1e-4, atol 1e-5: the attention test's keys are Gaussian blobs, and at
the model test's seed both packages route every key and query alike (a
flipped near-tie would move the loss past the tolerance).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_common import (assert_grads_close, batch, jax_loss_grads,
                                 jax_routing_c0, models, port_loss_grads,
                                 port_params)
from repro.models import kmeans_attention as jkma
from repro_torch.models import kmeans_attention as kma

RTOL, ATOL = 1e-4, 1e-5


def _blobs(rng, lead, s, d, k=6, spread=3.0):
    centres = rng.normal(size=(*lead, k, d)) * spread
    lab = rng.integers(0, k, (*lead, s))
    x = np.take_along_axis(centres, lab[..., None].repeat(d, -1), axis=-2)
    return (x + rng.normal(size=(*lead, s, d))).astype(np.float32)


@pytest.mark.parametrize("clusters,impl", [(1, "ref"), (4, "ref"),
                                           (4, "flash")])
def test_routed_attention_output_and_grads_match_jax(clusters, impl):
    rng = np.random.default_rng(11)
    b, s, h, hd = 2, 64, 2, 16
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = _blobs(rng, (b, h), s, hd).transpose(0, 2, 1, 3).copy()
    v = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    cot = rng.normal(size=(b, s, h, hd)).astype(np.float32)

    def jf(q_, k_, v_):
        o = jkma.kmeans_routed_attention(q_, k_, v_, clusters=clusters,
                                         window=16, impl="ref")
        return jnp.sum(o * cot), o
    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    c0 = jax_routing_c0(torch.from_numpy(k.transpose(0, 2, 1, 3).reshape(
        b * h, s, hd)), clusters).reshape(b, h, clusters, hd)
    to = kma.kmeans_routed_attention(tq, tk, tv, clusters=clusters,
                                     window=16, impl=impl, c0=c0)
    tg = torch.autograd.grad((to * torch.from_numpy(cot)).sum(),
                             (tq, tk, tv))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=RTOL, atol=ATOL)
    for name, g, w in zip("qkv", tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _routed(monkeypatch):
    """llama3-8b reduced with ``kmeans_attn`` and 4 clusters (the
    reference's test), its fits started from the JAX draw."""
    monkeypatch.setattr(kma, "initial_centroids",
                        lambda x, kc, seed=0: jax_routing_c0(x, kc, seed))
    return models("llama3-8b", kmeans_attn=True, kv_cluster_k=4)


def test_routed_train_step_loss_and_grads_match_jax(monkeypatch):
    jcfg, tcfg, jp, npp = _routed(monkeypatch)
    nb = batch(jcfg, seed=5, s=64)
    jl, jm, jg = jax_loss_grads(jcfg, jp, nb)
    tl, tm, tg = port_loss_grads(tcfg, port_params(tcfg, npp), nb,
                                 remat=False)
    # the reference's own assertions (tests/models/test_layers.py:159)
    assert np.isfinite(float(tl)) and 2.0 < float(tl) < 12.0
    gn = sum(float((g.double() ** 2).sum()) for g in tg)
    assert np.isfinite(gn) and gn > 0
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    assert_grads_close(tg, jg, RTOL, ATOL, "routed")


def test_routed_remat_recomputes_the_same_clusters(monkeypatch):
    """remat re-runs each layer's Lloyd fit in the backward: the same
    clusters, so the same loss and gradients bit for bit."""
    _, tcfg, _, npp = _routed(monkeypatch)
    calls = []
    fit = kma.cluster_keys

    def recording(*a, **kw):
        out = fit(*a, **kw)
        calls.append(out)
        return out
    monkeypatch.setattr(kma, "cluster_keys", recording)
    tp = port_params(tcfg, npp)
    nb = batch(tcfg, seed=6, s=64)
    ll, _, lg = port_loss_grads(tcfg, tp, nb, remat=False)
    n = len(calls)
    assert n == tcfg.num_layers
    rl, _, rg = port_loss_grads(tcfg, tp, nb, remat=True)
    assert len(calls) == 3 * n        # forward, then the backward's re-run
    for fwd, back in zip(calls[n:2 * n], calls[2 * n:][::-1]):
        assert all(torch.equal(x, y) for x, y in zip(fwd, back))
    assert torch.equal(rl, ll)
    for a, b in zip(rg, lg):
        assert torch.equal(a, b)


def test_the_routed_path_takes_ref_on_the_cpu_and_flash_agrees(
        monkeypatch):
    """On the CPU the routed layers take ``impl="ref"`` (a CUDA tensor takes
    ``"flash"``); the same model step with the call forced to ``"flash"``
    (the kernels' plain versions here) gives the same loss."""
    _, tcfg, _, npp = _routed(monkeypatch)
    seen, force = [], {"impl": None}
    fn = kma.kmeans_routed_attention

    def recording(*a, **kw):
        seen.append(kw["impl"])
        if force["impl"]:
            kw = dict(kw, impl=force["impl"])
        return fn(*a, **kw)
    monkeypatch.setattr(kma, "kmeans_routed_attention", recording)
    tp = port_params(tcfg, npp)
    nb = batch(tcfg, seed=7, s=64)
    ref_l, _, _ = port_loss_grads(tcfg, tp, nb, remat=False)
    force["impl"] = "flash"
    fl_l, _, _ = port_loss_grads(tcfg, tp, nb, remat=False)
    assert seen == ["ref"] * (2 * tcfg.num_layers)
    np.testing.assert_allclose(float(fl_l), float(ref_l), rtol=1e-6)
