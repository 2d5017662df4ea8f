"""Clustered-KV attention (``repro_torch.models.kmeans_attention``) against
the JAX package's ``repro.models.kmeans_attention`` on the CPU.

The same numpy inputs go through both packages; where the reference draws
initial centroids from ``jax.random.PRNGKey(seed)`` (one key for every
vmapped head), the JAX package's own draw is handed to the port as ``c0``.
The JAX side runs its Pallas kernels in interpret mode; the port's
wrappers take their plain versions because the tensors lie on the CPU.
Everything compares in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.init import random_init
from repro.models import kmeans_attention as jkma
from repro.models.layers import attention as jattn
from repro_torch.core.kmeans import KMeansConfig
from repro_torch.core.streaming import (SufficientStats, partial_fit_step,
                                        partial_fit_step_batched)
from repro_torch.models import bridge
from repro_torch.models import kmeans_attention as kma
from repro_torch.models.layers import attention as tattn


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _blobs(rng, lead, s, d, k=6, spread=3.0):
    """Gaussian blobs: well-separated clusters, no near-ties."""
    centres = rng.normal(size=(*lead, k, d)) * spread
    lab = rng.integers(0, k, (*lead, s))
    x = np.take_along_axis(centres, lab[..., None].repeat(d, -1), axis=-2)
    return (x + rng.normal(size=(*lead, s, d))).astype(np.float32)


def _jax_c0(keys, kc, seed=0):
    """The reference's initial centroids of every head: ``random_init``
    with one PRNG key for all (keys (..., S, hd))."""
    flat = jnp.asarray(keys.reshape(-1, *keys.shape[-2:]))
    c0 = jax.vmap(lambda x: random_init(jax.random.PRNGKey(seed), x, kc))(
        flat)
    return np.asarray(c0).reshape(*keys.shape[:-2], kc, keys.shape[-1])


# ---- cluster_keys -----------------------------------------------------------

@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_cluster_keys_matches_jax(impl):
    rng = np.random.default_rng(0)
    keys = _blobs(rng, (5,), 96, 16)
    jc, ja = jax.vmap(lambda x: jkma.cluster_keys(
        x, 8, iters=5, impl=impl))(jnp.asarray(keys))
    tc, ta = kma.cluster_keys(_t(keys), 8, iters=5, impl=impl,
                              c0=_t(_jax_c0(keys, 8)))
    np.testing.assert_array_equal(_np(ta), np.asarray(ja))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=1e-5, atol=1e-6)
    assert ta.dtype == torch.int32 and tc.shape == (5, 8, 16)


def test_cluster_keys_draws_the_same_rows_in_every_problem():
    """Without ``c0`` every problem starts from the same row indices (the
    reference's one key in every head); k > S raises as ``random_init``."""
    x = torch.arange(3 * 10 * 2, dtype=torch.float32).reshape(3, 10, 2)
    c0 = kma.initial_centroids(x, 4, seed=3)
    rows = (c0[:, :, 0] / 2).long() - torch.arange(3).unsqueeze(1) * 10
    assert torch.equal(rows, rows[:1].expand(3, 4))
    assert len(set(rows[0].tolist())) == 4
    with pytest.raises(ValueError, match="k=11 > n=10"):
        kma.initial_centroids(x, 11)


# ---- _bucketize / append_to_buckets -----------------------------------------

def test_bucketize_bit_for_bit_with_overflow():
    rng = np.random.default_rng(1)
    kc, cap = 5, 4
    rows = rng.normal(size=(2, 3, 30, 6)).astype(np.float32)
    assign = rng.integers(0, kc, (2, 3, 30)).astype(np.int32)
    assign[0, 0, :12] = 2                        # 12 rows into a 4-slot bucket
    jb, jn = jax.vmap(jax.vmap(lambda v, a: jkma._bucketize(v, a, kc, cap)))(
        jnp.asarray(rows), jnp.asarray(assign))
    tb, tn = kma._bucketize(_t(rows), _t(assign), kc, cap)
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))
    assert tn.dtype == torch.int32 and int(tn.max()) == cap


def test_append_to_buckets_bit_for_bit_with_sentinel_and_overflow():
    """Rows of id ``kc`` (the refresh's sentinel) and rows past ``cap`` are
    dropped, as ``mode="drop"``; the fill saturates at ``cap``."""
    rng = np.random.default_rng(2)
    kc, cap, r = 5, 6, 24
    buckets = rng.normal(size=(3, kc, cap, 4)).astype(np.float32)
    bcount = np.array([[0, 3, 6, 5, 1], [2, 2, 2, 2, 2], [6, 0, 0, 4, 5]],
                      np.int32)
    rows = rng.normal(size=(3, r, 4)).astype(np.float32)
    assign = rng.integers(0, kc + 1, (3, r)).astype(np.int32)   # kc: sentinel
    assign[:, :3] = kc
    jb, jn = jax.vmap(jkma.append_to_buckets)(
        jnp.asarray(buckets), jnp.asarray(bcount), jnp.asarray(rows),
        jnp.asarray(assign))
    tb_in = _t(buckets)
    tb, tn = kma.append_to_buckets(tb_in, _t(bcount), _t(rows), _t(assign))
    assert tb is tb_in                                          # in place
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))
    np.testing.assert_array_equal(_np(tn), np.asarray(jn))


# ---- build / refresh / init -------------------------------------------------

def _kv(rng, b=2, s=64, kh=2, hd=16):
    k = _blobs(rng, (b, kh), s, hd).transpose(0, 2, 1, 3).copy()
    v = rng.normal(size=(b, s, kh, hd)).astype(np.float32)
    return k, v


def _jax_build(k, v, kc, cap, iters=5):
    return jax.tree_util.tree_map(np.asarray, jkma.build_clustered_cache(
        jnp.asarray(k), jnp.asarray(v), kc=kc, capacity=cap, iters=iters))


def test_build_clustered_cache_matches_jax():
    rng = np.random.default_rng(3)
    k, v = _kv(rng)
    kc, cap = 8, 12                      # some buckets overflow
    want = _jax_build(k, v, kc, cap)
    c0 = _jax_c0(k.transpose(0, 2, 1, 3), kc)
    got = bridge.caches_to_numpy(kma.build_clustered_cache(
        _t(k), _t(v), kc=kc, capacity=cap, iters=5, c0=_t(c0)))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["centroids"], want["centroids"],
                               rtol=1e-5, atol=1e-6)
    for key in ("bk", "bv", "bcount", "cweight"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key
    assert (want["bcount"] == cap).any()              # overflow exercised


def _with_recent(cache, rng, recent, rlen):
    b, kh, _, hd = cache["centroids"].shape
    return dict(cache,
                recent_k=rng.normal(size=(b, kh, recent, hd)).astype(
                    np.float32) * 3,
                recent_v=rng.normal(size=(b, kh, recent, hd)).astype(
                    np.float32),
                rlen=np.array(rlen, np.int32), pos=np.array(70, np.int32))


@pytest.mark.parametrize("decay", [0.9, 1.0])
def test_refresh_clustered_cache_matches_jax(decay):
    """A partly filled recent buffer (rlen 3 of 5): only its first rows
    enter the statistics and the buckets."""
    rng = np.random.default_rng(4)
    k, v = _kv(rng)
    cache = _with_recent(_jax_build(k, v, 8, 12), rng, 5, 3)
    want = jax.tree_util.tree_map(np.asarray, jkma.refresh_clustered_cache(
        jax.tree_util.tree_map(jnp.asarray, cache), iters=2, decay=decay))
    got = bridge.caches_to_numpy(kma.refresh_clustered_cache(
        bridge.caches_from_numpy(cache, "cpu"), iters=2, decay=decay))
    assert sorted(got) == sorted(want)
    for key in ("centroids", "cweight"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    for key in ("bk", "bv", "bcount", "recent_k", "recent_v", "rlen", "pos"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert int(got["rlen"]) == 0
    assert not np.array_equal(got["bcount"], cache["bcount"])


def test_refresh_refuses_decay_zero():
    rng = np.random.default_rng(5)
    k, v = _kv(rng, b=1, s=32)
    cache = bridge.caches_from_numpy(
        _with_recent(_jax_build(k, v, 4, 16), rng, 4, 4), "cpu")
    with pytest.raises(ValueError, match="decay"):
        kma.refresh_clustered_cache(cache, decay=0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_clustered_cache_shapes_and_dtypes(dtype):
    want = jkma.init_clustered_cache(2, 3, 16, kc=8, capacity=24, recent=5,
                                     dtype=getattr(jnp, dtype))
    got = kma.init_clustered_cache(2, 3, 16, kc=8, capacity=24, recent=5,
                                   dtype=getattr(torch, dtype), device="cpu")
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == w.shape, key
        assert str(got[key].dtype).split(".")[1] == str(w.dtype), key
        assert not bool(got[key].any()), key


# ---- decode ---------------------------------------------------------------

def _decode_inputs(rng, cache, h=4):
    b, kh, _, hd = cache["centroids"].shape
    return (rng.normal(size=(b, 1, h, hd)).astype(np.float32),
            rng.normal(size=(b, 1, kh, hd)).astype(np.float32),
            rng.normal(size=(b, 1, kh, hd)).astype(np.float32))


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_clustered_decode_attention_matches_jax(softcap):
    rng = np.random.default_rng(6)
    k, v = _kv(rng)
    cache = _with_recent(_jax_build(k, v, 8, 12), rng, 5, 2)
    q, kn, vn = _decode_inputs(rng, cache)
    jo, jc = jkma.clustered_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jax.tree_util.tree_map(jnp.asarray, cache), top=3, softcap=softcap)
    to, tc = kma.clustered_decode_attention(
        _t(q), _t(kn), _t(vn), bridge.caches_from_numpy(cache, "cpu"),
        top=3, softcap=softcap)
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=1e-5,
                               atol=1e-6)
    want = jax.tree_util.tree_map(np.asarray, jc)
    got = bridge.caches_to_numpy(tc)
    for key in ("recent_k", "recent_v", "rlen", "pos", "bk", "bcount"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_clustered_decode_takes_the_lower_index_on_tied_centroids():
    """Every centroid but 0 is zero, so clusters 1-7 tie at score 0; with
    ``top=2`` the reference's ``lax.top_k`` takes {0, 1}. The port's
    output equals the JAX package's and a plain attention over buckets 0
    and 1 and the recent buffer."""
    rng = np.random.default_rng(7)
    b, kh, kc, cap, hd, r = 1, 1, 8, 4, 8, 3
    q = rng.normal(size=(b, 1, 2, hd)).astype(np.float32)
    cents = np.zeros((b, kh, kc, hd), np.float32)
    cents[..., 0, :] = q.mean(2)[:, 0]          # scores > 0 only on 0
    cache = {
        "centroids": cents,
        "bk": rng.normal(size=(b, kh, kc, cap, hd)).astype(np.float32),
        "bv": rng.normal(size=(b, kh, kc, cap, hd)).astype(np.float32),
        "bcount": np.full((b, kh, kc), cap, np.int32),
        "cweight": np.full((b, kh, kc), cap, np.float32),
        "recent_k": np.zeros((b, kh, r, hd), np.float32),
        "recent_v": np.zeros((b, kh, r, hd), np.float32),
        "rlen": np.array(0, np.int32), "pos": np.array(40, np.int32)}
    kn = rng.normal(size=(b, 1, kh, hd)).astype(np.float32)
    vn = rng.normal(size=(b, 1, kh, hd)).astype(np.float32)
    jo, _ = jkma.clustered_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jax.tree_util.tree_map(jnp.asarray, cache), top=2)
    to, _ = kma.clustered_decode_attention(
        _t(q), _t(kn), _t(vn), bridge.caches_from_numpy(cache, "cpu"), top=2)
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=1e-5,
                               atol=1e-6)
    keys = np.concatenate([cache["bk"][0, 0, 0], cache["bk"][0, 0, 1],
                           kn[0, 0]])
    vals = np.concatenate([cache["bv"][0, 0, 0], cache["bv"][0, 0, 1],
                           vn[0, 0]])
    sc = q[0, 0] @ keys.T * hd ** -0.5
    w = np.exp(sc - sc.max(-1, keepdims=True))
    want = (w / w.sum(-1, keepdims=True)) @ vals
    np.testing.assert_allclose(_np(to)[0, 0], want, rtol=1e-5, atol=1e-6)


# ---- routed attention -------------------------------------------------------

@pytest.mark.parametrize("clusters,factor,impl", [
    (1, 1.0, "flash"), (4, 2.0, "flash"), (4, 2.0, "ref")])
def test_kmeans_routed_attention_matches_jax(clusters, factor, impl):
    rng = np.random.default_rng(8)
    b, s, h, hd = 1, 64, 2, 16
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = _blobs(rng, (b, h), s, hd).transpose(0, 2, 1, 3).copy()
    v = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    jo = jkma.kmeans_routed_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), clusters=clusters,
        window=16, capacity_factor=factor, impl=impl)
    c0 = _jax_c0(k.transpose(0, 2, 1, 3), clusters)
    to = kma.kmeans_routed_attention(
        _t(q), _t(k), _t(v), clusters=clusters, window=16,
        capacity_factor=factor, impl=impl, c0=_t(c0))
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=1e-5,
                               atol=1e-6)
    if clusters == 1:     # window ∪ one cluster covers every causal pair
        full = tattn.dot_attention(_t(q), _t(k), _t(v), causal=True)
        np.testing.assert_allclose(_np(to), _np(full), rtol=1e-4, atol=1e-5)
        jfull = jattn.dot_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True)
        np.testing.assert_allclose(_np(full), np.asarray(jfull), rtol=1e-5,
                                   atol=1e-6)


# ---- the batched refresh ----------------------------------------------------

@pytest.mark.parametrize("decay,iters", [(1.0, 1), (0.8, 2)])
def test_batched_partial_fit_equals_a_loop_of_partial_fit_step(decay, iters):
    """``partial_fit_step_batched`` over P problems (a mask of different
    lengths) equals the port's one-problem ``partial_fit_step`` run on
    each in turn."""
    rng = np.random.default_rng(9)
    p, n, kc, d = 6, 20, 5, 8
    x = torch.from_numpy(_blobs(rng, (p,), n, d))
    c = x[:, :kc].clone() + 0.1
    cnt = torch.from_numpy(rng.integers(0, 9, (p, kc)).astype(np.float32))
    mask = torch.arange(n) < torch.tensor([20, 3, 0, 11, 19, 7])[:, None]
    cfg = KMeansConfig(k=kc, max_iters=iters)
    cb, sb, ab, jb = partial_fit_step_batched(
        x, c, SufficientStats.from_centroids(c, cnt), cfg=cfg, decay=decay,
        local_iters=iters, mask=mask)
    for i in range(p):
        ci, si, ai, ji = partial_fit_step(
            x[i], c[i], SufficientStats.from_centroids(c[i], cnt[i]),
            cfg=cfg, decay=decay, local_iters=iters, mask=mask[i])
        assert torch.equal(ab[i], ai), i
        torch.testing.assert_close(cb[i], ci, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(sb.counts[i], si.counts, rtol=0, atol=0)
        torch.testing.assert_close(sb.sums[i], si.sums, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(jb[i], ji, rtol=1e-6, atol=1e-5)
    # unmasked: the same against the loop
    cb, sb, ab, _ = partial_fit_step_batched(
        x, c, SufficientStats.from_centroids(c, cnt), cfg=cfg, decay=decay,
        local_iters=iters)
    ci, si, ai, _ = partial_fit_step(
        x[3], c[3], SufficientStats.from_centroids(c[3], cnt[3]), cfg=cfg,
        decay=decay, local_iters=iters)
    assert torch.equal(ab[3], ai)
    torch.testing.assert_close(cb[3], ci, rtol=1e-6, atol=1e-6)


def test_refresh_of_stacked_groups_equals_each_group_alone():
    """The engine refreshes a (G, B, KH, ...) cache at once; each group's
    result equals refreshing that group's cache alone."""
    rng = np.random.default_rng(10)
    groups = []
    for _ in range(3):
        k, v = _kv(rng, b=1, s=48)
        groups.append(_with_recent(_jax_build(k, v, 4, 16), rng, 4, 4))
    stacked = {key: np.stack([g[key] for g in groups]) for key in groups[0]}
    got = kma.refresh_clustered_cache(
        bridge.caches_from_numpy(stacked, "cpu"), iters=2)
    for i, g in enumerate(groups):
        one = kma.refresh_clustered_cache(bridge.caches_from_numpy(g, "cpu"),
                                          iters=2)
        for key in ("centroids", "bk", "bcount", "cweight"):
            torch.testing.assert_close(got[key][i], one[key], rtol=1e-6,
                                       atol=1e-6, msg=key)
