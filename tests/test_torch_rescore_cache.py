"""The port's device rescore cache and the q8 search's device path
(``repro_torch.index.rescore_cache``, ``kernels/rescore_cache.py``) against
the JAX package's (``repro.index.rescore_cache``), on the CPU.

Both packages get the same numpy inputs, made from a seed. The port runs
its insert kernel's plain version (the tensors lie on the CPU), the JAX
package its sequential ``fori_loop``. The cache state must be equal:
``sets``, ``keys``, ``ref`` and ``hand`` exactly, ``rows`` on live lanes
(an id's row is copied, never computed). Within the port, the device path
must equal the host-reservoir path bit for bit. Against the reference,
searches run on bridged indexes over tie-free data (the 16 nearest exact
distances of every query more than ``1e-6 * (max ||q||^2 + max ||x||^2)``
apart): ids equal, distances within ``rtol=1e-5`` plus ``atol = 1e-5 *
(max ||q||^2 + max ||x||^2)``, the tolerance ``tests/test_torch_index.py``
states (the packages sum ``||x||^2 - 2 q.x`` in different orders).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heuristics as jheur
from repro.index import DeviceRescoreCache as JCache
from repro.index import IVFIndex as JIVF
from repro_torch.core import heuristics as H
from repro_torch.index import (DeviceRescoreCache, IVFIndex,
                               default_rescore_kind, index_from_numpy,
                               index_to_numpy)
from repro_torch.index import ivf as _ivf
from repro_torch.index import store as _store
from repro_torch.index.bridge import CACHE_KEYS
from repro_torch.kernels import rescore_cache as rc

K = 16
N = 2000
NQ = 32


def _blobs(seed, n, k, d, spread=2.0, noise=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, n)
    x = centers[lab] + rng.standard_normal((n, d)).astype(np.float32) * noise
    return x.astype(np.float32)


def _atol(q, x):
    q, x = np.asarray(q, np.float64), np.asarray(x, np.float64)
    return 1e-5 * (float((q * q).sum(-1).max()) + float((x * x).sum(-1).max()))


def _assert_tie_free(q, x, depth=16):
    q, x = np.asarray(q, np.float64), np.asarray(x, np.float64)
    dist = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gap = np.diff(np.sort(dist, axis=1)[:, :depth], axis=1).min()
    assert gap > 0.1 * _atol(q, x), f"near-tie {gap:.3g}: pick another seed"


def _assert_cache_equal(t: DeviceRescoreCache, j: JCache):
    assert t.sets == j.sets and t.ways == j.ways
    assert t.inserted == j.inserted and t.capacity == j.capacity
    assert t.evicted == j.evicted and t.fingerprint() == j.fingerprint()
    keys = np.asarray(j.keys)
    assert np.array_equal(t.keys.numpy(), keys)
    assert np.array_equal(t.ref.numpy(), np.asarray(j.ref))
    assert np.array_equal(t.hand.numpy(), np.asarray(j.hand))
    live = keys >= 0
    assert np.array_equal(t.rows.numpy()[live], np.asarray(j.rows)[live])
    assert t.resident_bytes() == j.resident_bytes()
    assert t.meta() == j.meta()


def _assert_lookup_equal(t: DeviceRescoreCache, j: JCache, ids):
    ids = np.asarray(ids, np.int32)
    rows, found = t.lookup(ids)
    jrows, jfound = j.lookup(jnp.asarray(ids))
    assert np.array_equal(found.numpy(), np.asarray(jfound))
    assert np.array_equal(rows.numpy(), np.asarray(jrows))


# --- the cache against the reference's, on the same puts ---------------------

def _puts(case, d, rng):
    """Batches of (ids, rows) for each case."""
    if case == "unbounded-growth":
        ids = rng.permutation(1000)
        return [(ids[lo:hi], rng.standard_normal((hi - lo, d)))
                for lo, hi in ((0, 50), (50, 300), (300, 1000))]
    if case == "budget-clock":
        return [(np.arange(1000), rng.standard_normal((1000, d)))]
    # a re-insert and duplicates of one id within a batch, ids of -1 and
    # misses
    ids = np.arange(200)
    return [(ids, rng.standard_normal((200, d))),
            (np.array([5, 5, 17, -1, 199, 5, 3, 250, 250]),
             rng.standard_normal((9, d))),
            (rng.permutation(300)[:120], rng.standard_normal((120, d)))]


@pytest.mark.parametrize("case,kw", [
    ("unbounded-growth", {"init_sets": 4}),
    ("budget-clock", {"max_bytes": 64 * (4 * 16 + 8)}),
    ("reinsert-duplicates", {"init_sets": 8}),
    ("reinsert-duplicates-budget", {"max_bytes": 40 * (4 * 16 + 8)}),
    ("budget-clock-8-ways", {"max_bytes": 96 * (4 * 16 + 8), "ways": 8})])
def test_cache_state_matches_jax(case, kw):
    d = 16
    rng = np.random.default_rng(len(case))
    t = DeviceRescoreCache(d, device="cpu", **kw)
    j = JCache(d, **kw)
    for ids, x in _puts(case.replace("-budget", "").replace("-8-ways", ""),
                        d, rng):
        x = x.astype(np.float32)
        t.put(ids, x)
        j.put(ids, x)
        _assert_cache_equal(t, j)
    if kw.get("max_bytes") is not None:
        assert t.evicted > 0 and t.sets == j.sets
    probe = np.concatenate([np.arange(-1, 1100, 7), [-1, 5, 999, 4096]])
    _assert_lookup_equal(t, j, probe)
    _assert_lookup_equal(t, j, probe.reshape(-1, 2)[:, ::-1])


def test_growth_in_one_step_equals_doubling():
    """``_grow`` rehashes to the final set count at once; the reference
    doubles. Every lane, ref bit, hand and row (empty lanes' too) agree."""
    d = 4
    t = DeviceRescoreCache(d, device="cpu", init_sets=2)
    j = JCache(d, init_sets=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((7, d)).astype(np.float32)
    ids = np.array([0, 1, 2, 3, 6, 7, 1])
    t.put(ids, x)
    j.put(ids, x)
    big = np.array([4095])
    t.put(big, x[:1])
    j.put(big, x[:1])
    assert t.sets == j.sets == 1024
    assert np.array_equal(t.rows.numpy(), np.asarray(j.rows))
    _assert_cache_equal(t, j)


def test_cache_geometry_and_unported_shards():
    c = DeviceRescoreCache(32, device="cpu", max_bytes=1000 * (4 * 32 + 8))
    j = JCache(32, max_bytes=1000 * (4 * 32 + 8))
    assert (c.sets, c.capacity) == (j.sets, j.capacity) == (256, 1024)
    assert c.device_arrays()[0] is c.keys and c.device_arrays()[1] is c.rows
    assert repr(c).startswith("DeviceRescoreCache(d=32")
    # over a mesh (queue A item 6b; tests/test_torch_sharded_store.py): the
    # reference's geometry of shards regions, each sized for all the ids
    c2 = DeviceRescoreCache(32, device="cpu", shards=2,
                            max_bytes=1000 * (4 * 32 + 8))
    j2 = JCache(32, shards=2, max_bytes=1000 * (4 * 32 + 8))
    assert (c2.sets, c2.capacity) == (j2.sets, j2.capacity) == (128, 1024)
    assert c2.keys.shape == (256, 4) and "shards=2" in repr(c2)
    c2.put(np.arange(2), np.ones((2, 32), np.float32), shard=[0, 1])
    j2.put(np.arange(2), np.ones((2, 32), np.float32), shard=[0, 1])
    assert np.array_equal(c2.keys.numpy(), np.asarray(j2.keys))
    with pytest.raises(ValueError, match="2 shards"):
        c2.place(SimpleNamespace(k_axis="model", k_rank=0, n_k_shards=4))
    assert c2.shard_specs("k") == (("k", None), ("k", None, None))


def test_cache_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceRescoreCache(8)


# --- the insert kernel's wrapper and its plain version -----------------------

def test_group_by_set_orders_each_set_in_batch_order():
    ids = torch.tensor([9, 1, -1, 5, 17, 3, 1, 13], dtype=torch.int32)
    order, seg = rc.group_by_set(ids, 4)
    assert order.dtype == seg.dtype == torch.int32
    assert seg.tolist() == [0, 0, 6, 6, 7]
    # set 1: ids 9, 1, 5, 17, 1, 13 in batch order; set 3: id 3; -1 last
    assert order.tolist() == [0, 1, 3, 4, 6, 7, 5, 2]


def test_insert_contract_errors():
    s, w, d = 4, 33, 3
    args = lambda w=w, d=d, ids_dt=torch.int32: (
        torch.full((s, w), -1, dtype=torch.int32),
        torch.zeros((s, w, d)), torch.zeros((s, w), dtype=torch.int32),
        torch.zeros((s,), dtype=torch.int32),
        torch.zeros((2,), dtype=ids_dt), torch.zeros((2, d)))
    with pytest.raises(ValueError, match="ways=33"):
        rc.cache_insert_raw(*args())
    with pytest.raises(TypeError, match="ids"):
        rc.cache_insert_raw(*args(w=4, ids_dt=torch.int64))
    keys, rows, ref, hand, ids, x = args(w=4)
    with pytest.raises(ValueError, match="contiguous"):
        rc.cache_insert_raw(keys, rows.transpose(0, 1).contiguous()
                            .transpose(0, 1), ref, hand, ids, x)
    # an empty batch changes nothing
    rc.cache_insert_raw(keys, rows, ref, hand, ids[:0], x[:0])
    assert bool((keys == -1).all())


def test_default_rescore_kind_env(monkeypatch):
    monkeypatch.delenv("REPRO_RESCORE", raising=False)
    assert default_rescore_kind() == "device"
    assert _store.resolve_rescore(None) == "device"
    monkeypatch.setenv("REPRO_RESCORE", "host")
    assert default_rescore_kind() == "host"
    assert _store.resolve_rescore(None) == "host"
    assert _store.resolve_rescore("device") == "device"
    monkeypatch.setenv("REPRO_RESCORE", "bogus")
    with pytest.raises(ValueError):
        default_rescore_kind()
    with pytest.raises(ValueError, match="unknown rescore kind"):
        _store.resolve_rescore("nowhere")


# --- the search's device path ------------------------------------------------

def _build(rescore, **kw):
    x = _blobs(21, N, K, 16)
    return x, IVFIndex.build(x, k=K, max_iters=3, seed=0, device="cpu",
                             codec="q8", rescore=rescore, **kw)


@pytest.fixture(scope="module")
def device_and_host():
    x, idx_d = _build("device")
    _, idx_h = _build("host")
    return x, idx_d, idx_h


_READS = (("cpu", torch.Tensor), ("numpy", torch.Tensor),
          ("item", torch.Tensor), ("tolist", torch.Tensor))


def _count_host_reads(monkeypatch, fn):
    """Calls of ``Tensor.cpu/.numpy/.item/.tolist`` and of ``np.asarray`` as
    the port's ``index/ivf.py`` and ``index/store.py`` see it, during
    ``fn()``."""
    calls = {"n": 0}

    def spy(real):
        def wrapped(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)
        return wrapped
    for name, owner in _READS:
        monkeypatch.setattr(owner, name, spy(getattr(owner, name)))
    for mod in (_ivf, _store):
        monkeypatch.setattr(mod.np, "asarray", spy(np.asarray))
    try:
        fn()
    finally:
        monkeypatch.undo()
    return calls["n"]


def test_q8_device_search_makes_no_host_read(device_and_host, monkeypatch):
    x, idx_d, idx_h = device_and_host
    assert idx_d.store.cache is not None and idx_h.store.cache is None
    q = torch.from_numpy(x[:NQ])
    idx_d.search(q, topk=10, nprobe=8)            # warm: the plans
    n = _count_host_reads(monkeypatch,
                          lambda: idx_d.search(q, topk=10, nprobe=8))
    assert n == 0
    idx_h.search(q, topk=10, nprobe=8)
    assert _count_host_reads(
        monkeypatch, lambda: idx_h.search(q, topk=10, nprobe=8)) > 0


def test_device_path_equals_host_path_bit_for_bit():
    x, idx_d = _build("device")
    _, idx_h = _build("host")
    assert torch.equal(idx_d.centroids, idx_h.centroids)
    q = _blobs(22, NQ, K, 16)
    for step in ("built", "added"):
        for nprobe in (4, K):
            got_d = idx_d.search(q, topk=10, nprobe=nprobe)
            got_h = idx_h.search(q, topk=10, nprobe=nprobe)
            assert torch.equal(got_d[0], got_h[0]), (step, nprobe)
            assert torch.equal(got_d[1], got_h[1]), (step, nprobe)
        if step == "built":
            for idx in (idx_d, idx_h):
                idx.add(x[:150] + 0.01)
                idx.refresh()
    assert idx_d.store.cache.inserted == N + 150


def test_full_probe_device_search_equals_brute(device_and_host):
    """The unbounded cache holds every row: full probe with R covering
    the pool returns search_brute's ids."""
    x, idx_d, _ = device_and_host
    q = x[7::N // NQ][:NQ]
    _assert_tie_free(q, x)
    old = idx_d.rescore_mult
    idx_d.rescore_mult = N
    try:
        got = idx_d.search(q, topk=10, nprobe=K)
    finally:
        idx_d.rescore_mult = old
    ref = idx_d.search_brute(q, topk=10)
    assert np.array_equal(got[0].numpy(), ref[0].numpy())


def test_budgeted_cache_falls_back_to_decoded_rows():
    x, idx = _build("device", rescore_bytes=200 * (4 * 16 + 8))
    cache = idx.store.cache
    assert cache.max_bytes is not None and cache.evicted > 0
    _, idx_h = _build("host", rescore_bytes=200 * (4 * 16 + 8))
    q = x[3::N // NQ][:NQ]
    ids, dists = idx.search(q, topk=10, nprobe=K)
    assert bool(torch.isfinite(dists).all())
    ref, _ = idx.search_brute(q, topk=10)
    # the reservoir (a FIFO ring) and the cache (a clock) hold other rows:
    # both paths only fall back to the decoded codes for what they miss
    assert _ivf.recall_at_k(ids, ref) > 0.95
    assert _ivf.recall_at_k(idx_h.search(q, topk=10, nprobe=K)[0], ref) > 0.95


# --- the planner -------------------------------------------------------------

def test_plan_search_plans_rescore_with_the_scans_kernel(device_and_host):
    x, idx_d, idx_h = device_and_host
    for b in (8, 32, 256):
        pd, ph = idx_d.plan_search(b, 10, 8), idx_h.plan_search(b, 10, 8)
        assert pd[2].op == "rescore" and ph[2].op == "scan"
        for f in ("impl", "blocks", "cluster", "smem_bytes", "shape"):
            assert getattr(pd[2], f) == getattr(ph[2], f), f
        assert pd[2].hbm_bytes > ph[2].hbm_bytes
        assert pd[0] == ph[0] and pd[1] == ph[1]
    geom = idx_d.search_geometry(10, 8)
    assert geom[-2:] == idx_d.store.cache.fingerprint()
    assert idx_h.search_geometry(10, 8) == geom[:-2]
    # the warm search plans nothing
    q = x[:NQ]
    idx_d.search(q, topk=10, nprobe=8)
    before = idx_d.planner.counters()["misses"]
    hits = idx_d.planner.counters()["hits"]
    idx_d.search(q, topk=10, nprobe=8)
    assert idx_d.planner.counters()["misses"] == before
    assert idx_d.planner.counters()["hits"] == hits


def test_planner_rescore_bytes_add_the_cache_gather():
    from repro_torch.core.plan import KernelPlanner
    pl = KernelPlanner(device="cpu")
    p = pl.plan("rescore", (64, 40, 32, 10), torch.float32)
    s = pl.plan("scan", (64, 40, 32, 10), torch.float32)
    assert p.op == "rescore" and p.impl == s.impl and p.blocks == s.blocks
    assert p.shape == s.shape == (64, 64, 32, 10)     # C bucketed to 64
    assert p.hbm_bytes == s.hbm_bytes + 64 * 64 * 8.0
    assert p.hbm_bytes > (64 * 32 + 64 * 40 * 32) * 4.0


@pytest.mark.parametrize("hit_rate", [None, 0.0, 0.1, 0.25, 0.5, 1.0, 2.0])
def test_choose_rescore_mult_with_hit_rate_matches_jax(hit_rate):
    for topk, d, cand in ((10, 128, 16 * 3056), (10, 16, 40), (5, 64, 300),
                          (100, 32, 1000)):
        assert H.choose_rescore_mult(topk, d, cand, hit_rate=hit_rate) == \
            jheur.choose_rescore_mult(topk, d, cand, hit_rate=hit_rate)


def test_auto_rescore_mult_sees_the_cache_hit_rate():
    x, idx = _build("device", rescore_mult="auto",
                    rescore_bytes=100 * (4 * 16 + 8))
    width = idx._gather_width(10, 4)
    hit = min(1.0, idx.store.cache.capacity / len(idx))
    mult = H.choose_rescore_mult(10, 16, 4 * width, hit_rate=hit)
    assert idx._rescore_r(10, 4, width) == min(max(10, mult * 10), 4 * width)


def test_nprobe_c_is_refused():
    """The flat router refuses ``nprobe_c`` the reference's way: it takes
    it and ignores it (the two-level router's coarse width; raised before
    that router was ported)."""
    x, idx = _build("device")
    q = x[:NQ]
    for a, b in zip(idx.search(q, topk=10, nprobe=4, nprobe_c=2),
                    idx.search(q, topk=10, nprobe=4)):
        assert torch.equal(a, b)
    assert idx.plan_search(8, 10, 4, 2) == idx.plan_search(8, 10, 4)
    assert idx.search_geometry(10, 4, 2) == idx.search_geometry(10, 4)


# --- the port against the reference, on bridged indexes ----------------------

def _jax_cache_state(jc: JCache) -> dict:
    return {"keys": np.asarray(jc.keys), "rows": np.asarray(jc.rows),
            "ref": np.asarray(jc.ref), "hand": np.asarray(jc.hand),
            "sets": jc.sets, "ways": jc.ways, "max_bytes": jc.max_bytes,
            "inserted": jc.inserted}


def _bridge(jidx, carry_cache=True):
    st = lambda s: tuple(np.asarray(a) for a in s)
    return index_from_numpy(
        np.asarray(jidx.centroids), jidx.store.state_arrays(),
        jidx.store.meta(), n_total=jidx.n_total, stats=st(jidx.stats),
        pending=st(jidx._pending), device="cpu",
        cache=_jax_cache_state(jidx.store.cache) if carry_cache else None)


@pytest.mark.parametrize("budget", [None, 300 * (4 * 16 + 8)],
                         ids=["unbounded", "budgeted"])
def test_search_matches_jax_on_a_bridged_index(budget):
    x = _blobs(23, N, K, 16)
    jidx = JIVF.build(jnp.asarray(x), k=K, max_iters=4, codec="q8",
                      rescore="device", rescore_bytes=budget)
    assert jidx.store.cache is not None
    assert (jidx.store.cache.evicted > 0) == (budget is not None)
    tidx = _bridge(jidx)
    _assert_cache_equal(tidx.store.cache, jidx.store.cache)
    q = x[3::N // NQ][:NQ]
    _assert_tie_free(q, x)
    for nprobe in (4, K):
        ids, dists = tidx.search(q, topk=10, nprobe=nprobe)
        jids, jdists = jidx.search(jnp.asarray(q), topk=10, nprobe=nprobe)
        assert np.array_equal(ids.numpy(), np.asarray(jids)), nprobe
        np.testing.assert_allclose(dists.numpy(), np.asarray(jdists),
                                   rtol=1e-5, atol=_atol(q, x))
    # an add into both moves both caches the same way
    x2 = _blobs(24, 200, K, 16)
    jidx.add(jnp.asarray(x2))
    tidx.add(x2)
    _assert_cache_equal(tidx.store.cache, jidx.store.cache)
    # and the state crosses back
    back = index_to_numpy(tidx)["cache"]
    assert set(back) == set(CACHE_KEYS)
    for key, v in _jax_cache_state(jidx.store.cache).items():
        assert np.array_equal(np.asarray(back[key]), np.asarray(v)), key


def test_bridge_without_cache_state_rewarms_from_the_reservoir():
    """Without the carried state the manifest's ``rescore_cache`` rebuilds
    the cache and the reservoir re-warms it, cell-major, as the
    reference's restore does."""
    x = _blobs(25, 600, K, 16)
    jidx = JIVF.build(jnp.asarray(x), k=K, max_iters=3, codec="q8",
                      rescore="device")
    tidx = _bridge(jidx, carry_cache=False)
    jc = JCache(16, max_bytes=jidx.store.cache.max_bytes)
    jidx.store.cache = jc
    jidx.store._rewarm_cache()
    _assert_cache_equal(tidx.store.cache, jc)
