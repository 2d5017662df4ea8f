"""The stores and the rescore cache over several K-shards, against the JAX
package's, on the CPU, without a mesh.

The JAX classes are built directly with ``n_shards``/``shards`` (no mesh is
needed for their host bookkeeping), and both packages take the same numpy
batches, made from seeds: the paged store's page tables, per-shard free
lists, LRU clock and evict and spill counters must equal the reference's
key for key after growth, spills and evictions, and its pool bit for bit;
a store placed on one shard (``place`` with a stand-in context) holds that
shard's slice of the whole store's pool and its cells' tables. The
shard-local gathers (``gather_cells`` on the paged kind, ``gather_cells_q8``
on both) and the sharded block gather (``gather_global``) equal the
reference functions bit for bit. ``DeviceRescoreCache(shards=2)`` holds the
reference's keys and rows after ``put(shard=)`` (unbounded, so it grows, and
under a byte budget, so the clock evicts), and a placed cache its shard's
region of them. Every comparison is exact: the same rows land in the same
slots.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import store as jstore
from repro.index.rescore_cache import DeviceRescoreCache as JCache
from repro_torch.index import store as tstore
from repro_torch.index.rescore_cache import DeviceRescoreCache
from tests.test_torch_paged_store import ALLOC, _batches


def _owner(rank, shards):
    """What ``place`` reads of a context: the cells axis, its size, this
    rank's shard and the owned cell count."""
    return SimpleNamespace(k_axis="model", k_rank=rank, n_k_shards=shards,
                           k_local=lambda k: k // shards)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("case", list(ALLOC))
def test_sharded_allocator_matches_jax(case, shards):
    kw, n_batches, rows, skew = ALLOC[case]
    k = 12
    jst = jstore.PagedBucketStore(k, 4, jnp.float32, n_shards=shards, **kw)
    tst = tstore.PagedBucketStore(k, 4, torch.float32, n_shards=shards,
                                  device="cpu", **kw)
    placed = [tstore.PagedBucketStore(k, 4, torch.float32, n_shards=shards,
                                      device="cpu", **kw)
              for _ in range(shards)]
    for r, st in enumerate(placed):
        st.place(_owner(r, shards))
    for cells, x, ids, aux in _batches(7 + list(ALLOC).index(case), k,
                                       n_batches, rows, skew):
        ja = jnp.asarray(aux) if kw.get("aux") else None
        ta = torch.from_numpy(aux) if kw.get("aux") else None
        jst.append(cells, jnp.asarray(x), ids, aux=ja)
        for st in (tst, *placed):
            st.append(cells, torch.from_numpy(x), ids, aux=ta)
        assert np.array_equal(tst.tables_np, jst.tables_np)
        assert np.array_equal(tst.pages_np, jst.pages_np)
        assert tst._frees == jst._free
        assert np.array_equal(tst.last_touch, jst.last_touch)
        assert np.array_equal(tst.evict_counts, jst.evict_counts)
        assert np.array_equal(tst.spill_counts, jst.spill_counts)
        assert (tst.evicted, tst.spilled, tst.pps) == (jst.evicted,
                                                       jst.spilled, jst.pps)
        assert tst.meta() == jst.meta()
        assert tst.resident_bytes() == jst.resident_bytes()
    assert np.array_equal(tst.pool.numpy(), np.asarray(jst.pool))
    assert np.array_equal(tst.pool_ids.numpy(), np.asarray(jst.pool_ids))
    if kw.get("aux"):
        assert np.array_equal(tst.pool_aux.numpy(), np.asarray(jst.pool_aux))
    tsa, jsa = tst.state_arrays(), jst.state_arrays()
    for key in jsa:
        assert np.array_equal(np.asarray(tsa[key]), np.asarray(jsa[key])), key
    dx, di = tst.dense()
    jx, ji = jst.dense()
    assert np.array_equal(dx.numpy(), jx) and np.array_equal(di.numpy(), ji)
    # each placed shard: the same bookkeeping, its slice of the pool and its
    # cells' tables; the scan reads local pages with its own sentinel row
    kl, pps = k // shards, tst.pps
    for r, st in enumerate(placed):
        assert st._frees == tst._frees and st.pps == pps
        assert np.array_equal(st.tables_np, tst.tables_np)
        own = slice(r * pps, (r + 1) * pps)
        assert torch.equal(st.pool, tst.pool[own])
        assert torch.equal(st.pool_ids, tst.pool_ids[own])
        assert np.array_equal(st.tables.numpy(),
                              tst.tables_np[r * kl:(r + 1) * kl])
        view = st.scan_view()
        assert view.table.shape == (kl + 1, st.maxp)
        assert int(view.table[-1].abs().sum()) == 0
        assert view.counts.tolist() == \
            tst.counts[r * kl:(r + 1) * kl].tolist() + [0]
        assert st.shard_specs("model")[0] == ("model", None, None)
        assert st.resident_bytes() == pps * st._page_bytes() + \
            kl * st.maxp * 4


def test_a_store_refuses_a_mesh_of_another_size():
    st = tstore.PagedBucketStore(8, 4, torch.float32, n_shards=2,
                                 device="cpu")
    with pytest.raises(ValueError, match="2 shards on a 4-way"):
        st.place(_owner(0, 4))
    with pytest.raises(ValueError, match="not divisible"):
        tstore.PagedBucketStore(6, 4, torch.float32, n_shards=4,
                                device="cpu")


def _paged_pair(shards, aux, seed):
    """The same batches into a JAX and a port paged store of ``shards``."""
    kw = dict(capacity=16, page_size=8, aux=aux)
    k = 8
    jst = jstore.PagedBucketStore(k, 4, jnp.int8 if aux else jnp.float32,
                                  n_shards=shards, **kw)
    tst = tstore.PagedBucketStore(k, 4, torch.int8 if aux else torch.float32,
                                  n_shards=shards, device="cpu", **kw)
    rng = np.random.default_rng(seed)
    for cells, x, ids, scl in _batches(seed, k, 4, 40, 1.0):
        if aux:
            x = rng.integers(-127, 128, x.shape).astype(np.int8)
        jst.append(cells, jnp.asarray(x), ids,
                   aux=jnp.asarray(scl) if aux else None)
        tst.append(cells, torch.from_numpy(x), ids,
                   aux=torch.from_numpy(scl) if aux else None)
    return jst, tst


@pytest.mark.parametrize("shards", [1, 2])
def test_gather_global_over_shards_matches_jax(shards):
    jst, tst = _paged_pair(shards, False, 3)
    probe = np.random.default_rng(4).integers(0, 8, (5, 3)).astype(np.int32)
    w = tst.gather_width(1)
    jx, ji = jstore.gather_global("paged", jst.device_arrays(),
                                  jnp.asarray(probe), w, 8, shards)
    tx, ti = tstore.gather_global("paged", tst.device_arrays(),
                                  torch.from_numpy(probe), w, 8, shards)
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("kind", ["padded", "paged"])
@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_gather_cells_matches_jax(kind, codec):
    """The shard-local gathers over one shard's arrays: local cells, the
    owned count being the padding cell."""
    rng = np.random.default_rng(11)
    kl = 4
    cell = rng.integers(0, kl + 1, (5, 3)).astype(np.int32)
    if kind == "paged":
        jst, tst = _paged_pair(2, codec == "q8", 5)
        tst.place(_owner(1, 2))
        # the JAX shard-local arrays: shard 1's pool slice and cells' tables
        pps = jst.pps
        arrs = [np.asarray(a) for a in jst.device_arrays()]
        jarr = [arrs[0][pps:], arrs[1][pps:], arrs[2][kl:]] + (
            [arrs[3][pps:]] if codec == "q8" else [])
        tarr = tst.device_arrays()
        width, ps = tst.gather_width(1), 8
    else:
        cap, d = 16, 3
        jarr = [rng.standard_normal((kl, cap, d)).astype(np.float32),
                rng.integers(0, 100, (kl, cap)).astype(np.int32)]
        if codec == "q8":
            jarr[0] = rng.integers(-127, 128, (kl, cap, d)).astype(np.int8)
            jarr.append(rng.uniform(0.5, 2, (kl, cap)).astype(np.float32))
            jarr[2][:, 11:] = 0.0
        jarr[1][:, 11:] = -1
        tarr = [torch.from_numpy(a) for a in jarr]
        width, ps = 8, 0
    fn = "gather_cells" if codec == "fp32" else "gather_cells_q8"
    jout = getattr(jstore, fn)(kind, tuple(jnp.asarray(a) for a in jarr),
                               jnp.asarray(cell), width, ps)
    tout = getattr(tstore, fn)(kind, tuple(tarr), torch.from_numpy(cell),
                               width, ps)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert np.array_equal(t.numpy(), np.asarray(j))


def _cache_batches(seed, n_batches, k=16, shards=2):
    """Dense unique ids with home cells: ``(ids, rows, shard)``."""
    rng = np.random.default_rng(seed)
    nid = 0
    for _ in range(n_batches):
        m = int(rng.integers(20, 200))
        cells = rng.integers(0, k, m)
        yield (np.arange(nid, nid + m), rng.standard_normal(
            (m, 8)).astype(np.float32), cells // (k // shards))
        nid += m


@pytest.mark.parametrize("max_bytes", [None, 40 * (4 * 8 + 8)])
def test_sharded_cache_matches_jax(max_bytes):
    jc = JCache(8, max_bytes=max_bytes, shards=2, init_sets=4)
    tc = DeviceRescoreCache(8, max_bytes=max_bytes, shards=2, init_sets=4,
                            device="cpu")
    placed = [DeviceRescoreCache(8, max_bytes=max_bytes, shards=2,
                                 init_sets=4, device="cpu")
              for _ in range(2)]
    for r, c in enumerate(placed):
        c.place(_owner(r, 2))
    for ids, rows, shard in _cache_batches(1 if max_bytes else 2, 5):
        jc.put(ids, rows, shard=shard)
        for c in (tc, *placed):
            c.put(ids, rows, shard=shard)
        assert tc.sets == jc.sets and tc.capacity == jc.capacity
        assert np.array_equal(tc.keys.numpy(), np.asarray(jc.keys))
        assert np.array_equal(tc.rows.numpy(), np.asarray(jc.rows))
        assert np.array_equal(tc.ref.numpy(), np.asarray(jc.ref))
        assert np.array_equal(tc.hand.numpy(), np.asarray(jc.hand))
    assert tc.inserted == jc.inserted and tc.evicted == jc.evicted
    assert (tc.evicted > 0) == (max_bytes is not None)
    for r, c in enumerate(placed):
        own = slice(r * c.sets, (r + 1) * c.sets)
        assert c.sets == tc.sets and c.inserted == tc.inserted
        assert torch.equal(c.keys, tc.keys[own])
        assert torch.equal(c.rows, tc.rows[own])
        assert c.shard_specs("model") == (("model", None), ("model", None,
                                                            None))
    with pytest.raises(ValueError, match="2 shards"):
        DeviceRescoreCache(8, shards=2, device="cpu").place(_owner(0, 4))


def test_quantized_store_puts_each_row_in_its_home_shard():
    """``QuantizedBucketStore.append`` passes ``shard = cell // (K /
    shards)`` to the cache, as the reference's does (l.1117-1121)."""
    from repro.index.store import make_quantized_store as jmake
    rng = np.random.default_rng(9)
    k, d = 8, 4
    anchors = rng.standard_normal((k, d)).astype(np.float32)
    js = jmake("paged", k, d, jnp.float32, anchors=jnp.asarray(anchors),
               page_size=8, n_shards=2, rescore="device")
    ts = tstore.make_quantized_store("paged", k, d, torch.float32,
                                     anchors=anchors, page_size=8,
                                     n_shards=2, rescore="device",
                                     device="cpu")
    cells = np.sort(rng.integers(0, k, 50))
    x = rng.standard_normal((50, d)).astype(np.float32)
    ids = np.arange(50, dtype=np.int32)
    js.append(cells, jnp.asarray(x), ids)
    ts.append(cells, torch.from_numpy(x), ids)
    assert ts.cache.shards == js.cache.shards == 2
    assert np.array_equal(ts.cache.keys.numpy(), np.asarray(js.cache.keys))
    assert np.array_equal(ts.cache.rows.numpy(), np.asarray(js.cache.rows))
    assert np.array_equal(ts.state_arrays()["pool_pages"],
                          np.asarray(js.state_arrays()["pool_pages"]))


@pytest.mark.parametrize("to_shards", [1, 2, 4])
@pytest.mark.parametrize("from_shards", [1, 2, 4])
def test_restore_over_shards_matches_jax(from_shards, to_shards):
    """A paged store's snapshot arrays taken on ``from_shards`` K-shards,
    restored over ``to_shards`` (``restore_store(n_shards=)``): each
    shard's pages re-allocated cell-major from its page 1, its ``pps`` and
    free list, the tables and the pool equal the reference's restore key
    for key; the snapshot form round-trips; a placed shard holds its slice."""
    kw, n_batches, rows, skew = ALLOC["growth"]
    k = 12
    src = tstore.PagedBucketStore(k, 4, torch.float32, n_shards=from_shards,
                                  device="cpu", aux=True, **kw)
    for cells, x, ids, aux in _batches(5, k, n_batches, rows, skew):
        src.append(cells, torch.from_numpy(x), ids,
                   aux=torch.from_numpy(aux))
    host, meta = src.state_arrays(), src.meta()
    got = tstore.restore_store(host, meta, k=k, d=4, dtype=torch.float32,
                               n_shards=to_shards, device="cpu")
    want = jstore.PagedBucketStore.restore(
        {kk: np.asarray(v) for kk, v in host.items()}, meta, k=k, d=4,
        dtype=jnp.float32, n_shards=to_shards)
    assert got.pps == want.pps and got.maxp == want.maxp
    assert got._frees == want._free
    assert np.array_equal(got.tables_np, want.tables_np)
    assert np.array_equal(got.pool.numpy(), np.asarray(want.pool))
    assert np.array_equal(got.pool_ids.numpy(), np.asarray(want.pool_ids))
    assert np.array_equal(got.pool_aux.numpy(), np.asarray(want.pool_aux))
    back = got.state_arrays()
    for key in host:
        assert np.array_equal(np.asarray(back[key]), np.asarray(host[key]))
    if to_shards > 1:
        one = tstore.restore_store(host, meta, k=k, d=4, dtype=torch.float32,
                                   n_shards=to_shards, device="cpu")
        one.place(_owner(to_shards - 1, to_shards))
        lo = (to_shards - 1) * one.pps
        assert torch.equal(one.pool, got.pool[lo:lo + one.pps])
