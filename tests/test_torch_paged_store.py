"""The port's paged store (``repro_torch.index.store.PagedBucketStore``)
against the JAX package's, on the CPU.

Both packages get the same numpy inputs, made from a seed. The allocator
cases drive the same appends through both stores (pool growth, table
growth, ``max_cap`` spills, LRU eviction under ``max_bytes``, the budget
truly exhausted) and compare their host state key for key: the page
tables, the free list, the LRU clock, the per-cell counters,
``state_arrays()`` and ``meta()``; the rows are equal bit for bit (the
same rows land in the same slots). The search cases build a paged index
in each package over carried centroids (and, for the two-level router, a
router the reference trained and the bridge carried) and compare ids;
they also hold the port's paged index to its padded one over the same
corpus. The bridge case carries a reference paged index after an eviction.

Tolerance: the corpus is tie-free (``_assert_tie_free``), so ids are
equal; distances agree with the reference's within ``_atol`` (the two
packages sum the expanded form in different orders), and with the port's
padded index's exactly (the same plain arithmetic on the same rows).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import IVFIndex as JIVF
from repro.index.router import TwoLevelRouter as JRouter
from repro.index.router import restore_router as j_restore
from repro.index.store import PagedBucketStore as JPaged
from repro_torch.index import (IVFIndex, index_from_numpy, index_to_numpy,
                               router_from_numpy)
from repro_torch.index.store import PagedBucketStore
from tests.test_torch_index import _assert_search_equal, _blobs

K, D, N, NQ = 32, 16, 1200, 16


# --- the allocator ------------------------------------------------------------

def _batches(seed, k, n_batches, rows, skew):
    """CSR-ordered batches ``(cells ascending, rows, ids, scales)``: cells
    drawn with a power-law skew, so some cells grow pages fast."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, k + 1) ** skew
    nid = 0
    for _ in range(n_batches):
        n = int(rng.integers(1, rows + 1))
        cells = np.sort(rng.choice(k, n, p=p / p.sum())).astype(np.int64)
        x = rng.standard_normal((n, 4)).astype(np.float32)
        aux = rng.uniform(0.5, 2.0, n).astype(np.float32)
        yield cells, x, np.arange(nid, nid + n, dtype=np.int32), aux
        nid += n


def _page_bytes(ps, aux):
    return ps * (4 * 4 + 4 + (4 if aux else 0))


# (store kwargs, batches, rows a batch, skew): pool and table growth; a
# max_cap that spills; budgets that evict (once, often, with the scale
# sidecar of a q8 pool); a budget so small that a batch's own cells cannot
# all be stored (the rows past the pages it got spill)
ALLOC = {
    "growth": (dict(capacity=8, page_size=8), 6, 60, 1.2),
    "max_cap": (dict(capacity=8, page_size=8, max_cap=40), 6, 60, 1.5),
    "evict": (dict(capacity=16, page_size=8,
                   max_bytes=12 * _page_bytes(8, False)), 6, 30, 0.5),
    "evict_aux": (dict(capacity=16, page_size=16, aux=True,
                       max_bytes=10 * _page_bytes(16, True)), 5, 40, 0.8),
    "exhausted": (dict(capacity=8, page_size=8,
                       max_bytes=4 * _page_bytes(8, False)), 4, 80, 0.2),
}


@pytest.mark.parametrize("case", list(ALLOC))
def test_allocator_state_matches_jax(case):
    kw, n_batches, rows, skew = ALLOC[case]
    k = 12
    jst = JPaged(k, 4, jnp.float32, **kw)
    tst = PagedBucketStore(k, 4, torch.float32, device="cpu", **kw)
    for cells, x, ids, aux in _batches(list(ALLOC).index(case), k,
                                       n_batches, rows, skew):
        ja = jnp.asarray(aux) if kw.get("aux") else None
        ta = torch.from_numpy(aux) if kw.get("aux") else None
        jst.append(cells, jnp.asarray(x), ids, aux=ja)
        tst.append(cells, torch.from_numpy(x), ids, aux=ta)
        assert np.array_equal(tst.tables_np, jst.tables_np)
        assert np.array_equal(tst.pages_np, jst.pages_np)
        assert tst._free == jst._free[0]
        assert np.array_equal(tst.last_touch, jst.last_touch)
        assert tst._tick == jst._tick
        assert np.array_equal(tst.evict_counts, jst.evict_counts)
        assert np.array_equal(tst.spill_counts, jst.spill_counts)
        assert tst.evicted == jst.evicted and tst.spilled == jst.spilled
        assert tst.meta() == jst.meta()
        assert tst.gather_width(10) == jst.gather_width(10)
        assert tst.resident_bytes() == jst.resident_bytes()
        assert tst.occupied_pages() == jst.occupied_pages()
    tsa, jsa = tst.state_arrays(), jst.state_arrays()
    assert sorted(tsa) == sorted(jsa)
    for key in jsa:
        assert np.array_equal(np.asarray(tsa[key]), np.asarray(jsa[key])), key
    # the device pool and its mirror of the tables, as the reference's
    assert np.array_equal(tst.pool.numpy(), np.asarray(jst.pool))
    assert np.array_equal(tst.pool_ids.numpy(), np.asarray(jst.pool_ids))
    assert np.array_equal(tst.tables.numpy(), np.asarray(jst.tables))
    if case in ("evict", "evict_aux", "exhausted"):
        assert tst.evicted > 0 or tst.spilled > 0
    # a restore re-allocates the packed pages as the reference's does
    host = {key: np.asarray(v) for key, v in jsa.items()}
    back = PagedBucketStore.restore(host, jst.meta(), k=k, d=4,
                                    dtype=torch.float32, device="cpu")
    jback = JPaged.restore(host, jst.meta(), k=k, d=4, dtype=jnp.float32)
    assert np.array_equal(back.tables_np, jback.tables_np)
    assert back._free == jback._free[0] and back.meta() == \
        jback.meta()
    assert np.array_equal(back.dense_ids().numpy(),
                          np.asarray(jback.dense_ids()))


def test_first_add_takes_its_pages_at_once():
    """An add that needs no eviction hands out the lowest free ids in one
    slice, however many pages it maps: 4,096 one-page cells."""
    k = 4096
    st = PagedBucketStore(k, 4, torch.float32, page_size=8, device="cpu")
    cells = np.repeat(np.arange(k), 3)
    st.append(cells, torch.zeros((cells.size, 4)),
              np.arange(cells.size, dtype=np.int32))
    assert st.occupied_pages() == k
    assert np.array_equal(st.tables_np[:, 0], np.arange(1, k + 1))
    assert st.pps == 8192 and st._free == list(range(k + 1, 8192))


# --- search through both packages ------------------------------------------------

def _corpus():
    x, centers = _blobs(1, N, K, D)
    rng = np.random.default_rng(101)
    c0 = centers + 0.5 * rng.standard_normal(centers.shape).astype(np.float32)
    return x, c0.astype(np.float32), x[::N // NQ][:NQ]


@pytest.fixture(scope="module")
def corpus():
    x, c0, q = _corpus()
    jr = JRouter.train(jnp.asarray(c0), max_iters=4)
    return x, c0, q, {"meta": jr.meta(), "arrays": jr.state_arrays()}


_BUILT = {}


def _indexes(corpus, codec, router, ps):
    """The reference's paged index, the port's paged index and the port's
    padded index over the same centroids, router and corpus. Each store is
    filled once per ``(codec, ps)`` and shared by the two routers' indexes
    (both packages take a store instance)."""
    x, c0, _, rstate = corpus
    kw = {} if codec == "fp32" else {"rescore": "host"}
    if (codec, ps) not in _BUILT:
        jidx = JIVF(jnp.asarray(c0), 8, codec=codec, store="paged",
                    page_size=ps, **kw)
        jidx.add(jnp.asarray(x))
        made = [jidx]
        for store in ("paged", "padded"):
            idx = IVFIndex(c0, 8, device="cpu", codec=codec, store=store,
                           page_size=ps, **kw)
            idx.add(x)
            made.append(idx)
        _BUILT[codec, ps] = made
    jidx, paged, padded = _BUILT[codec, ps]
    if router == "flat":
        return jidx, paged, padded
    jr = j_restore(rstate["meta"], rstate["arrays"])
    routed = [JIVF(jnp.asarray(c0), 8, store=jidx.store, router=jr)]
    for idx in (paged, padded):
        routed.append(IVFIndex(c0, 8, device="cpu", store=idx.store,
                               router=router_from_numpy(rstate,
                                                        device="cpu")))
    return tuple(routed)


@pytest.mark.parametrize("ps", [8, 64])
@pytest.mark.parametrize("router", ["flat", "two_level"])
@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_paged_search_matches_jax_and_the_padded_index(corpus, codec, router,
                                                       ps):
    x, _, q, _ = corpus
    jidx, paged, padded = _indexes(corpus, codec, router, ps)
    assert paged.store.meta() == jidx.store.meta()
    assert paged.router.kind == jidx.router.kind == router
    for nprobe in (16, K):
        got = paged.search(q, topk=10, nprobe=nprobe)
        _assert_search_equal(got, jidx.search(jnp.asarray(q), topk=10,
                                              nprobe=nprobe), q, x)
        exp = padded.search(q, topk=10, nprobe=nprobe)
        assert torch.equal(got[0], exp[0])
        assert torch.equal(got[1], exp[1])
    assert torch.equal(paged.posting_lists()[0], padded.posting_lists()[0])


# --- the bridge ----------------------------------------------------------------

@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_bridge_carries_an_evicted_paged_index(codec):
    """A reference paged index whose budget evicted cells crosses by
    ``index_from_numpy`` and back by ``index_to_numpy``; both packages
    search to the same ids, the port's copy and the copy carried back."""
    x, c0, q = _corpus()
    ps = 8
    pb = ps * (D * (4 if codec == "fp32" else 1) + 4
               + (0 if codec == "fp32" else 4))
    kw = {} if codec == "fp32" else {"rescore": "host"}
    jidx = JIVF(jnp.asarray(c0), 8, codec=codec, store="paged",
                page_size=ps, store_bytes=120 * pb, **kw)
    # batches of a few cells each, so that a later batch evicts earlier ones
    near = ((x[:, None, :] - c0[None]) ** 2).sum(-1).argmin(1)
    x = x[np.argsort(near, kind="stable")]
    q = x[3::N // NQ][:NQ]   # tie-free against the stored rows
    for i in range(4):
        jidx.add(jnp.asarray(x[i * N // 4:(i + 1) * N // 4]))
    assert jidx.evicted > 0
    st = lambda s: tuple(np.asarray(a) for a in s)
    tidx = index_from_numpy(np.asarray(jidx.centroids),
                            jidx.store.state_arrays(), jidx.store.meta(),
                            n_total=jidx.n_total, stats=st(jidx.stats),
                            pending=st(jidx._pending), device="cpu")
    assert tidx.store_kind == "paged" and tidx.evicted == jidx.evicted
    assert tidx.cap == jidx.cap
    assert np.array_equal(tidx.evict_counts, jidx.evict_counts)
    ids, off = tidx.posting_lists()
    assert np.array_equal(ids.numpy(), np.asarray(jidx.posting_lists()[0]))
    assert np.array_equal(off.numpy(), np.asarray(jidx.posting_lists()[1]))
    kept = np.isin(np.arange(N), ids.numpy())
    for nprobe in (8, K):
        got = tidx.search(q, topk=10, nprobe=nprobe)
        exp = jidx.search(jnp.asarray(q), topk=10, nprobe=nprobe)
        _assert_search_equal(got, exp, q, x[kept])
        assert np.isin(got[0].numpy(), np.append(ids.numpy(), -1)).all()
    back = index_to_numpy(tidx)
    assert sorted(back["store_arrays"]) == sorted(jidx.store.state_arrays())
    for key, v in jidx.store.state_arrays().items():
        assert np.array_equal(back["store_arrays"][key], np.asarray(v)), key
    assert back["store_meta"] == jidx.store.meta()
    again = index_from_numpy(back["centroids"], back["store_arrays"],
                             back["store_meta"], n_total=back["n_total"],
                             stats=back["stats"], pending=back["pending"],
                             device="cpu")
    got = again.search(q, topk=10, nprobe=K)
    assert torch.equal(got[0], tidx.search(q, topk=10, nprobe=K)[0])
