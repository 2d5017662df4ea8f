"""The port's FlashIVF index (``repro_torch.index``) against the JAX
package's (``repro.index``), on the CPU.

Both packages get the same numpy inputs: a corpus of well-separated
Gaussian blobs made from a seed, and the same starting centroids (the
port's ``build`` initialises from a ``torch.Generator``, so parity is held
on indexes constructed from carried centroids and on the state bridge).
The JAX side runs its Pallas kernels in interpret mode, the port its
kernels' plain versions (the tensors lie on the CPU).

Tolerance: the data is tie-free (each test checks that the 16 nearest
exact distances of every query lie more than ``1e-6 * (max ||q||^2 + max
||x||^2)`` apart, well above fp32 rounding of the expanded form; the
seeds are chosen so), so ids are equal; distances agree within
``rtol=1e-5`` plus ``atol = 1e-5 * (max ||q||^2 + max ||x||^2)``, the
scale of the expanded form's cancellation (the two packages sum
``||x||^2 - 2 q.x`` in different orders); centroids after ``refresh``
within ``rtol=atol=1e-5`` (sums of the same rows in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.streaming import SufficientStats as JStats
from repro.index import IVFIndex as JIVF
from repro.index.ivf import csr_from_assignments as j_csr
from repro.index.ivf import recall_at_k as j_recall
from repro_torch.core.streaming import SufficientStats
from repro_torch.index import (IVFIndex, csr_from_assignments,
                               index_from_numpy, index_to_numpy,
                               recall_at_k)

K = 16
N = 2000
NQ = 32


def _blobs(seed, n, k, d, spread=2.0, noise=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, n)
    x = centers[lab] + rng.standard_normal((n, d)).astype(np.float32) * noise
    return x.astype(np.float32), centers


def _atol(q, x):
    q, x = np.asarray(q, np.float64), np.asarray(x, np.float64)
    return 1e-5 * (float((q * q).sum(-1).max()) + float((x * x).sum(-1).max()))


def _assert_tie_free(q, x, depth=16):
    """The data's precondition: the ``depth`` nearest exact (float64)
    distances of every query lie more than ``0.1 * _atol`` apart."""
    q, x = np.asarray(q, np.float64), np.asarray(x, np.float64)
    dist = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gap = np.diff(np.sort(dist, axis=1)[:, :depth], axis=1).min()
    assert gap > 0.1 * _atol(q, x), f"near-tie {gap:.3g}: pick another seed"


def _assert_search_equal(got, exp, q, x):
    _assert_tie_free(q, x)
    ids, dists = got[0].numpy(), got[1].numpy()
    jids, jdists = np.asarray(exp[0]), np.asarray(exp[1])
    assert ids.dtype == np.int32 and ids.shape == jids.shape
    assert np.array_equal(ids, jids), f"{int((ids != jids).sum())} ids differ"
    np.testing.assert_allclose(dists, jdists, rtol=1e-5, atol=_atol(q, x))


def _pair(d, codec, seed=1, extra_dead=False, max_cap=None):
    """The same index in both packages: carried centroids (blob centres
    plus noise; with ``extra_dead`` one far-away cell that stays empty),
    then one ``add`` of the corpus (rows past ``max_cap`` in a cell
    spill)."""
    x, centers = _blobs(seed, N, K, d)
    rng = np.random.default_rng(seed + 100)
    c0 = centers + rng.standard_normal(centers.shape).astype(np.float32)
    if extra_dead:
        c0 = np.concatenate([c0, np.full((1, d), 500.0, np.float32)])
    kw = {} if codec == "fp32" else {"rescore": "host"}
    jidx = JIVF(jnp.asarray(c0), 8, codec=codec, max_cap=max_cap, **kw)
    tidx = IVFIndex(c0, 8, device="cpu", codec=codec, max_cap=max_cap, **kw)
    ja = jidx.add(jnp.asarray(x))
    ta = tidx.add(x)
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    return x, jidx, tidx


@pytest.fixture(scope="module", params=[(16, "fp32"), (19, "fp32"),
                                        (16, "q8")],
                ids=["d16-fp32", "d19-fp32", "d16-q8"])
def pair(request):
    d, codec = request.param
    return _pair(d, codec)


# --- CSR inversion and recall ------------------------------------------------

@pytest.mark.parametrize("n,k", [(1000, 16), (37, 4), (1, 1)])
def test_csr_from_assignments_matches_jax(n, k):
    a = np.random.default_rng(n).integers(0, k, n).astype(np.int32)
    order, offsets = csr_from_assignments(torch.from_numpy(a), k)
    jorder, joffsets = j_csr(jnp.asarray(a), k)
    assert order.dtype == torch.int32 and offsets.dtype == torch.int32
    assert np.array_equal(order.numpy(), np.asarray(jorder))
    assert np.array_equal(offsets.numpy(), np.asarray(joffsets))


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, 20, (8, 5)).astype(np.int32)
    ref = rng.integers(0, 20, (8, 5)).astype(np.int32)
    assert recall_at_k(torch.from_numpy(ids), ref) == j_recall(ids, ref)


def test_int8_codec_matches_jax_bit_for_bit():
    from repro.index.quant import make_codec as j_codec
    from repro_torch.index import make_codec
    x, centers = _blobs(5, 256, 4, 19)
    anchors = centers[np.arange(256) % 4]
    codes, scales = make_codec("q8").encode(torch.from_numpy(x),
                                            torch.from_numpy(anchors))
    jcodes, jscales = j_codec("q8").encode(jnp.asarray(x),
                                           jnp.asarray(anchors))
    assert codes.dtype == torch.int8
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    assert np.array_equal(scales.numpy(), np.asarray(jscales))
    dec = make_codec("q8").decode(codes, scales, torch.from_numpy(anchors))
    assert np.array_equal(dec.numpy(), np.asarray(j_codec("q8").decode(
        jcodes, jscales, jnp.asarray(anchors))))
    assert make_codec("q8").score_bytes(19) == j_codec("q8").score_bytes(19)


def test_sufficient_stats_laws_match_jax():
    rng = np.random.default_rng(6)
    sums = rng.standard_normal((5, 3)).astype(np.float32)
    cnt = np.array([2.0, 0.0, 3.5, 1.0, 4.0], np.float32)
    sums[3, 1], cnt[4] = np.nan, -1.0           # two rows to sanitize
    c_prev = rng.standard_normal((5, 3)).astype(np.float32)
    t = SufficientStats(torch.from_numpy(sums), torch.from_numpy(cnt),
                        torch.tensor(7.0))
    j = JStats(jnp.asarray(sums), jnp.asarray(cnt), jnp.asarray(7.0))
    (tc, tbad), (jc, jbad) = t.sanitize(), j.sanitize()
    assert np.array_equal(tbad.numpy(), np.asarray(jbad))
    tm = tc.merge(tc.scale(0.5))
    jm = jc.merge(jc.scale(0.5))
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(tm.finalize(torch.from_numpy(c_prev)).numpy(),
                               np.asarray(jm.finalize(jnp.asarray(c_prev))),
                               rtol=1e-6)
    assert float(tm.weight) == pytest.approx(float(jm.weight))
    tf = SufficientStats.from_centroids(torch.from_numpy(c_prev),
                                        torch.from_numpy(np.abs(cnt)))
    jf = JStats.from_centroids(jnp.asarray(c_prev), jnp.asarray(np.abs(cnt)))
    np.testing.assert_allclose(tf.sums.numpy(), np.asarray(jf.sums))
    z = SufficientStats.zero(5, 3)
    assert float(z.weight) == 0.0 and z.sums.shape == (5, 3)


# --- add into carried centroids, then search ---------------------------------

def test_add_gives_equal_posting_lists(pair):
    x, jidx, tidx = pair
    ids, off = tidx.posting_lists()
    jids, joff = jidx.posting_lists()
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    assert np.array_equal(off.numpy(), np.asarray(joff))
    assert tidx.cap == jidx.cap and len(tidx) == len(jidx) == N
    assert tidx.resident_bytes() == jidx.resident_bytes()
    for nprobe in (4, K):
        assert tidx.search_geometry(10, nprobe) == \
            jidx.search_geometry(10, nprobe)
    # the pending evidence of the add is the same
    np.testing.assert_allclose(tidx._pending.counts.numpy(),
                               np.asarray(jidx._pending.counts))
    np.testing.assert_allclose(tidx._pending.sums.numpy(),
                               np.asarray(jidx._pending.sums),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nprobe", [4, K])
def test_search_matches_jax(pair, nprobe):
    x, jidx, tidx = pair
    q = x[::N // NQ][:NQ]
    got = tidx.search(q, topk=10, nprobe=nprobe)
    exp = jidx.search(jnp.asarray(q), topk=10, nprobe=nprobe)
    _assert_search_equal(got, exp, q, x)
    assert np.array_equal(got[0][:, 0].numpy(),
                          np.arange(0, N, N // NQ)[:NQ])   # self at rank 0


def test_full_probe_equals_brute(pair):
    x, _, tidx = pair
    q = x[5::N // NQ][:NQ]
    got = tidx.search(q, topk=10, nprobe=K)
    ref = tidx.search_brute(q, topk=10)
    assert np.array_equal(got[0].numpy(), ref[0].numpy())
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), rtol=1e-5,
                               atol=_atol(q, x))


def test_search_with_spills_matches_jax():
    """``max_cap`` spills: each cell keeps its first 96 rows, and the search
    (the store scan over those cells) returns the JAX package's ids."""
    x, jidx, tidx = _pair(16, "fp32", max_cap=96)
    assert tidx.spilled == jidx.spilled > 0 and tidx.cap == jidx.cap == 96
    ids, _ = tidx.posting_lists()
    stored = x[np.sort(ids.numpy())]
    q = x[3::N // NQ][:NQ]   # tie-free against the stored rows
    for nprobe in (4, K):
        _assert_search_equal(tidx.search(q, topk=10, nprobe=nprobe),
                             jidx.search(jnp.asarray(q), topk=10,
                                         nprobe=nprobe), q, stored)


def test_refresh_with_guard_and_repair_matches_jax():
    x, jidx, tidx = _pair(16, "fp32", seed=1, extra_dead=True)
    x2, _ = _blobs(2, 500, K, 16)
    jidx.add(jnp.asarray(x2))
    tidx.add(x2)
    # poison one cell's pending evidence on both sides: guard must drop it
    bad = 2
    for idx, mk, arr in ((jidx, JStats, jnp.asarray), (tidx, SufficientStats,
                                                       torch.as_tensor)):
        s = np.asarray(idx._pending.sums).copy()
        c = np.asarray(idx._pending.counts).copy()
        s[bad], c[bad] = np.nan, np.nan
        idx._pending = mk(arr(s), arr(c), idx._pending.inertia)
    jidx.refresh(0.5, guard=True, repair_dead=True)
    tidx.refresh(0.5, guard=True, repair_dead=True)
    assert tidx.repaired_cells == jidx.repaired_cells == 1
    assert tidx.reseeded_cells == jidx.reseeded_cells == 1
    np.testing.assert_allclose(tidx.centroids.numpy(),
                               np.asarray(jidx.centroids), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tidx.stats.counts.numpy(),
                               np.asarray(jidx.stats.counts), rtol=1e-6)
    q = x[:NQ]
    _assert_search_equal(tidx.search(q, topk=10, nprobe=4),
                         jidx.search(jnp.asarray(q), topk=10, nprobe=4),
                         q, np.concatenate([x, x2]))


# --- the bridge ----------------------------------------------------------------

@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_bridge_carries_a_jax_index(codec):
    x, _ = _blobs(8, N, K, 16)
    jidx = JIVF.build(jnp.asarray(x), k=K, max_iters=4, codec=codec)
    x2, _ = _blobs(9, 300, K, 16)
    jidx.add(jnp.asarray(x2))    # pending evidence to carry as well
    st = lambda s: tuple(np.asarray(a) for a in s)
    tidx = index_from_numpy(np.asarray(jidx.centroids),
                            jidx.store.state_arrays(), jidx.store.meta(),
                            n_total=jidx.n_total, stats=st(jidx.stats),
                            pending=st(jidx._pending), device="cpu")
    assert tidx.codec_kind == codec and len(tidx) == len(jidx)
    ids, off = tidx.posting_lists()
    assert np.array_equal(ids.numpy(), np.asarray(jidx.posting_lists()[0]))
    assert np.array_equal(off.numpy(), np.asarray(jidx.posting_lists()[1]))
    q = x[3::N // NQ][:NQ]
    for nprobe in (4, K):
        _assert_search_equal(tidx.search(q, topk=10, nprobe=nprobe),
                             jidx.search(jnp.asarray(q), topk=10,
                                         nprobe=nprobe), q,
                             np.concatenate([x, x2]))
    # refresh from the carried evidence moves both the same way
    jidx.refresh()
    tidx.refresh()
    np.testing.assert_allclose(tidx.centroids.numpy(),
                               np.asarray(jidx.centroids), rtol=1e-5,
                               atol=1e-5)
    back = index_to_numpy(tidx)
    assert back["n_total"] == jidx.n_total
    for key, v in back["store_arrays"].items():
        if key in ("buckets", "bucket_ids", "bucket_aux", "counts",
                   "anchors"):
            assert np.array_equal(v, np.asarray(
                jidx.store.state_arrays()[key])), key


# --- the port's own build ----------------------------------------------------

@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_build_on_cpu_searches_exactly_at_full_probe(codec):
    x, _ = _blobs(11, 1500, 8, 16)
    idx = IVFIndex.build(x, k=8, max_iters=5, seed=0, device="cpu",
                         codec=codec)
    assert idx.device.type == "cpu" and len(idx) == 1500
    ids, off = idx.posting_lists()
    assert sorted(ids.tolist()) == list(range(1500))
    assert int(off[-1]) == 1500
    q = x[:NQ]
    got = idx.search(q, topk=5, nprobe=8)
    ref = idx.search_brute(q, topk=5)
    assert np.array_equal(got[0].numpy(), ref[0].numpy())
    np.testing.assert_allclose(got[1].numpy(), ref[1].numpy(), rtol=1e-5,
                               atol=_atol(q, x))
    part, _ = idx.search(q, topk=5, nprobe=2)
    assert recall_at_k(part, ref[0]) >= 0.9
    assert idx.search(q[:0], topk=5, nprobe=2)[0].shape == (0, 5)


def test_search_validates_topk_and_empty_add():
    x, _ = _blobs(12, 200, 4, 8)
    idx = IVFIndex(x[:4], 8, device="cpu")
    assert idx.add(x[:0]).shape == (0,)
    idx.add(x)
    with pytest.raises(ValueError, match="exceeds the probed"):
        idx.search(x[:2], topk=idx.cap + 1, nprobe=1)


# --- device defaults and what is not ported ----------------------------------

def test_index_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = np.zeros((4, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        IVFIndex(c, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        IVFIndex.build(np.zeros((16, 8), np.float32), k=4)
    assert IVFIndex(c, 8, device="cpu").device.type == "cpu"


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A gloo world of one rank and a context over a 1x1 mesh with an
    explicit cells axis, destroyed at the module's end."""
    import datetime

    import torch.distributed as dist
    from repro_torch.core import parallel as par
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield par.ParallelContext(par.build_mesh((1, 1), ("data", "model"),
                                             device_type="cpu"),
                              k_axis="model")
    dist.destroy_process_group()


# a sharded two-level index and a q8 index whose cache is sharded over a mesh
# are ported (item 6b, parts 1-3); their snapshots are not (item 6b, part 5)
@pytest.mark.parametrize("kw", [{"router": "two_level"},
                                {"codec": "q8", "rescore": "device"}],
                         ids=["pctx", "rescore-device"])
def test_unported_options_raise(kw, one_rank, tmp_path):
    c = np.random.default_rng(2).standard_normal((4, 8)).astype(np.float32)
    idx = IVFIndex(c, 8, device="cpu", pctx=one_rank, **kw)
    assert idx.router.kind == kw.get("router", "flat")
    assert idx.store.codec_kind == kw.get("codec", "fp32")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        idx.save(str(tmp_path))


# the paged store's options (they raised before the paged store was ported)
@pytest.mark.parametrize("kw", [{"store": "paged"},
                                {"store": "paged", "page_size": 8},
                                {"store": "paged", "store_bytes": 1 << 20}],
                         ids=["paged", "page_size", "store_bytes"])
def test_paged_options_build_and_search(kw):
    """Each option builds the reference's paged store (its page size and
    page-pool budget) and searches to the reference's ids."""
    x, centers = _blobs(1, N, K, 16)
    c0 = centers + np.random.default_rng(101).standard_normal(
        centers.shape).astype(np.float32)
    jidx = JIVF(jnp.asarray(c0), 8, codec="fp32", **kw)
    tidx = IVFIndex(c0, 8, device="cpu", codec="fp32", **kw)
    assert tidx.store_kind == jidx.store_kind == "paged"
    assert tidx.store.page_size == jidx.store.page_size
    assert tidx.store.max_bytes == jidx.store.max_bytes
    jidx.add(jnp.asarray(x))
    tidx.add(x)
    assert tidx.store.meta() == jidx.store.meta()
    q = x[::N // NQ][:NQ]
    _assert_search_equal(tidx.search(q, topk=10, nprobe=4),
                         jidx.search(jnp.asarray(q), topk=10, nprobe=4), q, x)


@pytest.mark.parametrize("router", ["two_level"])
def test_router_option_builds_the_router(router):
    """``router="two_level"`` trains the two-level router over the
    centroids (it raised before the router was ported)."""
    from repro_torch.index import TwoLevelRouter
    c, _ = _blobs(3, 64, 1, 8)
    idx = IVFIndex(c, 8, device="cpu", router=router)
    assert isinstance(idx.router, TwoLevelRouter) and idx.router.k == 64
    assert "router=two_level" in repr(idx)


# --- the store's environment default and the q8 store without reservoir ---

@pytest.mark.parametrize("env,want", [(None, "padded"), (" Padded ", "padded"),
                                      ("paged", "paged"),
                                      ("banana", "ValueError")],
                         ids=["unset", "padded", "paged", "unknown"])
def test_default_store_kind_reads_the_environment(monkeypatch, env, want):
    """``REPRO_BUCKET_STORE`` selects the store as in the reference, the
    paged store from the environment as from the argument."""
    from repro.index.store import default_store_kind as j_default
    from repro_torch.index import default_store_kind, make_store
    if env is None:
        monkeypatch.delenv("REPRO_BUCKET_STORE", raising=False)
    else:
        monkeypatch.setenv("REPRO_BUCKET_STORE", env)
    c = np.zeros((4, 8), np.float32)
    if want == "ValueError":
        for call in (j_default, default_store_kind,
                     lambda: IVFIndex(c, 8, device="cpu")):
            with pytest.raises(ValueError, match="REPRO_BUCKET_STORE"):
                call()
        return
    assert default_store_kind() == j_default() == want
    if want == "paged":
        for st in (IVFIndex(c, 8, device="cpu").store,
                   IVFIndex(c, 8, device="cpu", codec="q8").store,
                   make_store(None, 4, 8, torch.float32),
                   make_store("paged", 4, 8, torch.float32)):
            assert st.kind == "paged"
    else:
        assert IVFIndex(c, 8, device="cpu").store_kind == "padded"


def _q8_store_pair(reservoir, rescore, seed=4, k=4, d=8, n=100):
    """One padded q8 store in each package (ref. ``tests/index/
    test_quant.py:144-157``) holding the same rows."""
    from repro.index.store import make_quantized_store as j_make
    from repro_torch.index import make_quantized_store
    rng = np.random.default_rng(seed)
    anchors = rng.normal(size=(k, d)).astype(np.float32)
    cells = np.sort(rng.integers(0, k, size=n).astype(np.int32))
    rows = rng.normal(size=(n, d)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    jst = j_make("padded", k, d, jnp.float32, anchors=anchors, capacity=8,
                 reservoir=reservoir, rescore=rescore)
    tst = make_quantized_store("padded", k, d, torch.float32,
                               anchors=anchors, capacity=8,
                               reservoir=reservoir, rescore=rescore,
                               device="cpu")
    jst.append(cells, jnp.asarray(rows), ids)
    tst.append(cells, torch.from_numpy(rows), ids)
    return rows, cells, jst, tst


@pytest.mark.parametrize("rescore", ["host", "device"])
def test_quantized_store_without_reservoir_matches_jax(rescore):
    """``make_quantized_store(..., reservoir=False)``: no reservoir, so
    ``dense()`` decodes the codes (lossy but close), as the reference's;
    the device cache is built all the same with ``rescore="device"``, as
    the reference builds it; the metadata and ``payload_bytes`` (codes,
    ids and scales) equal the reference's. Decoded rows within
    ``rtol=atol=1e-6`` (the same f32 arithmetic, ``anchor + code * s``)."""
    rows, _, jst, tst = _q8_store_pair(False, rescore)
    assert tst.reservoir is None and jst.reservoir is None
    assert (tst.cache is None) == (jst.cache is None) == (rescore == "host")
    x, ids = tst.dense()
    jx, jids = jst.dense()
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-6)
    live = ids.numpy() >= 0
    errs = np.abs(x.numpy()[live] - rows[ids.numpy()[live]]).max()
    assert 0.0 < errs < 0.2
    assert tst.meta()["reservoir"] is False
    assert tst.payload_bytes() == jst.payload_bytes() > 0
    assert tst.payload_bytes() < tst.resident_bytes()


def test_payload_bytes_is_a_quarter_of_fp32_as_in_jax():
    """With the reservoir (ref. ``test_quant.py:120-141``): ``dense()``
    overlays the original rows exactly, and the int8 payload is below 0.45
    of the fp32 store's bytes, as the reference's."""
    from repro_torch.index import make_store
    k, d, n = 8, 16, 300
    rows, cells, jst, tst = _q8_store_pair(True, "host", seed=3, k=k, d=d,
                                           n=n)
    x, ids = tst.dense()
    live = ids.numpy() >= 0
    np.testing.assert_array_equal(x.numpy()[live], rows[ids.numpy()[live]])
    fp = make_store("padded", k, d, torch.float32, capacity=8, device="cpu")
    fp.append(cells, torch.from_numpy(rows), np.arange(n, dtype=np.int32))
    assert tst.payload_bytes() == jst.payload_bytes()
    assert tst.payload_bytes() < 0.45 * fp.resident_bytes()


def test_q8_search_without_reservoir_matches_jax():
    """A q8 index over a store without reservoir, host rescore: phase 2
    scores the decoded codes in both packages, with the same ids."""
    from repro.index.store import make_quantized_store as j_make
    from repro_torch.index import make_quantized_store
    x, centers = _blobs(1, N, K, 16)
    rng = np.random.default_rng(101)
    c0 = centers + rng.standard_normal(centers.shape).astype(np.float32)
    jst = j_make("padded", K, 16, jnp.float32, anchors=c0, capacity=8,
                 reservoir=False, rescore="host")
    tst = make_quantized_store("padded", K, 16, torch.float32, anchors=c0,
                               capacity=8, reservoir=False, rescore="host",
                               device="cpu")
    jidx = JIVF(jnp.asarray(c0), 8, store=jst)
    tidx = IVFIndex(c0, 8, device="cpu", store=tst)
    jidx.add(jnp.asarray(x))
    tidx.add(x)
    q = x[:NQ] + 0.05
    got = tidx.search(q, topk=10, nprobe=4)
    exp = jidx.search(jnp.asarray(q), topk=10, nprobe=4)
    assert np.array_equal(got[0].numpy(), np.asarray(exp[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(exp[1]),
                               rtol=1e-5, atol=_atol(q, x))


def test_unported_entry_points_raise(tmp_path, one_rank):
    x, _ = _blobs(13, 64, 4, 8)
    # the out-of-core build is ported (tests/test_torch_chunked.py)
    assert len(IVFIndex.build(x, k=4, device="cpu", chunk_size=16)) == 64
    # the sharded index is ported (tests/test_torch_parallel*.py), the paged
    # one too; restoring onto a mesh waits for item 6b
    paged = IVFIndex.build(x, k=4, device="cpu", pctx=one_rank,
                           store="paged")
    assert paged.store.kind == "paged" and len(paged) == 64
    # save, load and faults are ported (tests/test_torch_snapshot.py,
    # tests/test_torch_reliability.py): a round trip, and an injector
    idx = IVFIndex(x[:4], 8, device="cpu")
    idx.add(x)
    idx.save(str(tmp_path))
    back = IVFIndex.load(str(tmp_path), device="cpu")
    got, exp = back.search(x[:8], topk=4, nprobe=2), idx.search(
        x[:8], topk=4, nprobe=2)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
    from repro_torch.reliability import FaultEvent, FaultInjector, FaultPlan
    idx.faults = FaultInjector(FaultPlan([FaultEvent("add", "drop_add", 0)]))
    assert idx.add(x).shape == (0,) and len(idx) == 64
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        IVFIndex.load(str(tmp_path), device="cpu", pctx=object())
    # rescore=None resolves to the device cache, as in the reference; the
    # host reservoir stays beside it as the durable tier
    q8 = IVFIndex(x[:4], 8, device="cpu", codec="q8")
    assert q8.store.reservoir is not None and q8.store.cache is not None
