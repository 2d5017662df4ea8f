"""The port's FlashProbe wrappers and oracle against the JAX package, on
the CPU.

The same numpy inputs (from a seed) go through ``repro`` (Pallas in
interpret mode, as its own tests run it) and ``repro_torch`` (whose
wrappers run the kernels' plain versions for CPU tensors). The data is
continuous and random, so there are no ties except the ones a test builds
on purpose. Tolerance: ids equal; scores and distances within
``rtol=1e-5`` plus ``atol = 1e-5 * (max ||q||^2 + max ||c||^2)``, the
scale of the expanded form's cancellation (``||q||^2 + ||c||^2 - 2 q.c``
loses digits in proportion to the norms). bf16 inputs: ids equal except
near-ties within that ``atol``; +inf entries of the q8 scan sit in the
same places.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import heuristics as jheur
from repro.core import quant8 as jq8
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import heuristics as H
from repro_torch.core import plan as P
from repro_torch.core import quant8 as q8
from repro_torch.kernels import flash_probe as fp
from repro_torch.kernels import ops, ref

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _atol(q, c):
    q, c = np.asarray(q, np.float64), np.asarray(c, np.float64)
    return 1e-5 * (float((q * q).sum(-1).max()) + float((c * c).sum(-1).max()))


def _assert_topl(ids, vals, jids, jvals, atol, exact_ids=True):
    ids, vals = np.asarray(ids), _np(vals)
    jids, jvals = np.asarray(jids), _np(jvals)
    assert ids.shape == jids.shape and ids.dtype == np.int32
    np.testing.assert_allclose(vals, jvals, rtol=1e-5, atol=atol)
    diff = ids != jids
    if exact_ids:
        assert not diff.any(), f"{int(diff.sum())} ids differ"
    else:   # a differing id must sit on a near-tie
        assert np.all(np.abs(vals - jvals)[diff] <= atol)


# --- the oracle ----------------------------------------------------------

@pytest.mark.parametrize("n,k,d,l", [(32, 16, 16, 4), (32, 16, 19, 16),
                                     (7, 4, 19, 1)])
@pytest.mark.parametrize("want_dists", [True, False])
def test_probe_ref_matches_jax(n, k, d, l, want_dists):
    rng = np.random.default_rng(n + k + d)
    q = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    idx, v = ref.probe_ref(torch.from_numpy(q), torch.from_numpy(c), l,
                           want_dists=want_dists)
    jidx, jv = jref.probe_ref(jnp.asarray(q), jnp.asarray(c), l,
                              want_dists=want_dists)
    _assert_topl(idx, v, jidx, jv, _atol(q, c))


def test_probe_ref_ties_go_to_the_lower_index():
    c = np.repeat(np.eye(4, 8, dtype=np.float32), 3, axis=0)   # 12 rows
    q = np.eye(4, 8, dtype=np.float32)[[2, 0]]
    idx, _ = ref.probe_ref(torch.from_numpy(q), torch.from_numpy(c), 5)
    jidx, _ = jref.probe_ref(jnp.asarray(q), jnp.asarray(c), 5)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert idx[0, :3].tolist() == [6, 7, 8]


# --- kernel 4: flash_probe -------------------------------------------------

PROBE_SHAPES = [(32, 16, 16, 4), (33, 17, 19, 7), (32, 16, 16, 16),
                (1, 4, 19, 1), (5, 40, 1, 40)]


@pytest.mark.parametrize("n,k,d,l", PROBE_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pass_csq", [False, True])
def test_flash_probe_matches_jax(n, k, d, l, dt, pass_csq):
    rng = np.random.default_rng(3 * n + k + d)
    q = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    tdt, jdt = DTYPES[dt]
    tq, tc = torch.from_numpy(q).to(tdt), torch.from_numpy(c).to(tdt)
    jq, jc = jnp.asarray(q, jdt), jnp.asarray(c, jdt)
    c32 = np.asarray(jc, np.float32)
    csq = (c32 * c32).sum(-1)
    for want in (True, False):
        got = ops.flash_probe(tq, tc, l=l, want_dists=want,
                              c_sq=torch.from_numpy(csq) if pass_csq
                              else None)
        exp = jops.flash_probe(jq, jc, l=l, want_dists=want,
                               c_sq=jnp.asarray(csq) if pass_csq else None)
        _assert_topl(*got, *exp, _atol(q, c), exact_ids=dt == "f32")


def test_flash_probe_duplicates_keep_the_lower_index():
    rng = np.random.default_rng(5)
    base = rng.standard_normal((6, 16)).astype(np.float32)
    c = np.concatenate([base, base[::-1], base])      # every row 3 times
    q = rng.standard_normal((9, 16)).astype(np.float32)
    got = ops.flash_probe(torch.from_numpy(q), torch.from_numpy(c), l=18,
                          want_dists=False)
    exp = jops.flash_probe(jnp.asarray(q), jnp.asarray(c), l=18,
                           want_dists=False)
    assert np.array_equal(got[0].numpy(), np.asarray(exp[0]))
    ids = got[0].numpy()
    for row, vals in zip(ids, got[1].numpy()):   # equal scores: ascending ids
        for j in range(len(row) - 1):
            if vals[j] == vals[j + 1]:
                assert row[j] < row[j + 1]


# --- kernel 5: flash_probe_grouped -----------------------------------------

@pytest.mark.parametrize("b,cn,d,l", [(32, 64, 16, 10), (9, 37, 19, 37),
                                      (1, 5, 1, 1), (4, 130, 19, 7)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_probe_grouped_matches_jax(b, cn, d, l, dt):
    rng = np.random.default_rng(b + cn + d)
    q = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((b, cn, d)).astype(np.float32)
    c[:, cn // 2: cn // 2 + 2] = 1e15      # store padding rows: finite, last
    tdt, jdt = DTYPES[dt]
    got = ops.flash_probe_grouped(torch.from_numpy(q).to(tdt),
                                  torch.from_numpy(c).to(tdt), l=l)
    exp = jops.flash_probe_grouped(jnp.asarray(q, jdt), jnp.asarray(c, jdt),
                                   l=l)
    live = np.concatenate([c[:, :cn // 2], c[:, cn // 2 + 2:]], axis=1)
    if l <= live.shape[1]:
        assert np.isfinite(got[1].numpy()).all()
        _assert_topl(*got, *exp, _atol(q, live[0]), exact_ids=dt == "f32")
    else:    # padding rows are selected last, at finite huge scores
        assert np.isfinite(got[1].numpy()).all()
        assert np.array_equal(got[0][:, :live.shape[1]].numpy(),
                              np.asarray(exp[0])[:, :live.shape[1]])


# --- kernel 6: flash_probe_grouped_q8 --------------------------------------

def _q8_inputs(b, p, w, d, seed, dead_frac=0.3):
    rng = np.random.default_rng(seed)
    qp = rng.standard_normal((b, p, d)).astype(np.float32)
    codes = rng.integers(-127, 128, (b, p, w, d)).astype(np.int8)
    scales = (rng.random((b, p, w)) * 0.02 + 1e-3).astype(np.float32)
    scales[rng.random((b, p, w)) < dead_frac] = 0.0
    return qp, codes, scales


@pytest.mark.parametrize("b,p,w,d,l", [(32, 4, 16, 16, 10), (5, 3, 13, 19, 7),
                                       (1, 2, 5, 16, 10), (4, 5, 9, 1, 40)])
def test_flash_probe_grouped_q8_matches_jax(b, p, w, d, l):
    qp, codes, scales = _q8_inputs(b, p, w, d, seed=b * p + w + d)
    scales[0, :, :] = 0.0
    scales[0, 0, :2] = 1e-2        # a row with fewer live slots than l
    got = ops.flash_probe_grouped_q8(torch.from_numpy(qp),
                                     torch.from_numpy(codes),
                                     torch.from_numpy(scales), l=l)
    exp = jops.flash_probe_grouped_q8(jnp.asarray(qp), jnp.asarray(codes),
                                      jnp.asarray(scales), l=l)
    v, jv = got[1].numpy(), np.asarray(exp[1])
    fin = np.isfinite(jv)
    assert np.array_equal(np.isfinite(v), fin)       # +inf in the same places
    assert (~fin[0]).sum() == l - 2
    r = codes.astype(np.float32) * scales[..., None]
    atol = _atol(qp.reshape(-1, d), r.reshape(-1, d))
    np.testing.assert_allclose(v[fin], jv[fin], rtol=1e-5, atol=atol)
    assert np.array_equal(got[0].numpy()[fin], np.asarray(exp[0])[fin])
    assert got[0].min() >= 0 and got[0].max() < p * w


# --- contracts -------------------------------------------------------------

def test_l_out_of_range_raises():
    q, c = torch.zeros(3, 4), torch.zeros(5, 4)
    for l in (0, 6):
        with pytest.raises(ValueError):
            ops.flash_probe(q, c, l=l)
        with pytest.raises(ValueError):
            ops.flash_probe_grouped(q, c.expand(3, 5, 4), l=l)
    codes = torch.zeros(3, 2, 2, 4, dtype=torch.int8)
    for l in (0, 5):
        with pytest.raises(ValueError):
            ops.flash_probe_grouped_q8(torch.zeros(3, 2, 4), codes,
                                       torch.ones(3, 2, 2), l=l)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(TypeError):
        fp.flash_probe_raw(torch.zeros(2, 3), torch.zeros(4, 3,
                           dtype=torch.float64), torch.zeros(4), 1)
    with pytest.raises(TypeError):
        fp.flash_probe_raw(torch.zeros(2, 3), torch.zeros(4, 3),
                           torch.zeros(5), 1)
    with pytest.raises(TypeError):
        fp.flash_probe_grouped_q8_raw(
            torch.zeros(2, 1, 3), torch.zeros(2, 1, 2, 3), torch.ones(2, 1, 2),
            1)
    with pytest.raises(ValueError):
        fp.flash_probe_grouped_raw(torch.zeros(2, 3), torch.zeros(3, 4, 3), 1)


@pytest.mark.parametrize("c,l,splits", [(1, 1, 1), (10, 3, 4), (9, 9, 4),
                                        (18400, 10, 3), (77000, 77000, 33),
                                        (5, 2, 100)])
def test_launch_geometry_covers_every_row(c, l, splits):
    s, chunk, lp = fp._launch_geometry(c, l, splits)
    assert 1 <= s <= max(1, splits) and (s - 1) * chunk < c <= s * chunk
    assert lp == min(l, chunk) and s * lp >= l


def test_list_scratch_only_beyond_shared_memory():
    ptrs, keep = fp._buffers(3, 10, 1, 10, "cpu")
    assert ptrs[2] == ptrs[0] and ptrs[4:] == (None,) * 4   # part == out
    big = fp.LIST_SMEM_MAX + 1
    ptrs, keep = fp._buffers(2, big, 4, big, "cpu")
    assert None not in ptrs
    assert keep[4].shape == (8, 2, big) and keep[6].shape == (2, 2, big)


# --- planner and int8 convention --------------------------------------------

@pytest.mark.parametrize("op,shape", [
    ("probe", (256, 1024, 128, 16)), ("probe", (256, 1024, 128, 1024)),
    ("scan", (256, 18400, 128, 10)), ("scan_q8", (256, 18400, 128, 40)),
    ("scan_q8", (16, 77000, 128, 77000)), ("scan", (1, 5, 1, 1))])
def test_probe_plans_fit_shared_memory(op, shape):
    planner = P.KernelPlanner(H.hopper_row("h100_test"))
    p = planner.plan(op, shape, 1 if op == "scan_q8" else 4)
    splits, tile = p.blocks
    # the probe's tile mode plans (1, queries a CTA) and its cluster; the
    # list modes (splits, rows a selection round)
    want = fp.PROBE_TILE_QUERIES if p.impl == "tile_topl" else fp.TILE
    assert tile == want and splits >= 1
    assert p.smem_bytes <= p.smem_limit
    assert planner.plan(op, shape, 1 if op == "scan_q8" else 4) is p
    assert planner.chooser_calls == 1


def test_wrappers_take_a_plan_for_their_own_op():
    planner = P.KernelPlanner(H.CPU)
    q, c = torch.randn(6, 8), torch.randn(40, 8)
    plan = planner.plan("probe", (6, 40, 8, 5), torch.float32)
    got = ops.flash_probe(q, c, l=5, plan=plan)
    exp = ops.flash_probe(q, c, l=5, splits=3)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
    with pytest.raises(ValueError, match="cannot drive"):
        ops.flash_probe_grouped(q, c.expand(6, 40, 8), l=5, plan=plan)


def test_choose_rescore_mult_matches_jax():
    for topk in (1, 10, 100):
        for d in (16, 128):
            for cand in (10, 100, 1000, 3000, 100000):
                assert H.choose_rescore_mult(topk, d, cand) == \
                    jheur.choose_rescore_mult(topk, d, cand)


def test_quant8_codes_equal_jax_bit_for_bit():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 19)).astype(np.float32) * 3
    x[0, :4] = [0.5, 1.5, -2.5, 0.0]          # halves round to even
    x[1] = 0.0                                # all-zero row: SCALE_EPS
    absmax = np.abs(x).max(-1)
    s = q8.symmetric_scale(torch.from_numpy(absmax))
    js = jq8.symmetric_scale(jnp.asarray(absmax))
    assert np.array_equal(s.numpy(), np.asarray(js))
    codes = q8.quantize_symmetric(torch.from_numpy(x), s.unsqueeze(-1))
    jcodes = jq8.quantize_symmetric(jnp.asarray(x), js[:, None])
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    dec = q8.dequantize_symmetric(codes, s.unsqueeze(-1))
    assert np.array_equal(dec.numpy(),
                          np.asarray(jq8.dequantize_symmetric(jcodes,
                                                              js[:, None])))
    ones = torch.ones(3)
    assert q8.quantize_symmetric(torch.tensor([0.5, 1.5, 2.5]),
                                 ones).tolist() == [0, 2, 2]


# --- the probe's tile mode and the block scan's warp mode -------------------

@pytest.mark.parametrize("l,d,itemsize,want", [
    (16, 128, 4, "tile"), (64, 128, 4, "tile"), (65, 128, 4, "list"),
    (1, 4, 4, "tile"), (16, 256, 4, "tile"), (16, 512, 4, "list"),
    (16, 512, 2, "tile"), (16, 8, 2, "tile"), (16, 4, 2, "list"),
    (7, 19, 4, "list"), (300, 129, 4, "list"), (3000, 16, 4, "list")])
def test_probe_mode_takes_short_lists_of_16_byte_rows(l, d, itemsize, want):
    """Lists of at most 64 over rows of whole 16-byte vectors of at most
    1,024 bytes take the tile mode; the rest (the smoke's ragged (5, 300,
    129, 300) and (64, 3000, 16, 3000) among them) the list mode."""
    assert fp.probe_mode(l, d, itemsize) == want
    plan = P.KernelPlanner(H.H100).plan("probe", (256, 1024, d, l), itemsize)
    assert plan.impl == ("tile_topl" if want == "tile" else "online_topl")


@pytest.mark.parametrize("l,c,d,itemsize,want", [
    (10, 40, 128, 4, "warp"), (64, 1024, 128, 4, "warp"), (1, 1, 4, 4, "warp"),
    (65, 300, 128, 4, "list"), (10, 1025, 128, 4, "list"),
    (10, 48896, 128, 4, "list"), (10, 40, 19, 4, "list"),
    (10, 40, 8, 2, "warp"), (10, 40, 4, 2, "list"), (10, 40, 512, 4, "warp"),
    (10, 40, 513, 4, "list"), (10, 40, 1024, 2, "warp")])
def test_grouped_mode_takes_short_lists_of_short_blocks(l, c, d, itemsize,
                                                        want):
    """The block scan's warp mode takes lists of at most 64 over blocks of
    at most 1,024 rows of whole 16-byte vectors, at most 2 KiB (the q8
    rescore, C = 40); the planner plans it without a split or shared
    memory."""
    assert fp.grouped_mode(l, c, d, itemsize) == want
    plan = P.KernelPlanner(H.H100).plan("scan", (256, c, d, l), itemsize)
    if want == "warp":
        assert plan.impl == "grouped_scan_warp"
        assert plan.blocks == (1, fp.GROUPED_WARP_QUERIES)
        assert plan.smem_bytes == 0
    else:
        assert plan.impl == "grouped_scan" and plan.blocks[1] == fp.TILE


def _tile_cover(n: int, k: int, want: int):
    """The tile mode's work, as the kernel cuts it: for every CTA of the
    grid its query tile and its slice's ring tiles, lanes l and l + 32 of
    each; returns per-centroid coverage by one query tile's cluster, the
    queries the grid scores and writes, and the merging CTA of each query
    of a tile."""
    s, chunk, tiles = fp.probe_tile_geometry(n, k, want)
    qt, kt = fp.PROBE_TILE_QUERIES, fp.PROBE_TILE_ROWS
    cover = np.zeros(k, np.int64)
    for rank in range(s):                  # one cluster; every tile alike
        k0 = min(k, rank * chunk)
        k1 = min(k, k0 + chunk)
        for t in range(-(-(k1 - k0) // kt)):
            r0 = k0 + t * kt
            rows = r0 + np.concatenate([np.arange(32), np.arange(32) + 32])
            np.add.at(cover, rows[rows < k1], 1)
    written = np.zeros(n, np.int64)
    for tile in range(tiles):
        b = tile * qt + np.arange(qt)
        np.add.at(written, b[b < n], 1)
    merger = np.full(qt, -1)
    if s > 1:
        for rank in range(s):
            mq = (qt - rank + s - 1) // s
            qi = rank + s * np.arange(mq)
            assert (merger[qi] == -1).all()
            merger[qi] = rank
    return s, chunk, tiles, cover, written, merger


@pytest.mark.parametrize("n", [1, 17, 255, 256, 4096])
@pytest.mark.parametrize("k", [1, 7, 33, 1000, 1025, 65536])
def test_probe_tile_geometry_covers_every_pair_once(n, k):
    """Every (query, centroid) pair is scored by exactly one CTA of the
    grid for each cluster asked for, 1-8 (cluster sizes 1, 2, 4, 8), K
    below the cluster included (those CTAs get empty slices); every query
    of a tile is merged by exactly one CTA of its cluster; the shared bytes
    of the widest rows fit the block limit."""
    for want in range(1, 9):
        s, chunk, tiles, cover, written, merger = _tile_cover(n, k, want)
        assert s in fp.PROBE_CLUSTERS and s <= want and 2 * s > want
        assert chunk * s >= k and chunk == -(-k // s)
        assert (cover == 1).all()
        assert (written == 1).all() and tiles * fp.PROBE_TILE_QUERIES >= n
        assert s == 1 or (merger >= 0).all()
        for itemsize in (2, 4):
            for l in (1, min(k, 64)):
                d = fp.PROBE_TILE_ROW_BYTES // itemsize
                assert fp.probe_tile_smem(d, itemsize, l, s) \
                    <= H.H100.smem_block_bytes


@pytest.mark.parametrize("n,k,l", [(256, 1024, 16), (256, 1024, 64),
                                   (1, 1024, 10), (4096, 1024, 16),
                                   (17, 33, 33), (255, 1, 1)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_probe_plan_returns_the_tile_geometry(n, k, l, itemsize):
    """``_probe_plan`` returns the tile mode's cluster (enough CTAs to
    fill the SMs, slices long enough for the list) in its own field, no
    list-mode split, and its shared bytes, which the wrapper's geometry
    then takes as its cluster."""
    plan = P.KernelPlanner(H.H100).plan("probe", (n, k, 128, l), itemsize)
    splits, qt = plan.blocks
    cl = plan.cluster
    assert plan.impl == "tile_topl" and qt == fp.PROBE_TILE_QUERIES
    assert splits == 1
    assert cl == H.choose_probe_cluster(P.bucket_dim(n), k, l)
    assert fp.probe_tile_geometry(n, k, cl)[0] == cl
    assert plan.smem_bytes == fp.probe_tile_smem(128, itemsize, l, cl)
    assert plan.smem_bytes <= plan.smem_limit
    if (n, k) == (256, 1024):   # 16 query tiles x 8 = 128 CTAs on 132 SMs,
        assert cl == (8 if l <= 32 else 4)   # slices of at least 4 L rows
    if n == 4096 or k < 64:
        assert cl == 1


def _emulate_tile(score: np.ndarray, l: int, splits: int):
    """The tile mode's selection and in-launch merge on a dense score
    matrix: each CTA of a cluster keeps the top-l of its slice by (score,
    index), empty entries (+inf, 2**31 - 1) after them; each entry of the
    S partial lists goes to rank = its position + the entries of the other
    lists strictly before it, if that is below l."""
    n, k = score.shape
    s, chunk, _ = fp.probe_tile_geometry(n, k, splits)
    sent = np.iinfo(np.int32).max
    out_v = np.full((n, l), np.nan, np.float32)
    out_i = np.full((n, l), -1, np.int64)
    for b in range(n):
        lists = []
        for rank in range(s):
            k0, k1 = min(k, rank * chunk), min(k, rank * chunk + chunk)
            idx = np.arange(k0, k1)
            order = np.lexsort((idx, score[b, k0:k1]))[:l]
            v = np.full(l, np.inf, np.float32)
            i = np.full(l, sent, np.int64)
            v[:len(order)], i[:len(order)] = score[b, k0:k1][order], idx[order]
            lists.append((v, i))
        for o, (v, i) in enumerate(lists):
            for j in range(l):
                r = j + sum(int(((pv < v[j]) | ((pv == v[j]) & (pi < i[j])))
                                .sum()) for p, (pv, pi) in enumerate(lists)
                            if p != o)
                if r < l:
                    assert out_i[b, r] == -1      # each rank taken once
                    out_v[b, r], out_i[b, r] = v[j], i[j]
    return out_i, out_v


@pytest.mark.parametrize("n,k,l,splits,dup", [
    (17, 33, 33, 8, False), (5, 1, 1, 8, False), (9, 7, 7, 8, True),
    (17, 100, 16, 4, True), (3, 130, 64, 2, False), (4, 65, 64, 8, True)])
def test_tile_merge_by_rank_matches_jax(n, k, l, splits, dup):
    """The tile mode's rank merge of a cluster's partial lists (empty
    slices, lists longer than their slice, duplicated centroids across
    slices) gives the reference's top-l: ids equal, ties to the lower
    index."""
    rng = np.random.default_rng(n * k + l)
    q = rng.standard_normal((n, 16)).astype(np.float32)
    c = rng.standard_normal((k, 16)).astype(np.float32)
    if dup:
        c[k // 2:2 * (k // 2)] = c[:k // 2]
    csq = (c * c).sum(-1)
    score = fp.flash_probe_plain(torch.from_numpy(q), torch.from_numpy(c),
                                 torch.from_numpy(csq), k)
    dense = np.empty((n, k), np.float32)
    np.put_along_axis(dense, score[0].numpy().astype(np.int64),
                      score[1].numpy(), axis=1)
    ids, vals = _emulate_tile(dense, l, splits)
    exp = jops.flash_probe(jnp.asarray(q), jnp.asarray(c), l=l,
                           want_dists=False, c_sq=jnp.asarray(csq))
    assert np.array_equal(ids, np.asarray(exp[0]))
    np.testing.assert_allclose(vals, np.asarray(exp[1]), rtol=1e-5,
                               atol=_atol(q, c))


@pytest.mark.parametrize("c", [1, 10, 40, 41, 300, 1024])
@pytest.mark.parametrize("d,itemsize", [(4, 4), (32, 4), (64, 4), (128, 4),
                                        (256, 4), (512, 4), (128, 2)])
def test_grouped_warp_steps_read_inside_the_block(c, d, itemsize):
    """The warp mode's steps (8 rows a group of ``_row_lanes`` lanes, the
    list mode's lane count): every row below C is offered exactly once,
    and every row read lies in [0, C) (rows past C read row C - 1)."""
    g = fp._row_lanes(d, itemsize)
    offered = np.zeros(c, np.int64)
    step = 8 * (32 // g)
    for r8 in range(0, c, step):
        rows = r8 + np.arange(32 // g)[:, None] * 8 + np.arange(8)[None, :]
        read = np.minimum(rows, c - 1)
        assert read.min() >= 0 and read.max() < c
        np.add.at(offered, rows[rows < c], 1)
    assert (offered == 1).all()


def test_wrappers_on_the_cpu_run_the_plain_version_in_either_mode():
    """On the CPU the wrappers run the plain versions at shapes of either
    mode, whatever the split or cluster, and launch nothing."""
    before = dict(fp.launches)
    for l, d in ((7, 16), (7, 19), (40, 16)):   # tile, list, list
        q, c = torch.randn(5, d), torch.randn(40, d)
        csq = (c * c).sum(-1)
        exp = fp.flash_probe_plain(q, c, csq, l)
        for kw in ({}, {"splits": 3}, {"cluster": 8}):
            got = fp.flash_probe_raw(q, c, csq, l, **kw)
            assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
    for c_n in (20, 2000):                      # warp, list
        q, blk = torch.randn(5, 16), torch.randn(5, c_n, 16)
        exp = fp.flash_probe_grouped_plain(q, blk, 7)
        for s_ in (1, 3):
            got = fp.flash_probe_grouped_raw(q, blk, 7, splits=s_)
            assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
    assert fp.launches == before


def test_probe_mode_rule_is_the_planners():
    """The planner reports the mode the wrapper takes, by the same rule:
    with the rule patched to the list mode the probe's and the block
    scan's plans are the list modes' (no cluster, the list split)."""
    planner = P.KernelPlanner(H.H100)
    assert planner.plan("probe", (256, 1024, 128, 16), 4).impl == "tile_topl"
    saved = fp.probe_mode, fp.grouped_mode
    fp.probe_mode = fp.grouped_mode = lambda *a: "list"
    try:
        fresh = P.KernelPlanner(H.H100)
        p = fresh.plan("probe", (256, 1024, 128, 16), 4)
        g = fresh.plan("scan", (256, 40, 128, 10), 4)
    finally:
        fp.probe_mode, fp.grouped_mode = saved
    assert p.impl == "online_topl" and p.cluster is None
    assert p.blocks == (H.choose_probe_splits(256, 1024, 16), fp.TILE)
    assert g.impl == "grouped_scan" and g.blocks[1] == fp.TILE


@pytest.mark.parametrize("shape,want", [((256, 1024, 128, 16), "tile"),
                                        ((256, 1024, 128, 100), "list")])
def test_ops_probe_passes_the_plans_geometry(monkeypatch, shape, want):
    """``ops.flash_probe`` hands the raw wrapper the plan's cluster and
    list-mode split, each in its own parameter; an explicit ``splits``
    overrides only the list mode's."""
    n, k, d, l = shape
    plan = P.KernelPlanner(H.H100).plan("probe", shape, 4)
    seen = []
    monkeypatch.setattr(fp, "flash_probe_raw", lambda q, c, csq, l, **kw: (
        seen.append(kw) or fp.flash_probe_plain(q, c, csq, l)))
    q, c = torch.randn(n, d), torch.randn(k, d)
    ops.flash_probe(q, c, l=l, plan=plan)
    ops.flash_probe(q, c, l=l, plan=plan, splits=3)
    cl = plan.cluster or 1
    assert seen == [{"splits": plan.blocks[0], "cluster": cl},
                    {"splits": 3, "cluster": cl}]
    assert (plan.impl == "tile_topl") == (want == "tile")
    assert want == "list" or (plan.blocks[0] == 1 and cl in fp.PROBE_CLUSTERS)


def test_aligned_copy_moves_only_data_off_16_bytes():
    """The tile and warp modes stage whole 16-byte vectors: data that
    starts off 16 bytes is copied (same values), aligned data is not."""
    buf = torch.randn(4 * 64 + 1)
    off = buf[1:].view(4, 64)
    got = fp._aligned_copy(off)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)
    assert fp._aligned_copy(got) is got
