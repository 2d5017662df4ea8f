"""The port's q8 store scan (``ops.flash_probe_store_q8``) against the JAX
package's quantized posting-list scan, on the CPU.

The JAX side gathers the probed cells' codes and scales
(``repro.index.store.gather_global_q8``) and scans the block with
``repro.kernels.ops.flash_probe_grouped_q8`` (Pallas in interpret mode, as
its own tests run it); the port scans the same quantized store in place
(on the CPU through the kernel's plain version). The same numpy inputs,
made from a seed, go to both; the shifted queries ``q' = q -
anchor[cell]`` are the same f32 subtraction on both sides.

The paged cases put the same cells in pools of pages under a fragmented
page table (``test_torch_store_scan._paged``) and hold the scan through
the table to the padded scan over the same logical rows bit for bit, the
sentinel cell K included, and to the JAX package's table-gathered block
where the width is a whole number of pages.

Tolerance: the codes and scales are random, so there are no ties but the
ones a test builds: ids are equal wherever the distance is finite (the
JAX package pads W, so its ``+inf`` entries carry other indices; the
port's take the lowest free slots, in ascending order); distances within
``rtol=1e-5`` plus ``atol = 1e-5 * (max ||q'||^2 + max ||r||^2)``, the
scale of the expanded form's cancellation; the ``+inf`` entries in the
same places.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import IVFIndex as JIVF
from repro.index import ivf as jivf
from repro.index import store as jstore
from repro.kernels import ops as jops
from repro_torch.index import IVFIndex
from repro_torch.index import ivf as tivf
from repro_torch.kernels import flash_probe as fp
from repro_torch.kernels import ops
from tests.test_torch_store_scan import _paged


def _store(rng, counts, cap, d, dead_scale=0.05):
    """A quantized store holding ``counts[c]`` live slots in cell ``c``:
    random int8 codes and positive scales, a ``dead_scale`` share of the
    live slots at scale 0 (a row the codec could not scale), code 0 and
    scale 0 on every slot past the count, ids over the live slots. Cells 5
    and 6 (where they exist) hold the same rows over the same anchor."""
    k = len(counts)
    codes = rng.integers(-127, 128, (k, cap, d)).astype(np.int8)
    scales = (rng.random((k, cap)) * 0.02 + 1e-3).astype(np.float32)
    scales[rng.random((k, cap)) < dead_scale] = 0.0
    anchors = rng.standard_normal((k, d)).astype(np.float32)
    if k > 6:
        n56 = min(counts[5], counts[6])
        codes[6, :n56] = codes[5, :n56]
        scales[6, :n56] = scales[5, :n56]
        anchors[6] = anchors[5]
    dead = np.arange(cap)[None, :] >= np.asarray(counts)[:, None]
    codes[dead] = 0
    scales[dead] = 0.0
    ids = np.full((k, cap), -1, np.int32)
    nid = 0
    for c, n in enumerate(counts):
        ids[c, :n] = np.arange(nid, nid + n)
        nid += n
    return codes, scales, anchors, ids


def _probe(rng, b, k, nprobe, counts):
    """Distinct cells per query; query 0 probes the emptiest cells."""
    probe = np.stack([rng.permutation(k)[:nprobe] for _ in range(b)])
    probe[0] = np.argsort(counts, kind="stable")[:nprobe]
    return probe.astype(np.int32)


def _jax_scan(qp, codes, scales, ids, probe, width, l):
    b, nprobe, d = qp.shape
    cb, sb, cand_ids = jstore.gather_global_q8(
        "padded", (jnp.asarray(codes), jnp.asarray(ids), jnp.asarray(scales)),
        jnp.asarray(probe), width, 0, 1)
    li, dist = jops.flash_probe_grouped_q8(
        jnp.asarray(qp), cb.reshape(b, nprobe, width, d),
        sb.reshape(b, nprobe, width), l=l)
    return np.asarray(li), np.asarray(dist)


def _port_scan(q, codes, scales, counts, probe, anchors, width, l):
    li, dist = ops.flash_probe_store_q8(
        torch.from_numpy(q), torch.from_numpy(codes),
        torch.from_numpy(scales), torch.from_numpy(np.asarray(counts,
                                                              np.int32)),
        torch.from_numpy(probe), torch.from_numpy(anchors), width=width, l=l)
    return li.numpy(), dist.numpy()


def _atol(qp, codes, scales):
    r = codes.astype(np.float64) * scales[..., None]
    return 1e-5 * (float((qp.astype(np.float64) ** 2).sum(-1).max())
                   + float((r * r).sum(-1).max()))


def _check(q, codes, scales, anchors, ids, counts, probe, width, l):
    qp = q[:, None, :] - anchors[probe]          # the f32 subtraction
    jli, jdist = _jax_scan(qp, codes, scales, ids, probe, width, l)
    li, dist = _port_scan(q, codes, scales, counts, probe, anchors, width, l)
    b, nprobe = probe.shape
    assert li.dtype == np.int32 and li.shape == jli.shape == (b, l)
    fin = np.isfinite(jdist)
    assert np.array_equal(np.isfinite(dist), fin)
    np.testing.assert_allclose(dist[fin], jdist[fin], rtol=1e-5,
                               atol=_atol(qp, codes, scales))
    assert np.array_equal(li[fin], jli[fin]), \
        f"{int((li != jli)[fin].sum())} ids differ"
    # every index is a candidate slot; the +inf entries take the lowest
    # slots of score +inf (past their cell's count or at scale 0), in order
    assert li.min() >= 0 and li.max() < nprobe * width
    cells, slots = probe[np.arange(b)[:, None], li // width], li % width
    live = slots < np.asarray(counts)[cells]
    assert np.all(scales[cells, slots][fin] > 0) and np.all(live[fin])
    for row, f in zip(li, fin):
        assert np.all(np.diff(row[~f]) > 0)
    for row, vals in zip(li, dist):               # ties: ascending index
        eq = vals[1:] == vals[:-1]
        assert np.all((row[1:] > row[:-1])[eq])
    return li, dist


# (B, K, cap, width, d, nprobe, l): ragged counts with an empty cell, one at
# count == width and one at count == cap > width (its slots past width are
# not candidates); l at most 32 (the kernel's one list entry a lane), 33-64
# (two a lane) and past 64 (the list mode); d off the 16-byte vector (the
# kernel's scalar path) and at its lane counts; l beyond query 0's live rows
CASES = [(16, 12, 40, 32, 16, 4, 10), (9, 8, 24, 24, 19, 3, 37),
         (5, 20, 64, 64, 32, 6, 64), (4, 9, 16, 8, 19, 2, 16),
         (12, 30, 48, 48, 8, 8, 33), (6, 10, 40, 40, 128, 5, 100),
         (20, 9, 32, 32, 64, 9, 1), (3, 7, 70, 64, 16, 1, 64)]


@pytest.mark.parametrize("b,k,cap,width,d,nprobe,l", CASES)
def test_q8_store_scan_matches_jax(b, k, cap, width, d, nprobe, l):
    rng = np.random.default_rng(b * k + d + l)
    counts = rng.integers(0, width + 1, k)
    counts[0], counts[1], counts[2] = 0, width, cap
    codes, scales, anchors, ids = _store(rng, counts, cap, d)
    probe = _probe(rng, b, k, nprobe, counts)
    q = (rng.standard_normal((b, d)) * 0.02).astype(np.float32)
    _check(q, codes, scales, anchors, ids, counts, probe, width, l)


# (B, K, cap, width, d, nprobe, l): the cell mode's lists of one and two
# entries a lane, the list mode (l > 64), the scalar path (d = 19), a width
# not a whole number of pages (24 at 16 rows a page)
PAGED = [(16, 12, 40, 32, 16, 4, 10), (9, 8, 24, 24, 19, 3, 37),
         (5, 20, 64, 64, 32, 6, 64), (6, 10, 40, 40, 128, 5, 100)]


@pytest.mark.parametrize("b,k,cap,width,d,nprobe,l", PAGED)
@pytest.mark.parametrize("ps", [8, 16])
def test_paged_q8_store_scan_reads_through_the_table(b, k, cap, width, d,
                                                     nprobe, l, ps):
    rng = np.random.default_rng(b * k + d + l + ps)
    counts = rng.integers(0, width + 1, k)
    counts[0], counts[1], counts[2] = 0, width, cap
    codes, scales, anchors, ids = _store(rng, counts, cap, d)
    (pc, pa, pi), table = _paged(rng, (codes, scales, ids), (0, 0.0, -1),
                                 counts, ps)
    probe = _probe(rng, b, k, nprobe, counts)
    q = (rng.standard_normal((b, d)) * 0.02).astype(np.float32)
    sprobe = probe.copy()
    sprobe[1, -1] = k                    # the sentinel cell K
    counts_s = torch.from_numpy(np.append(counts, 0).astype(np.int32))
    anchors_s = torch.from_numpy(np.concatenate([anchors,
                                                 np.zeros((1, d), np.float32)]))
    tq, tp = torch.from_numpy(q), torch.from_numpy(sprobe)
    got = ops.flash_probe_store_q8(tq, torch.from_numpy(pc),
                                   torch.from_numpy(pa), counts_s, tp,
                                   anchors_s, table=torch.from_numpy(table),
                                   width=width, l=l)
    exp = ops.flash_probe_store_q8(tq, torch.from_numpy(codes),
                                   torch.from_numpy(scales), counts_s, tp,
                                   anchors_s, width=width, l=l)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
    if width % ps:
        return
    # without the sentinel: the reference's table-gathered block
    qp = q[:, None, :] - anchors[probe]
    cb, sb, _ = jstore.gather_global_q8(
        "paged", (jnp.asarray(pc), jnp.asarray(pi), jnp.asarray(table[:k]),
                  jnp.asarray(pa)), jnp.asarray(probe), width, ps, 1)
    jli, jdist = jops.flash_probe_grouped_q8(
        jnp.asarray(qp), cb.reshape(b, nprobe, width, d),
        sb.reshape(b, nprobe, width), l=l)
    li, dist = ops.flash_probe_store_q8(
        tq, torch.from_numpy(pc), torch.from_numpy(pa), counts_s[:k],
        torch.from_numpy(probe), anchors_s[:k],
        table=torch.from_numpy(table[:k]), width=width, l=l)
    jdist = np.asarray(jdist)
    fin = np.isfinite(jdist)
    assert np.array_equal(np.isfinite(dist.numpy()), fin)
    assert np.array_equal(li.numpy()[fin], np.asarray(jli)[fin])
    np.testing.assert_allclose(dist.numpy()[fin], jdist[fin], rtol=1e-5,
                               atol=_atol(qp, codes, scales))


@pytest.mark.parametrize("l", [12, 40, 70])
def test_fewer_live_rows_than_l_end_in_the_lowest_free_slots(l):
    """Query 0 probes cells with 0, 2 and 1 live slots, one of them at
    scale 0: its list ends in +inf entries at the lowest slots that score
    +inf, ascending, whose ids the search turns into -1."""
    rng = np.random.default_rng(7)
    k, cap, width, d, nprobe = 8, 32, 32, 16, 3
    counts = np.array([0, 2, 1, 32, 9, 32, 5, 12])
    codes, scales, anchors, ids = _store(rng, counts, cap, d,
                                         dead_scale=0.0)
    scales[1, 1] = 0.0                   # a live slot the codec left at 0
    probe = _probe(rng, 4, k, nprobe, counts)
    probe[0] = [0, 1, 2]                 # 2 finite rows among 96 slots
    q = (rng.standard_normal((4, d)) * 0.02).astype(np.float32)
    li, dist = _check(q, codes, scales, anchors, ids, counts, probe, width,
                      l)
    assert np.isfinite(dist[0, :2]).all() and np.isinf(dist[0, 2:]).all()
    # the slots of score +inf in index order: cell 0's 32, then cell 1's
    # scale-0 slot 1 and its 30 dead slots, then cell 2's
    inf_slots = [w for w in range(32)] + [32 + 1] + [
        32 + w for w in range(2, 32)] + [64 + w for w in range(1, 32)]
    assert li[0, 2:].tolist() == inf_slots[:l - 2]
    # the ids of the finite entries are live rows' (the search maps the
    # +inf entries to -1)
    cells = probe[0][li[0, :2] // width]
    assert (ids[cells, li[0, :2] % width] >= 0).all()


def test_duplicate_rows_across_cells_keep_the_lower_index():
    rng = np.random.default_rng(11)
    k, cap, width, d = 8, 12, 12, 16
    counts = np.array([10, 10, 10, 4, 0, 12, 12, 3])
    codes, scales, anchors, ids = _store(rng, counts, cap, d,
                                         dead_scale=0.0)
    probe = np.array([[6, 5, 2], [5, 6, 0], [5, 3, 6]], np.int32)
    q = (rng.standard_normal((3, d)) * 0.02).astype(np.float32)
    li, dist = _check(q, codes, scales, anchors, ids, counts, probe, width,
                      12)
    assert (dist[:, 1:] == dist[:, :-1]).any()    # the duplicates did tie
    # each tie between cells 5 and 6 went to the lower probe rank
    for b in range(3):
        r5 = int(np.flatnonzero(probe[b] == 5)[0])
        r6 = int(np.flatnonzero(probe[b] == 6)[0])
        first, second = sorted((r5, r6))
        ranks = li[b] // width
        both = [w for w in range(12) if first * width + w in li[b]
                and second * width + w in li[b]]
        for w in both:
            assert np.flatnonzero(li[b] == first * width + w)[0] \
                < np.flatnonzero(li[b] == second * width + w)[0]
        assert set(ranks.tolist()) <= {0, 1, 2}


def test_q8_store_scan_contract():
    q = torch.zeros(2, 4)
    codes = torch.zeros(3, 8, 4, dtype=torch.int8)
    scales = torch.zeros(3, 8)
    counts = torch.zeros(3, dtype=torch.int32)
    probe = torch.zeros(2, 2, dtype=torch.int32)
    anchors = torch.zeros(3, 4)
    for l in (0, 2 * 8 + 1):
        with pytest.raises(ValueError):
            ops.flash_probe_store_q8(q, codes, scales, counts, probe,
                                     anchors, width=8, l=l)
    with pytest.raises(ValueError, match="width"):
        ops.flash_probe_store_q8(q, codes, scales, counts, probe, anchors,
                                 width=9, l=1)
    qp = torch.zeros(2, 2, 4)
    with pytest.raises(TypeError):
        fp.flash_probe_store_q8_raw(qp, codes.float(), scales, counts, probe,
                                    8, 1)
    with pytest.raises(TypeError):
        fp.flash_probe_store_q8_raw(qp, codes, scales, counts.long(), probe,
                                    8, 1)
    with pytest.raises(ValueError):
        fp.flash_probe_store_q8_raw(qp, codes, scales[:2], counts, probe, 8,
                                    1)
    got = ops.flash_probe_store_q8(q[:0], codes, scales, counts, probe[:0],
                                   anchors, width=8, l=3)
    assert got[0].shape == (0, 3) and got[1].shape == (0, 3)


def _blobs(seed, n, k, d):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * 2.0
    x = centers[rng.integers(0, k, n)] + rng.standard_normal(
        (n, d)).astype(np.float32)
    return x, centers


@pytest.mark.parametrize("nprobe,topk", [(4, 10), (16, 5)])
def test_q8_propose_matches_jax(nprobe, topk):
    """Phase 1 of the q8 search on one small index in both packages (the
    same carried centroids, one ``add``): the same proposal ids, -1 where
    fewer than R live candidates exist, and the same dequantized rows
    where an id is live."""
    k, d = 16, 16
    x, centers = _blobs(3, 1500, k, d)
    rng = np.random.default_rng(103)
    c0 = centers + rng.standard_normal(centers.shape).astype(np.float32)
    jidx = JIVF(jnp.asarray(c0), 8, codec="q8", rescore="host")
    tidx = IVFIndex(c0, 8, device="cpu", codec="q8", rescore="host")
    jidx.add(jnp.asarray(x))
    tidx.add(x)
    q = x[rng.choice(len(x), 24, replace=False)] + 0.1 * rng.standard_normal(
        (24, d)).astype(np.float32)
    width = tidx._gather_width(topk, nprobe)
    assert width == jidx._gather_width(topk, nprobe)
    r = tidx._rescore_r(topk, nprobe, width)
    assert r == jidx._rescore_r(topk, nprobe, width)
    bqn, bqk, bsb, bsw, _, _ = jidx.plan_search(24, topk, nprobe)
    st = jidx.store
    jids, jdeq = jivf._q8_propose(
        jnp.asarray(q), jidx.centroids, jidx._centroid_norms(),
        st.device_arrays(), kind=st.kind, r=r, nprobe=nprobe, width=width,
        ps=st.page_param, nsh=st.n_shards, bqn=bqn, bqk=bqk, bsb=bsb,
        bsw=bsw, interpret=jidx.interpret)
    ids, deq = tivf._q8_propose(
        torch.from_numpy(q), tidx.centroids, tidx._centroid_norms(),
        tidx.store.scan_view(), r=r, nprobe=nprobe, width=width)
    jids, jdeq = np.asarray(jids), np.asarray(jdeq)
    assert ids.dtype == torch.int32 and ids.shape == jids.shape == (24, r)
    assert np.array_equal(ids.numpy(), jids)
    live = jids >= 0
    assert live.any()
    np.testing.assert_allclose(deq.numpy()[live], jdeq[live], rtol=1e-6,
                               atol=1e-6)
