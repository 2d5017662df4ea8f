"""The port's store scan (``ops.flash_probe_store``) against the JAX
package's posting-list scan, and the padded store's invariant, on the CPU.

The JAX side gathers the probed cells' candidate block
(``repro.index.store.gather_global``) and scans it with
``repro.kernels.ops.flash_probe_grouped`` (Pallas in interpret mode, as
its own tests run it); the port scans the same store in place (on the CPU
through the kernel's plain version). The same numpy inputs, made from a
seed, go to both.

The paged cases put the same cells in a pool of pages under a fragmented
page table (``_paged``: shuffled page ids with gaps, cells of no pages,
partial last pages, the sentinel cell K) and hold the scan through the
table to the padded scan over the same logical rows bit for bit, and to
the JAX package's table-gathered block (``gather_global`` of its paged
layout) where the width is a whole number of pages.

Tolerance: the data is continuous and random, so there are no ties but
the ones a test builds: ids are equal (bf16 inputs: equal except on
near-ties within the ``atol``); scores within ``rtol=1e-5`` plus ``atol =
1e-5 * (max ||q||^2 + max ||c||^2)`` over the live rows, the scale of the
expanded form's cancellation. Padding slots score ``||P||^2 - 2 q.P``
with ``P`` the padding coordinate, equal in both to ``rtol=1e-5``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import IVFIndex as JIVF
from repro.index import store as jstore
from repro.kernels import ops as jops
from repro_torch.core import heuristics as H
from repro_torch.core import plan as P
from repro_torch.index import IVFIndex
from repro_torch.index import store as store_mod
from repro_torch.kernels import flash_probe as fp
from repro_torch.kernels import ops

PAD = store_mod._PAD_COORD
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _store(rng, counts, cap, d):
    """A padded store holding ``counts[c]`` random rows in cell ``c``: slots
    past the count hold ``PAD`` and id -1, ids run over the live rows."""
    k = len(counts)
    buckets = np.full((k, cap, d), PAD, np.float32)
    ids = np.full((k, cap), -1, np.int32)
    nid = 0
    for c, n in enumerate(counts):
        buckets[c, :n] = rng.standard_normal((n, d))
        ids[c, :n] = np.arange(nid, nid + n)
        nid += n
    return buckets, ids


def _paged(rng, arrays, fills, counts, ps):
    """The cells of the padded per-slot ``arrays`` (K, cap, ...) as pools of
    pages of ``ps`` slots under one page table (K + 1, ceil(cap / ps)):
    cell c's first ceil(count / ps) pages hold its slots, on page ids drawn
    from a shuffled free list with gaps (a fragmented allocator); page 0
    holds ``fills`` (the padding page), and so do the slots of a last page
    past ``cap``; unmapped entries and the sentinel cell K's row (the
    last) name page 0; the free pages hold noise no scan may read."""
    k, cap = arrays[0].shape[:2]
    npg = -(-np.asarray(counts) // ps)
    n = int(npg.sum())
    total = 2 * n + 3
    pids = 1 + rng.permutation(total - 1)[:n]
    table = np.zeros((k + 1, -(-cap // ps)), np.int32)
    pools = []
    for a, fill in zip(arrays, fills):
        pool = rng.integers(-100, 100, (total, ps) + a.shape[2:]).astype(
            a.dtype)
        pool[0] = fill
        pools.append(pool)
    u = 0
    for c in range(k):
        for p in range(int(npg[c])):
            table[c, p] = pids[u]
            lo, hi = p * ps, min((p + 1) * ps, cap)
            for pool, a, fill in zip(pools, arrays, fills):
                pool[pids[u]] = fill
                pool[pids[u], :hi - lo] = a[c, lo:hi]
            u += 1
    return pools, table


def _probe(rng, b, k, nprobe):
    """Distinct cells per query."""
    return np.stack([rng.permutation(k)[:nprobe]
                     for _ in range(b)]).astype(np.int32)


def _jax_scan(q, buckets, ids, probe, width, l, jdt):
    cand_x, cand_ids = jstore.gather_global(
        "padded", (jnp.asarray(buckets, jdt), jnp.asarray(ids)),
        jnp.asarray(probe), width, 0, 1)
    li, dist = jops.flash_probe_grouped(jnp.asarray(q, jdt), cand_x, l=l)
    return (np.asarray(li), np.asarray(dist),
            np.take_along_axis(np.asarray(cand_ids), np.asarray(li), 1))


def _port_scan(q, buckets, ids, counts, probe, width, l, tdt):
    tp = torch.from_numpy(probe)
    li, dist = ops.flash_probe_store(
        torch.from_numpy(q).to(tdt), torch.from_numpy(buckets).to(tdt),
        torch.from_numpy(np.asarray(counts, np.int32)), tp, width=width, l=l,
        pad=PAD)
    # the id lookup of IVFIndex.search: (B, l) slots, no gathered id block
    lil = li.long()
    cell = torch.gather(tp.long(), 1, lil // width)
    got_ids = torch.from_numpy(ids)[cell, lil % width]
    return li.numpy(), dist.float().numpy(), got_ids.numpy()


def _atol(q, buckets, counts):
    live = np.concatenate([buckets[c, :n] for c, n in enumerate(counts)])
    q, live = np.asarray(q, np.float64), np.asarray(live, np.float64)
    return 1e-5 * (float((q * q).sum(-1).max())
                   + float((live * live).sum(-1).max()))


# (B, K, cap, width, d, nprobe, l): ragged counts with empty cells, a cell at
# count == width and one at count == cap > width (its slots past width are
# not candidates), d = 1, 19 and 129 (the kernel's scalar path), l beyond a
# probe's rows, l at and just past the cell mode's 32, l = 1, every cell
# probed by every query (units of more than 8 pairs), one probe a query.
# The card's splits are the smoke's concern: on the CPU the wrapper runs the
# plain version, which has none.
CASES = [(16, 12, 40, 32, 16, 4, 10), (9, 7, 24, 24, 19, 3, 37),
         (5, 20, 64, 64, 8, 6, 100), (4, 6, 16, 8, 19, 2, 16),
         (12, 30, 48, 48, 1, 8, 32), (6, 10, 40, 40, 129, 5, 33),
         (20, 9, 32, 32, 64, 9, 1), (3, 5, 70, 64, 8, 1, 64)]


@pytest.mark.parametrize("b,k,cap,width,d,nprobe,l", CASES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_store_scan_matches_jax(b, k, cap, width, d, nprobe, l, dt):
    rng = np.random.default_rng(b * k + d + l)
    counts = rng.integers(0, width + 1, k)
    counts[0], counts[1], counts[2] = 0, width, cap
    buckets, ids = _store(rng, counts, cap, d)
    probe = _probe(rng, b, k, nprobe)
    q = rng.standard_normal((b, d)).astype(np.float32)
    tdt, jdt = DTYPES[dt]
    jli, jdist, jids = _jax_scan(q, buckets, ids, probe, width, l, jdt)
    li, dist, got_ids = _port_scan(q, buckets, ids, counts, probe, width, l,
                                   tdt)
    assert li.dtype == np.int32 and li.shape == jli.shape == (b, l)
    np.testing.assert_allclose(dist, jdist, rtol=1e-5,
                               atol=_atol(q, buckets, counts))
    diff = li != jli
    if dt == "f32":
        assert not diff.any(), f"{int(diff.sum())} ids differ"
    else:   # a differing index must sit on a near-tie
        assert np.all(np.abs(dist - jdist)[diff]
                      <= _atol(q, buckets, counts))
    assert np.array_equal(got_ids[~diff], jids[~diff])
    # every index is a candidate slot: below width in its probe rank
    assert li.min() >= 0 and li.max() < nprobe * width


# (B, K, cap, width, d, nprobe, l): widths a whole number of pages and not
# (24 at 16 rows a page), cap past the last page's end (70), d = 1 and 19
# (the scalar path), lists past the cell mode's 32
PAGED = [(16, 12, 40, 32, 16, 4, 10), (9, 7, 24, 24, 19, 3, 37),
         (12, 30, 48, 48, 1, 8, 32), (3, 5, 70, 64, 8, 1, 64)]


@pytest.mark.parametrize("b,k,cap,width,d,nprobe,l", PAGED)
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_paged_store_scan_reads_through_the_table(b, k, cap, width, d, nprobe,
                                                  l, ps, dt):
    rng = np.random.default_rng(b * k + d + l + ps)
    counts = rng.integers(0, width + 1, k)
    counts[0], counts[1], counts[2] = 0, width, cap
    buckets, ids = _store(rng, counts, cap, d)
    (pool, pool_ids), table = _paged(rng, (buckets, ids), (PAD, -1), counts,
                                     ps)
    probe = _probe(rng, b, k, nprobe)
    q = rng.standard_normal((b, d)).astype(np.float32)
    tdt, jdt = DTYPES[dt]
    tq = torch.from_numpy(q).to(tdt)
    # with the sentinel cell K in a probe list: bit for bit the padded scan
    # over the same logical rows, ids looked up through the scan view
    ps_probe = probe.copy()
    ps_probe[0, -1] = k
    counts_s = torch.from_numpy(np.append(counts, 0).astype(np.int32))
    view = store_mod.ScanView(torch.from_numpy(pool).to(tdt),
                              torch.from_numpy(pool_ids),
                              torch.from_numpy(table), counts_s, ps)
    tp = torch.from_numpy(ps_probe)
    got = ops.flash_probe_store(tq, view.rows, counts_s, tp, table=view.table,
                                width=width, l=l, pad=PAD)
    exp = ops.flash_probe_store(tq, torch.from_numpy(buckets).to(tdt),
                                counts_s, tp, width=width, l=l, pad=PAD)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])
    li = got[0].long()
    cell = torch.gather(tp.long(), 1, li // width)
    got_ids = view.ids_at(cell, li % width).numpy()
    exp_ids = np.where(cell.numpy() < k,
                       ids[cell.clamp(max=k - 1).numpy(), li.numpy() % width],
                       -1)
    assert np.array_equal(got_ids, exp_ids)
    # without it: the reference's table-gathered block and its scan
    if width % ps or dt != "f32":
        return
    cand_x, cand_ids = jstore.gather_global(
        "paged", (jnp.asarray(pool), jnp.asarray(pool_ids),
                  jnp.asarray(table[:k])), jnp.asarray(probe), width, ps, 1)
    jli, jdist = jops.flash_probe_grouped(jnp.asarray(q), cand_x, l=l)
    li, dist = ops.flash_probe_store(tq, view.rows, counts_s[:k],
                                     torch.from_numpy(probe),
                                     table=view.table[:k], width=width, l=l,
                                     pad=PAD)
    assert np.array_equal(li.numpy(), np.asarray(jli))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-5,
                               atol=_atol(q, buckets, counts))


def test_fewer_live_rows_than_l_fill_with_pads():
    """Query 0 probes only empty or near-empty cells: its list ends in
    padding slots, ascending by index, at the padding row's score, with
    id -1 (the search's ``unfilled`` marker)."""
    rng = np.random.default_rng(7)
    k, cap, width, d, nprobe, l = 8, 16, 16, 16, 3, 12
    counts = np.array([0, 2, 1, 16, 9, 16, 5, 12])
    buckets, ids = _store(rng, counts, cap, d)
    probe = _probe(rng, 4, k, nprobe)
    probe[0] = [0, 1, 2]                 # 3 live rows among 48 slots
    q = rng.standard_normal((4, d)).astype(np.float32)
    jli, jdist, jids = _jax_scan(q, buckets, ids, probe, width, l,
                                 jnp.float32)
    li, dist, got_ids = _port_scan(q, buckets, ids, counts, probe, width, l,
                                   torch.float32)
    assert np.array_equal(li, jli)
    assert np.array_equal(got_ids, jids)
    np.testing.assert_allclose(dist, jdist, rtol=1e-5,
                               atol=_atol(q, buckets, counts))
    assert (got_ids[0, :3] >= 0).all() and (got_ids[0, 3:] == -1).all()
    pads = li[0, 3:]
    assert np.all(np.diff(pads) > 0)     # ties among pads: lower index first
    assert np.all(dist[0, 3:] == dist[0, 3]) and dist[0, 3] > 1e30


def test_duplicate_rows_across_cells_keep_the_lower_index():
    rng = np.random.default_rng(11)
    k, cap, width, d = 6, 12, 12, 16
    counts = np.array([10, 10, 10, 4, 0, 12])
    buckets, ids = _store(rng, counts, cap, d)
    buckets[1, :10] = buckets[0, :10]    # cell 1 repeats cell 0
    buckets[5, 3] = buckets[3, 1]
    probe = np.array([[1, 0, 2], [0, 1, 5], [5, 3, 4]], np.int32)
    q = rng.standard_normal((3, d)).astype(np.float32)
    jli, jdist, jids = _jax_scan(q, buckets, ids, probe, width, 12,
                                 jnp.float32)
    li, dist, got_ids = _port_scan(q, buckets, ids, counts, probe, width, 12,
                                   torch.float32)
    assert np.array_equal(li, jli) and np.array_equal(got_ids, jids)
    for row, vals in zip(li, dist):     # equal scores: ascending index
        eq = vals[1:] == vals[:-1]
        assert np.all((row[1:] > row[:-1])[eq])
    assert (dist[0, 1:] == dist[0, :-1]).any()   # the duplicates did tie


def test_store_scan_contract():
    q, buckets = torch.zeros(2, 4), torch.zeros(3, 8, 4)
    counts = torch.zeros(3, dtype=torch.int32)
    probe = torch.zeros(2, 2, dtype=torch.int32)
    for l in (0, 2 * 8 + 1):
        with pytest.raises(ValueError):
            ops.flash_probe_store(q, buckets, counts, probe, width=8, l=l,
                                  pad=PAD)
    with pytest.raises(ValueError, match="width"):
        ops.flash_probe_store(q, buckets, counts, probe, width=9, l=1,
                              pad=PAD)
    with pytest.raises(TypeError):
        fp.flash_probe_store_raw(q, buckets, counts.long(), probe, 8, 1, PAD)
    with pytest.raises(ValueError):
        fp.flash_probe_store_raw(q, buckets, counts[:2], probe, 8, 1, PAD)
    got = ops.flash_probe_store(q[:0], buckets, counts, probe[:0], width=8,
                                l=3, pad=PAD)
    assert got[0].shape == (0, 3) and got[1].shape == (0, 3)


@pytest.mark.parametrize("b,nprobe,width,l", [
    (256, 16, 2128, 10), (1, 16, 2128, 10), (1, 1, 100, 100),
    (3, 4, 5000, 3000), (32, 64, 2048, 10), (256, 16, 2128, 40)])
def test_store_plan_geometry_covers_every_slot(b, nprobe, width, l):
    """Lists of at most 32 entries take the cell mode (splits of each
    pair's width slots), longer ones the list mode (splits of each query's
    nprobe * width slots); either way the splits cover every slot once and
    the partial lists hold at least l entries per query."""
    planner = P.KernelPlanner(H.hopper_row("h100_test"))
    plan = planner.plan("scan_store", (b, nprobe, width, 128, l), 4)
    cell = l <= fp.STORE_CELL_LIST
    assert plan.op == "scan_store"
    assert plan.impl == ("store_scan_cell" if cell else "store_scan_list")
    splits, tile = plan.blocks
    assert tile == fp.TILE and plan.smem_bytes <= plan.smem_limit
    s, chunk, lp, lists = fp.store_geometry(nprobe, width, 128, 4, l, splits)
    axis = width if cell else nprobe * width
    assert s == splits and (s - 1) * chunk < axis <= s * chunk
    assert lp == min(l, chunk) and lists * lp >= l
    assert lists == (nprobe * s if cell else s)
    if cell:
        assert splits <= max(1, width // H.STORE_MIN_ROWS)  # none under 256
    if (b, nprobe, width, l) == (256, 16, 2128, 10):
        # the IVF1024 search: at least 512 units of 8 pairs, an item per
        # resident CTA (4 a SM: registers and the 48 KiB ring) on 132 SMs
        assert splits == 2
        assert plan.smem_bytes == fp.store_cell_smem(128, 4) == 128 + 3 * 32 * 512
    if (b, nprobe, width, l) == (256, 16, 2128, 40):
        assert splits == H.choose_probe_splits(256, 16 * 2128, 40)
    assert planner.plan("scan_store", (b, nprobe, width, 128, l), 4) is plan


def test_store_cell_mode_takes_short_lists_of_rows_that_fit_a_tile():
    """A tile is 16 KiB of whole rows, a multiple of a warp's step: 8 rows
    a group of lanes, 32 / lanes groups a warp; a lane takes up to 4 of a
    row's 16-byte vectors."""
    assert fp.store_cell_mode(32, 128, 4) and not fp.store_cell_mode(33, 128, 4)
    assert fp.store_tile_rows(128, 4) == 32       # 8 lanes a row: step 32
    assert fp.store_tile_rows(128, 2) == 64       # 4 lanes a row: step 64
    assert fp.store_tile_rows(19, 4) == 192       # scalar, 8 lanes: 215 -> 192
    assert fp.store_tile_rows(1, 4) == 4096       # 1 lane a row: step 256
    assert fp.store_tile_rows(3, 2) == 2560       # scalar, 1 lane: step 256
    assert fp.store_tile_rows(512, 4) == 8        # the largest row, 2 KiB, 32 lanes
    assert fp.store_cell_mode(10, 512, 4) and fp.store_cell_mode(10, 1024, 2)
    assert not fp.store_cell_mode(10, 513, 4)     # the list mode's rows
    for d, isz in ((1, 4), (3, 2), (19, 4), (64, 4), (128, 2), (512, 4)):
        step = 8 * (32 // fp._row_lanes(d, isz))
        rows = fp.store_tile_rows(d, isz)
        assert rows % step == 0 and rows * d * isz <= fp.STORE_TILE_BYTES


# --- the store invariant: slots at or past counts[cell] hold -1 and PAD -----

def _assert_invariant(buckets, ids, counts):
    buckets, ids, counts = (np.asarray(buckets, np.float32), np.asarray(ids),
                            np.asarray(counts))
    pad = np.arange(ids.shape[1])[None, :] >= counts[:, None]
    assert (ids[pad] == -1).all() and (ids[~pad] >= 0).all()
    assert (buckets[pad] == np.float32(PAD)).all()
    assert (np.abs(buckets[~pad]) < PAD / 10).all()


def test_store_invariant_after_spills_refresh_and_repair():
    """The same sequence on both packages: ``add`` that spills under
    ``max_cap``, ``refresh``, a second ``add``, and ``refresh`` with
    ``repair_dead`` (which re-seeds an empty far cell). After each step
    every slot at or past its cell's count holds id -1 and ``PAD``."""
    rng = np.random.default_rng(3)
    k, d = 8, 16
    centers = rng.standard_normal((k, d)).astype(np.float32) * 2.0
    lab = rng.integers(0, k, 900)
    x = centers[lab] + rng.standard_normal((900, d)).astype(np.float32)
    c0 = np.concatenate([centers, np.full((1, d), 500.0, np.float32)])
    jidx = JIVF(jnp.asarray(c0), 8, max_cap=96)
    tidx = IVFIndex(c0, 8, max_cap=96, device="cpu")

    def check():
        jb, ji = jidx.store.dense()
        _assert_invariant(jb, ji, jidx.counts)
        tb, ti = tidx.store.dense()
        _assert_invariant(tb.numpy(), ti.numpy(), tidx.counts.numpy())
        assert np.array_equal(ti.numpy(), np.asarray(ji))

    jidx.add(jnp.asarray(x))
    tidx.add(x)
    assert tidx.spilled == jidx.spilled > 0
    check()
    jidx.refresh()
    tidx.refresh()
    check()
    x2 = centers[rng.integers(0, k, 200)] + rng.standard_normal(
        (200, d)).astype(np.float32)
    jidx.add(jnp.asarray(x2))
    tidx.add(x2)
    jidx.refresh(repair_dead=True)
    tidx.refresh(repair_dead=True)
    assert tidx.reseeded_cells == jidx.reseeded_cells >= 1
    check()
    # the port's store scan on its store against the JAX package's gather
    # and grouped scan on its own store, after the same sequence
    q = x[:8]
    width = tidx.search_geometry(10, 4)[2]
    probe = _probe(rng, 8, k + 1, 4)
    jb, ji = jidx.store.dense()
    tb, ti = tidx.store.dense()
    jli, jdist, jids = _jax_scan(q, np.asarray(jb), np.asarray(ji), probe,
                                 width, 10, jnp.float32)
    li, dist, got_ids = _port_scan(q, tb.numpy(), ti.numpy(),
                                   tidx.counts.numpy(), probe, width, 10,
                                   torch.float32)
    assert np.array_equal(li, jli) and np.array_equal(got_ids, jids)
    np.testing.assert_allclose(dist, jdist, rtol=1e-5,
                               atol=_atol(q, tb.numpy(), tidx.counts.numpy()))
