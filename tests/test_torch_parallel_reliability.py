"""The sharded index's reliability on 4 gloo ranks of the CPU, held to the
JAX package's single-device index on the same numpy inputs.

One group of 4 ranks runs ``tests/_torch_parallel_worker.py`` in its
``reliability`` mode (it imports ``repro_torch`` only). Before the ranks
start, the test writes the JAX package's snapshots of ``W.SNAP_KINDS`` into
the ranks' output directory. On a 2x2 mesh (2 data x 2 cell shards) the
ranks drive:

- (i) a ``dead_shard`` fault at full probe, which must equal the brute force
  over the dense store with that K-shard's cells blanked (the reference's
  own check, ``tests/distributed/_parallel_worker.py:254-272``), then heal;
- (ii) ``nan_stats`` on an add and ``refresh(guard=True)``, against
  ``repro.index.IVFIndex`` with ``corrupt_stats`` applied and a guarded
  refresh (ref. worker l.277-297);
- (iii) ``refresh(repair_dead=True)`` where the last K-shard owns only dead
  cells;
- (iv) snapshots of four kinds in both directions: the port's 2x2 snapshot
  read by ``repro.reliability.snapshot.load_index``, the JAX package's
  restored onto 2x2, 1x4, 4x1 and no mesh, and the port's onto the same;
- (v) ``SearchEngine`` under a ``HealthPolicy``: a durability run dropped
  and ``recover(pctx=)``-ed beside an uninterrupted twin, and seeded chaos.

Tolerance: ids exact; distances and centroids within ``RTOL`` and an
``atol`` of 1e-3 (distances) or 1e-4 (centroids): the two packages, and
one device against the data-split sums of the mesh, add in other orders.
Within the port, restores and recovery are bit for bit.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_parallel_worker as W  # noqa: E402

WORLD = 4
RTOL = 1e-5
MESH_TAGS = ["2x2", "1x4", "4x1", "none"]


def _jax_kw(name, inp):
    from repro.index.router import TwoLevelRouter
    kw = dict(W.SNAP_KINDS[name])
    if "router" in kw:
        kw["router"] = TwoLevelRouter(inp["coarse"], inp["owner"],
                                      nprobe_c=2)
    return kw


def _jax_searches(idx, inp):
    return {npb: tuple(np.asarray(a) for a in idx.search(
        jnp.asarray(inp["q"]), topk=10, nprobe=npb)) for npb in (4, W.K)}


@pytest.fixture(scope="module")
def jax_snaps(tmp_path_factory, inp):
    """The JAX package's index of each snapshot kind (corpus, second add,
    refresh), saved where the ranks read it, and its searches."""
    from repro.index import IVFIndex
    out = tmp_path_factory.mktemp("reliability")
    want = {}
    for name in W.SNAP_KINDS:
        idx = IVFIndex(jnp.asarray(inp["centers"]), capacity=128,
                       **_jax_kw(name, inp))
        idx.add(jnp.asarray(inp["x"]))
        idx.add(jnp.asarray(inp["x2"]))
        idx.refresh()
        idx.save(str(out / f"jax_{name}"), seqno=3)
        want[name] = _jax_searches(idx, inp)
    return out, want


@pytest.fixture(scope="module")
def ranks(jax_snaps):
    """Start the 4 ranks in ``reliability`` mode, wait for all (a time
    limit, then kill), load each rank's results."""
    out, _ = jax_snaps
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_parallel_worker.py"),
         str(r), str(WORLD), str(out / "store"), str(out), "reliability"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def inp():
    return W.inputs()


def _jax_index(inp, x_rows=None, capacity=128):
    from repro.index import IVFIndex
    idx = IVFIndex(jnp.asarray(inp["centers"]), capacity=capacity)
    idx.add(jnp.asarray(inp["x"] if x_rows is None else x_rows))
    return idx


def _assert_search(got_ids, got_d, want):
    ids, dists = want
    assert np.array_equal(got_ids, ids)
    live = ids >= 0
    np.testing.assert_allclose(got_d[live], dists[live], rtol=RTOL,
                               atol=1e-3)


def test_every_rank_holds_the_same_results(ranks):
    """Counters, repairs, restores and searches: the same bits on every
    rank (a rank that took another branch would differ, or hang)."""
    for r in range(1, WORLD):
        diff = [k for k in ranks[0]
                if not np.array_equal(ranks[0][k], ranks[r][k])]
        assert not diff, f"rank {r} differs from rank 0 in {diff}"


def test_the_world_agrees_and_rank_0_speaks(ranks):
    """``agree`` gives every rank (every ok, some ok) and ``all_ok`` the
    first; only rank 0 is ``is_world_rank0``; a write that fails on rank 0
    (``rank0_write``) raises ``OSError`` on every rank, and a file it
    writes is in place on every rank when the call returns."""
    for r in range(WORLD):
        assert ranks[r]["world/agree"].tolist() == [[False, True],
                                                    [True, True],
                                                    [False, False]]
        assert ranks[r]["world/all_ok"].tolist() == [False, True]
        assert bool(ranks[r]["world/rank0"])
        assert bool(ranks[r]["world/failed_write_raised"])
        assert bool(ranks[r]["world/write_seen"])


def test_an_add_that_fails_on_one_rank_raises_on_every_rank(ranks):
    """An add that changed every rank's shard and failed on one rank is
    not parked (a retry would apply it twice on the others): every rank
    raises ``RanksDiverged``, with nothing requeued."""
    for r in range(WORLD):
        assert ranks[r]["engine/diverged"].tolist() == [1, 0, 0]


@pytest.mark.parametrize("name", ["padded", "paged"])
def test_dead_shard_is_the_brute_force_over_the_surviving_shards(
        ranks, inp, name):
    """(i) The dead K-shard adds no cell and no candidate: at nprobe = K
    the ids are ``ref.probe_ref``'s over the JAX index's dense store with
    that shard's cells blanked; distances are finite; the next call
    heals."""
    from repro.kernels import ref as jref
    got = ranks[0]
    idx = _jax_index(inp)
    bx, bi = (np.asarray(a).copy() for a in idx.store.dense())
    kl = W.K // 2
    bx[W.DEAD_SHARD * kl:(W.DEAD_SHARD + 1) * kl] = 1e15
    bi[W.DEAD_SHARD * kl:(W.DEAD_SHARD + 1) * kl] = -1
    pos, _ = jref.probe_ref(jnp.asarray(inp["q"]),
                            jnp.asarray(bx.reshape(-1, W.D)), 10)
    want = bi.reshape(-1)[np.asarray(pos)]
    assert np.array_equal(got[f"dead/{name}/0"], want)
    assert np.isfinite(got[f"dead/{name}/1"]).all()
    healthy = _jax_searches(idx, inp)[W.K]
    _assert_search(got[f"dead/{name}/healthy/0"],
                   got[f"dead/{name}/healthy/1"], healthy)
    for part in ("0", "1"):
        assert np.array_equal(got[f"dead/{name}/healed/{part}"],
                              got[f"dead/{name}/healthy/{part}"])


def test_dead_shard_on_q8_and_on_a_data_only_mesh(ranks, inp):
    """(i) On q8 the dead shard's proposals never reach the row exchange:
    every id found lives in a surviving cell and the distances are finite.
    On a data-only mesh the event is a search error, as on one device."""
    got = ranks[0]
    ids = got["dead/q8/0"]
    cells = np.asarray(_jax_index(inp).store.dense()[1])
    dead = set(cells[W.DEAD_SHARD * (W.K // 2):
                     (W.DEAD_SHARD + 1) * (W.K // 2)].reshape(-1).tolist())
    assert not (set(ids.reshape(-1).tolist()) - {-1}) & dead
    assert (ids >= 0).any() and np.isfinite(got["dead/q8/1"]).all()
    assert np.array_equal(got["dead/q8/healed/0"], got["dead/q8/healthy/0"])
    assert bool(got["dead/data_only_raised"])


def test_nan_stats_then_the_guarded_refresh_matches_jax(ranks, inp):
    """(ii) The same seeded rows corrupted as ``corrupt_stats`` picks over
    all K; the guarded refresh repairs them: the same ``repaired_cells``,
    centroids within tolerance, the same ids."""
    from repro.reliability import corrupt_stats
    got = ranks[0]
    assert bool(got["nan/pending_nan"])
    idx = _jax_index(inp)
    idx.add(jnp.asarray(inp["x2"]))
    idx._pending, _ = corrupt_stats(idx._pending, W.NAN_SEED)
    idx.refresh(guard=True)
    assert int(got["nan/1"]) == idx.repaired_cells > 0
    np.testing.assert_allclose(got["nan/0"], np.asarray(idx.centroids),
                               rtol=RTOL, atol=1e-4)
    want = _jax_searches(idx, inp)
    for npb in (4, W.K):
        _assert_search(got[f"nan/search{npb}/0"], got[f"nan/search{npb}/1"],
                       want[npb])


def test_repair_dead_matches_jax(ranks, inp):
    """(iii) The last K-shard owns only dead cells: the repair on the
    gathered K cells re-seeds as many cells as the JAX index, with its
    centroids."""
    got = ranks[0]
    idx = _jax_index(inp, W.dead_low_corpus(), capacity=256)
    idx.refresh(repair_dead=True)
    assert int(got["repair/1"]) == idx.reseeded_cells == W.K // 2
    np.testing.assert_allclose(got["repair/0"], np.asarray(idx.centroids),
                               rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("name", list(W.SNAP_KINDS))
def test_the_ports_mesh_snapshot_loads_in_jax(ranks, jax_snaps, inp, name):
    """(iv) The port's 2x2 snapshot is the one-device format: the JAX
    package loads it and answers with its own index's ids."""
    from repro.reliability.snapshot import load_index
    out, want = jax_snaps
    back = load_index(str(out / f"port_{name}"))
    got = _jax_searches(back, inp)
    for npb in (4, W.K):
        assert np.array_equal(got[npb][0], want[name][npb][0]), npb
        _assert_search(ranks[0][f"snap/{name}/live/search{npb}/0"],
                       ranks[0][f"snap/{name}/live/search{npb}/1"],
                       want[name][npb])


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("name", list(W.SNAP_KINDS))
def test_snapshots_restore_onto_any_mesh(ranks, jax_snaps, name, mesh):
    """(iv) The JAX package's snapshot restores onto 2x2, 1x4, 4x1 and no
    mesh with its ids; the port's own 2x2 snapshot restores onto each bit
    for bit the live 2x2 index."""
    _, want = jax_snaps
    got = ranks[0]
    for npb in (4, W.K):
        key = f"snap/{name}/jax/{mesh}/search{npb}"
        _assert_search(got[f"{key}/0"], got[f"{key}/1"], want[name][npb])
        for part in ("0", "1"):
            assert np.array_equal(
                got[f"snap/{name}/port/{mesh}/search{npb}/{part}"],
                got[f"snap/{name}/live/search{npb}/{part}"]), (npb, part)


def test_recovery_over_the_mesh_is_the_uninterrupted_run(ranks, inp):
    """(v) Dropped after its third add (a snapshot at the second, the third
    in the WAL), ``recover(pctx=)`` replays one record and then answers bit
    for bit as the uninterrupted twin, whose ids are the JAX engine's."""
    from repro.index import IVFIndex
    from repro.serve.engine import SearchConfig, SearchEngine
    got = ranks[0]
    assert int(got["engine/replayed"]) == 1
    for part in ("0", "1"):
        assert np.array_equal(got[f"engine/recovered/{part}"],
                              got[f"engine/twin/{part}"])
    eng = SearchEngine(IVFIndex(jnp.asarray(inp["centers"]), capacity=128),
                       SearchConfig(**W.ENGINE))
    for b in inp["stream"]:
        eng.add(jnp.asarray(b))
    ids, dists = eng.search(jnp.asarray(inp["q"]))
    _assert_search(got["engine/twin/0"], got["engine/twin/1"],
                   (np.asarray(ids), np.asarray(dists)))


def test_chaos_over_the_mesh_keeps_every_rank_on_one_rung(ranks):
    """(v) Under the policy and ``FaultPlan.seeded(7)`` nothing raises,
    every distance is finite and the counters, agreed unit by unit, are
    the same on every rank (``test_every_rank_holds_the_same_results``);
    the plan's search faults were taken."""
    from repro_torch.reliability import HealthCounters
    got = ranks[0]
    assert bool(got["chaos/finite"])
    names = list(HealthCounters().as_dict())
    c = dict(zip(names, got["chaos/counters"].tolist()))
    assert c["searches_ok"] + c["nprobe_degraded"] + c["brute_fallbacks"] \
        + c["lkg_fallbacks"] + c["blackholed"] == W.CHAOS_UNITS
    assert len(got["chaos/fired"]) > 0
