"""The port's reliability layer (``repro_torch.reliability`` and the
``SearchEngine``/``IVFIndex`` options it serves) against the JAX package's,
on the CPU: guarded ingestion, seeded fault plans, the WAL, crash recovery,
the degradation ladder and the launcher's flags.

Both packages get the same numpy inputs: a corpus of Gaussian blobs made
from a seed, the same starting centroids (blob centres plus noise) and one
``add`` of the corpus, then the same stream of insert batches and query
batches. The JAX side runs its Pallas kernels in interpret mode, the port
its kernels' plain versions.

Tolerance: guarded batches, fault plans, corrupted rows and the health
counters are equal exactly. Within the port, recovery is bit for bit its
own uninterrupted run (store arrays, centroids, statistics, ids,
distances). Against the JAX package ids are equal on tie-free queries (the
16 nearest exact distances of every query more than ``1e-6 * (max ||q||^2
+ max ||x||^2)`` apart, checked); distances within ``rtol=1e-5`` plus
``atol = 1e-5 * (max ||q||^2 + max ||x||^2)``, the tolerance
``tests/test_torch_index.py`` states.
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.streaming import SufficientStats as JStats
from repro.index import IVFIndex as JIVF
from repro.reliability import FaultInjector as JInjector
from repro.reliability import FaultPlan as JPlan
from repro.reliability import HealthCounters as JCounters
from repro.reliability import HealthPolicy as JPolicy
from repro.reliability import ValidationError as JValidationError
from repro.reliability import corrupt_stats as j_corrupt
from repro.reliability import guard_batch as j_guard
from repro.serve.engine import SearchConfig as JConfig
from repro.serve.engine import SearchEngine as JEngine
from repro_torch.core.streaming import SufficientStats
from repro_torch.index import IVFIndex, index_to_numpy
from repro_torch.kernels._build import KernelUnavailable
from repro_torch.reliability import (AddLog, BatchReport, FaultEvent,
                                     FaultInjector, FaultPlan, HealthCounters,
                                     HealthPolicy, InjectedFault,
                                     ValidationError, corrupt_stats,
                                     guard_batch, latest_snapshot_seqno,
                                     read_manifest)
from repro_torch.serve import SearchConfig, SearchEngine

K, D, N = 16, 16, 1500
KW = dict(topk=6, nprobe=4, query_batch=32, refresh_every=2)
POL = dict(backoff_s=0.0)


def _blobs(seed, n, k=K, d=D, spread=2.0, noise=1.0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, n)
    x = centers[lab] + rng.standard_normal((n, d)).astype(np.float32) * noise
    return x.astype(np.float32), centers


def _atol(q, x):
    q, x = np.asarray(q, np.float64), np.asarray(x, np.float64)
    return 1e-5 * (float((q * q).sum(-1).max()) + float((x * x).sum(-1).max()))


def _assert_tie_free(q, x, depth=16):
    q, x = np.asarray(q, np.float64), np.asarray(x, np.float64)
    dist = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gap = np.diff(np.sort(dist, axis=1)[:, :depth], axis=1).min()
    assert gap > 0.1 * _atol(q, x), f"near-tie {gap:.3g}: pick another seed"


@pytest.fixture(scope="module")
def data():
    x, centers = _blobs(36, N)
    c0 = centers + np.random.default_rng(136).standard_normal(
        centers.shape).astype(np.float32) * 0.5
    extra, _ = _blobs(136, 6 * 64)
    stream = [extra[i * 64:(i + 1) * 64] for i in range(6)]
    q = x[1::7][:40]
    _assert_tie_free(q, np.concatenate([x, extra]))
    return x, c0, stream, q


def _index(data, **kw):
    x, c0, _, _ = data
    idx = IVFIndex(c0, 8, device="cpu", **kw)
    idx.add(x)
    return idx


def _jindex(data, **kw):
    x, c0, _, _ = data
    idx = JIVF(jnp.asarray(c0), 8, **kw)
    idx.add(jnp.asarray(x))
    return idx


def _same_index(a: IVFIndex, b: IVFIndex):
    """Bit for bit: store arrays, centroids, both statistics, n_total."""
    sa, sb = a.store.state_arrays(), b.store.state_arrays()
    assert sorted(sa) == sorted(sb)
    for key in sa:
        assert np.array_equal(sa[key], sb[key]), key
    ta, tb = index_to_numpy(a), index_to_numpy(b)
    assert np.array_equal(ta["centroids"], tb["centroids"])
    for part in ("stats", "pending"):
        for u, v in zip(ta[part], tb[part]):
            assert np.array_equal(u, v), part
    assert a.n_total == b.n_total


# --- guarded ingestion ------------------------------------------------------

def _dirty():
    x = np.arange(8 * D, dtype=np.float32).reshape(8, D) / 7.0
    x[2, 3] = np.nan
    x[5, 0] = np.inf
    x[6, 1] = -np.inf
    return x


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("policy", ["sanitize", "drop", "reject"])
def test_guard_batch_matches_jax(policy, as_tensor):
    """Each policy gives the reference's clean rows and report, for a host
    batch and for a tensor checked where it lies."""
    x = _dirty()
    inp = torch.from_numpy(x) if as_tensor else x
    if policy == "reject":
        with pytest.raises(JValidationError) as je:
            j_guard(x, D, policy=policy)
        with pytest.raises(ValidationError) as te:
            guard_batch(inp, D, policy=policy)
        assert str(te.value) == str(je.value)
        return
    clean, rep = guard_batch(inp, D, policy=policy)
    jclean, jrep = j_guard(x, D, policy=policy)
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep == BatchReport(8, 3, "sanitized" if policy == "sanitize"
                              else "dropped")
    assert isinstance(clean, torch.Tensor) == as_tensor
    got = clean.numpy() if as_tensor else clean
    assert got.dtype == jclean.dtype and np.array_equal(got, jclean)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_guard_batch_shapes_and_dtypes(as_tensor):
    conv = torch.from_numpy if as_tensor else (lambda a: a)
    for bad, match in ((np.ones((8, D + 1), np.float32), "expected a"),
                       (np.ones((D,), np.float32), "expected a"),
                       (np.zeros((4, D), bool), "float")):
        with pytest.raises(ValidationError, match=match):
            guard_batch(conv(bad), D)
        with pytest.raises(JValidationError, match=match):
            j_guard(bad, D)
    ints, rep = guard_batch(conv(np.ones((4, D), np.int32)), D)
    assert rep == BatchReport(4, 0, "pass")
    assert str(ints.dtype).endswith("float32")
    with pytest.raises(ValueError, match="policy"):
        guard_batch(conv(np.ones((4, D), np.float32)), D, policy="nope")


# --- fault plans are the same data in both packages -------------------------

@pytest.mark.parametrize("seed", range(16))
def test_fault_plan_seeded_matches_jax(seed):
    for kw in ({}, {"n_events": 8, "horizon": 10},
               {"kinds": ("latency", "search_error"), "n_events": 3}):
        plan = FaultPlan.seeded(seed, **kw)
        assert plan.to_json() == JPlan.seeded(seed, **kw).to_json()
        assert FaultPlan.from_json(plan.to_json()).events == plan.events
        assert JPlan.from_json(plan.to_json()).to_json() == plan.to_json()


def test_fault_events_and_injector():
    with pytest.raises(ValueError, match="site"):
        FaultEvent("nope", "latency", 0)
    with pytest.raises(ValueError, match="kind"):
        FaultEvent("add", "nope", 0)
    inj = FaultInjector(FaultPlan([FaultEvent("add", "drop_add", 1),
                                   FaultEvent("search", "latency", 0, 0.0)]))
    assert inj.poll("add") == ()           # call 0: nothing
    assert inj.poll("add")[0].kind == "drop_add"
    assert inj.poll("search")[0].kind == "latency"
    assert inj.count() == 2 and inj.count("drop_add") == 1
    assert repr(FaultPlan([])) == repr(JPlan([]))


@pytest.mark.parametrize("k,seed", [(16, 7), (16, 11), (1, 3), (100, 0),
                                    (1024, 63)])
def test_corrupt_stats_matches_jax(k, seed):
    """The same rows (ref. l.138-139) become NaN, on the stats' device;
    the rest are untouched."""
    rng = np.random.default_rng(k)
    sums = rng.standard_normal((k, 4)).astype(np.float32)
    counts = rng.random(k).astype(np.float32)
    st = SufficientStats(torch.from_numpy(sums), torch.from_numpy(counts),
                         torch.tensor(1.5))
    bad_st, bad = corrupt_stats(st, seed)
    jst, jbad = j_corrupt(JStats(jnp.asarray(sums), jnp.asarray(counts),
                                 jnp.asarray(1.5)), seed)
    assert np.array_equal(bad, jbad)
    np.testing.assert_array_equal(bad_st.sums.numpy(), np.asarray(jst.sums))
    np.testing.assert_array_equal(bad_st.counts.numpy(),
                                  np.asarray(jst.counts))
    assert torch.isnan(bad_st.sums[torch.from_numpy(bad)]).all()
    assert np.array_equal(st.sums.numpy(), sums)   # not in place


def test_health_types_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(HealthPolicy)] \
        == [(f.name, f.default) for f in dataclasses.fields(JPolicy)]
    assert HealthCounters().as_dict() == JCounters().as_dict()
    c = HealthCounters()
    assert not c.degraded
    c.brute_fallbacks = 1
    assert c.degraded


# --- the WAL ------------------------------------------------------------------

def test_wal_append_replay_truncate(tmp_path, data):
    _, _, stream, _ = data
    wal = AddLog(str(tmp_path))
    for i, b in enumerate(stream[:4]):
        assert wal.append(i + 1, torch.from_numpy(b) if i % 2 else b)
    got = list(wal.replay(after=1))
    assert [s for s, _ in got] == [2, 3, 4]
    np.testing.assert_array_equal(got[0][1], stream[1])
    assert wal.truncate(3) == 3
    assert wal.seqnos() == [4]
    with pytest.raises(ValueError, match="log_every"):
        AddLog(str(tmp_path), log_every=0)


def test_wal_log_every_is_the_rpo_knob(tmp_path, data):
    _, _, stream, _ = data
    wal = AddLog(str(tmp_path), log_every=3, fsync=True)
    for i, b in enumerate(stream[:6]):
        wal.append(i + 1, b)
    assert wal.seqnos() == [1, 4]      # every 3rd batch durable
    assert wal.skipped == 4 and wal.appended == 6


# --- durability: kill and recover ---------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"store": "paged", "page_size": 16},
                                {"codec": "q8"}],
                         ids=["padded", "paged", "q8"])
def test_crash_recovery_is_bitwise_the_uninterrupted_run(tmp_path, data, kw):
    """Snapshot mid-stream, crash, recover, replay the WAL: the recovered
    index is bit for bit the uninterrupted run's (store arrays, centroids,
    statistics), with the refresh schedule carried through the manifest,
    and returns the same ids and distances."""
    _, _, stream, q = data
    ref = SearchEngine(_index(data, **kw), SearchConfig(**KW))
    for b in stream:
        ref.add(b)
    scfg = SearchConfig(**KW, snapshot_dir=str(tmp_path))
    eng = SearchEngine(_index(data, **kw), scfg)
    for b in stream[:3]:               # odd count: mid refresh cycle
        eng.add(torch.from_numpy(b))
    eng.snapshot()
    for b in stream[3:]:
        eng.add(torch.from_numpy(b))
    del eng                            # crash: the live index is lost
    assert latest_snapshot_seqno(str(tmp_path)) == 3
    eng2 = SearchEngine.recover(str(tmp_path), SearchConfig(**KW),
                                device="cpu")
    assert eng2.counters.wal_records_replayed == len(stream) - 3
    assert eng2.refresh_count == ref.refresh_count == len(stream) // 2
    assert eng2._seqno == len(stream)
    _same_index(eng2.index, ref.index)
    got, exp = eng2.search(q), ref.search(q)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


def test_recovery_from_a_jax_run_matches_the_jax_recovery(tmp_path, data):
    """The JAX engine writes the snapshot and the WAL and crashes; the
    port recovers from the same directory and returns the ids of the JAX
    package's own recovered engine (and its schedule)."""
    x, _, stream, q = data
    d = str(tmp_path)
    jeng = JEngine(_jindex(data), JConfig(**KW, snapshot_dir=d))
    for b in stream[:3]:
        jeng.add(jnp.asarray(b))
    jeng.snapshot()
    for b in stream[3:5]:
        jeng.add(jnp.asarray(b))
    del jeng
    teng = SearchEngine.recover(d, SearchConfig(**KW), device="cpu")
    jrec = JEngine.recover(d, JConfig(**KW))
    assert teng.counters.wal_records_replayed == \
        jrec.counters.wal_records_replayed == 2
    assert (teng.refresh_count, teng.adds_since_refresh, teng._seqno) == \
        (jrec.refresh_count, jrec.adds_since_refresh, jrec._seqno)
    assert teng.index.n_total == jrec.index.n_total
    ids, dists = teng.search(q)
    jids, jdists = jrec.search(jnp.asarray(q))
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(dists.numpy(), np.asarray(jdists), rtol=1e-5,
                               atol=_atol(q, np.concatenate([x, *stream])))


def test_recovery_without_wal_tail(tmp_path, data):
    _, _, stream, q = data
    eng = SearchEngine(_index(data),
                       SearchConfig(**KW, snapshot_dir=str(tmp_path)))
    for b in stream[:4]:
        eng.add(b)
    eng.snapshot()
    ids0, d0 = eng.search(q)
    eng2 = SearchEngine.recover(str(tmp_path), SearchConfig(**KW),
                                device="cpu")
    assert eng2.counters.wal_records_replayed == 0
    ids1, d1 = eng2.search(q)
    assert torch.equal(ids0, ids1) and torch.equal(d0, d1)
    assert read_manifest(str(tmp_path))["extra"]["refresh_count"] == \
        eng.refresh_count == 2
    with pytest.raises(NotImplementedError, match="queue A item 6"):
        SearchEngine.recover(str(tmp_path), device="cpu", pctx=object())


def test_auto_snapshot_schedule(tmp_path, data):
    _, _, stream, _ = data
    eng = SearchEngine(_index(data), SearchConfig(
        **KW, snapshot_dir=str(tmp_path), snapshot_every=2))
    for b in stream[:4]:
        eng.add(b)
    assert eng.counters.snapshots_written == 2
    assert latest_snapshot_seqno(str(tmp_path)) == 4
    assert eng.wal.seqnos() == []      # the covered tail is truncated
    eng = SearchEngine(_index(data), SearchConfig(
        **KW, snapshot_dir=str(tmp_path / "rpo"), wal_log_every=2))
    for b in stream[:4]:
        eng.add(b)
    assert eng.wal.seqnos() == [1, 3]


# --- the degradation ladder ---------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_health_counters_match_jax_under_chaos(seed, data):
    """The same seeded plan over the same traffic: nothing raises, every
    distance is finite, and the port's counters equal the reference's."""
    _, _, stream, q = data
    plan = dict(n_events=8, horizon=6)
    teng = SearchEngine(_index(data), SearchConfig(**KW),
                        health=HealthPolicy(**POL),
                        faults=FaultInjector(FaultPlan.seeded(seed, **plan)))
    jeng = JEngine(_jindex(data), JConfig(**KW), health=JPolicy(**POL),
                   faults=JInjector(JPlan.seeded(seed, **plan)))
    for i, b in enumerate(stream[:4]):
        teng.add(b)
        jeng.add(jnp.asarray(b))
        ids, dists = teng.search(q[8 * i:8 * i + 8])
        jeng.search(jnp.asarray(q[8 * i:8 * i + 8]))
        assert ids.shape == (8, KW["topk"])
        assert bool(torch.isfinite(dists).all())
    assert teng.counters.as_dict() == jeng.counters.as_dict()
    assert [e.kind for e in teng.index.faults.fired] == \
        [e.kind for e in jeng.index.faults.fired]
    assert teng.counters.searches_ok > 0


def test_retry_recovers_from_a_transient_search_fault(data):
    _, _, _, q = data
    inj = FaultInjector(FaultPlan([FaultEvent("search", "search_error", 0)]))
    eng = SearchEngine(_index(data), SearchConfig(**KW),
                       health=HealthPolicy(**POL), faults=inj)
    ids, dists = eng.search(q)         # the first call fails, the retry not
    assert eng.counters.retries == 1 and eng.counters.searches_ok >= 1
    clean = SearchEngine(_index(data), SearchConfig(**KW))
    assert torch.equal(clean.search(q)[0], ids)


def test_ladder_reaches_brute_force_then_the_black_hole(data):
    """Every configured search fails: the ladder lands on brute force
    (exact ids); without brute force and last-known-good it returns
    honest (-1, 0.0) rows. Neither raises."""
    _, _, _, q = data
    events = [FaultEvent("search", "search_error", i) for i in range(64)]
    eng = SearchEngine(_index(data), SearchConfig(**KW),
                       health=HealthPolicy(**POL),
                       faults=FaultInjector(FaultPlan(events)))
    ids, dists = eng.search(q[:8])
    c = eng.counters
    assert (c.brute_fallbacks, c.retries, c.searches_ok) == (1, 2, 0)
    assert eng.index.faults.count() == 3 + 2   # nprobe 4 -> 2 -> 1
    padded = torch.nn.functional.pad(torch.from_numpy(q[:8]),
                                     (0, 0, 0, 0))
    assert torch.equal(ids, eng.index.search_brute(padded, topk=6)[0])
    pol = HealthPolicy(**POL, brute_fallback=False, lkg_fallback=False)
    eng = SearchEngine(_index(data), SearchConfig(**KW), health=pol,
                       faults=FaultInjector(FaultPlan(events)))
    ids, dists = eng.search(q[:4])
    assert eng.counters.blackholed == 1
    assert bool((ids == -1).all()) and bool((dists == 0.0).all())
    # the last-known-good clone: brute force off, the clone serves
    pol = HealthPolicy(**POL, brute_fallback=False)
    eng = SearchEngine(_index(data), SearchConfig(**KW), health=pol,
                       faults=FaultInjector(FaultPlan(events)))
    ids, _ = eng.search(q[:8])
    assert eng.counters.lkg_fallbacks == 1
    assert torch.equal(ids, eng._lkg.search(q[:8], topk=6, nprobe=1)[0])


def _kernel_fault(*_a, **_k):
    raise KernelUnavailable("flash_probe_tile kernel launch failed: CUDA "
                            "error 98")


def _transient(*_a, **_k):
    raise RuntimeError("a transient search fault")


@pytest.mark.parametrize("where", ["search", "brute", "lkg", "add",
                                   "refresh"])
def test_kernel_faults_pass_through_the_ladder(where, data):
    """A kernel that cannot build or launch is raised through the ladder,
    the queue of pending adds and the guarded refresh: no rung answers
    with the plain version in its place, and no counter absorbs it."""
    _, _, stream, q = data
    pol = HealthPolicy(**POL, brute_fallback=where != "lkg")
    eng = SearchEngine(_index(data), SearchConfig(**KW), health=pol)
    if where == "search":
        eng.index.search = _kernel_fault
    elif where in ("brute", "lkg"):   # the probe fails, the rung's kernel too
        eng.index.search = _transient
        eng.index.search_brute = _kernel_fault
        eng._lkg.search = _kernel_fault
    elif where == "add":
        eng.index.add = _kernel_fault
    else:
        eng.index.refresh = _kernel_fault
    with pytest.raises(KernelUnavailable, match="CUDA error 98"):
        if where == "refresh":
            eng.refresh()
        elif where == "add":
            eng.add(stream[0])
        else:
            eng.search(q[:8])
    c = eng.counters
    assert (c.searches_ok, c.nprobe_degraded, c.brute_fallbacks,
            c.lkg_fallbacks, c.blackholed, c.adds_requeued, c.adds_rejected,
            c.refresh_failures) == (0,) * 8
    assert len(eng._pending_adds) == 0


def test_dead_shard_on_one_device_is_a_search_error(data):
    _, _, _, q = data
    idx = _index(data)
    idx.faults = FaultInjector(FaultPlan([FaultEvent("search", "dead_shard",
                                                     0, 3.0)]))
    with pytest.raises(InjectedFault, match="replica death"):
        idx.search(q, topk=6, nprobe=4)
    assert idx.search(q, topk=6, nprobe=4)[0].shape == (len(q), 6)


def test_nan_stats_repaired_at_refresh(data):
    _, _, stream, q = data
    plan = FaultPlan([FaultEvent("add", "nan_stats", 0, arg=11),
                      FaultEvent("refresh", "nan_stats", 0, arg=5)])
    eng = SearchEngine(_index(data), SearchConfig(**KW),
                       health=HealthPolicy(**POL),
                       faults=FaultInjector(plan))
    eng.add(stream[0])
    assert bool(torch.isnan(eng.index._pending.sums).any())
    eng.add(stream[1])                 # the guarded refresh
    jeng = JEngine(_jindex(data), JConfig(**KW), health=JPolicy(**POL),
                   faults=JInjector(JPlan.from_json(plan.to_json())))
    for b in stream[:2]:
        jeng.add(jnp.asarray(b))
    assert eng.counters.stats_repaired == jeng.counters.stats_repaired > 0
    assert bool(torch.isfinite(eng.index.centroids).all())
    _, dists = eng.search(q)
    assert bool(torch.isfinite(dists).all())


def test_the_queue_of_pending_adds_requeues(data):
    x, _, stream, _ = data
    plan = FaultPlan([FaultEvent("add", "add_error", i) for i in range(2)])
    eng = SearchEngine(_index(data), SearchConfig(**KW),
                       health=HealthPolicy(**POL),
                       faults=FaultInjector(plan))
    eng.add(stream[0])                 # fails: parked
    eng.add(stream[1])                 # the retry of [0] fails again
    assert eng.counters.adds_requeued >= 2
    eng.add(stream[2])                 # the faults are spent: all applied
    assert len(eng._pending_adds) == 0
    assert eng.index.n_total == N + 3 * 64
    assert eng.counters.adds_rejected == 0
    with pytest.raises(InjectedFault):   # without a policy the add raises
        SearchEngine(_index(data), SearchConfig(**KW),
                     faults=FaultInjector(plan)).add(stream[0])


def test_the_queue_of_pending_adds_rejects_when_full(data):
    _, _, stream, _ = data
    pol = HealthPolicy(**POL, max_pending_adds=1)
    plan = FaultPlan([FaultEvent("add", "add_error", i) for i in range(8)])
    eng = SearchEngine(_index(data), SearchConfig(**KW), health=pol,
                       faults=FaultInjector(plan))
    for b in stream[:4]:
        eng.add(b)
    assert eng.counters.adds_rejected >= 1   # backpressure, not memory
    assert len(eng._pending_adds) <= 1


def test_guarded_ingestion_in_the_engine(data):
    """NaN query rows are zeroed at admission (rows stay aligned); NaN
    insert rows are dropped; the counters say so."""
    _, _, stream, q = data
    eng = SearchEngine(_index(data), SearchConfig(**KW),
                       health=HealthPolicy(**POL))
    qq = torch.from_numpy(q[:8].copy())
    qq[3, 2] = float("nan")
    ids, dists = eng.search(qq)
    assert ids.shape == (8, 6) and bool(torch.isfinite(dists).all())
    assert eng.counters.queries_sanitized == 1
    xb = stream[0].copy()
    xb[[1, 4], 0] = np.inf
    n0 = eng.index.n_total
    assert eng.add(xb).shape == (62,)
    assert eng.counters.insert_rows_dropped == 2
    assert eng.index.n_total == n0 + 62


def test_dead_cell_reseed_matches_jax(data):
    """A forged dead cell (no rows, no evidence) is re-seeded from the
    heaviest cell, as the reference re-seeds it; the default refresh
    never re-seeds."""
    idx, jidx = _index(data), _jindex(data)
    for i in (idx, jidx):
        i.refresh()
    idx.counts = idx.counts.clone().index_fill(0, torch.tensor([3]), 0)
    idx.stats = SufficientStats(idx.stats.sums.index_fill(
        0, torch.tensor([3]), 0.0), idx.stats.counts.index_fill(
        0, torch.tensor([3]), 0.0), idx.stats.inertia)
    jidx.counts = jidx.counts.at[3].set(0)
    jidx.stats = JStats(jidx.stats.sums.at[3].set(0.0),
                        jidx.stats.counts.at[3].set(0.0), jidx.stats.inertia)
    before = idx.centroids.clone()
    idx.refresh(repair_dead=True)
    jidx.refresh(repair_dead=True)
    assert idx.reseeded_cells == jidx.reseeded_cells == 1
    assert not torch.equal(idx.centroids[3], before[3])
    np.testing.assert_allclose(idx.centroids.numpy(),
                               np.asarray(jidx.centroids), rtol=1e-5,
                               atol=1e-5)
    other = _index(data)
    other.counts = other.counts.clone().index_fill(0, torch.tensor([3]), 0)
    other.refresh()
    assert other.reseeded_cells == 0


def test_the_lkg_clone_is_retaken_at_refresh(data):
    _, _, stream, q = data
    eng = SearchEngine(_index(data), SearchConfig(**KW),
                       health=HealthPolicy(**POL))
    lkg0 = eng._lkg
    ids0, d0 = lkg0.search(q, topk=6, nprobe=4)
    eng.add(stream[0])                 # an add leaves the clone alone
    assert eng._lkg is lkg0
    assert torch.equal(lkg0.search(q, topk=6, nprobe=4)[1], d0)
    eng.add(stream[1])                 # the refresh retakes it
    assert eng._lkg is not lkg0
    assert eng._lkg.n_total == eng.index.n_total
    _same_index(eng._lkg, eng.index)


# --- the launcher ---------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--health"],
                                   ["--chaos-seed", "7", "--health"],
                                   ["--snapshot-dir", "SNAP"],
                                   ["--snapshot-dir", "SNAP",
                                    "--snapshot-every", "2", "--health",
                                    "--chaos-seed", "8"]],
                         ids=["health", "chaos", "snapshot", "all"])
def test_launcher_reliability_flags(flags, tmp_path, capsys):
    from repro_torch.launch import serve
    flags = [str(tmp_path / "snap") if f == "SNAP" else f for f in flags]
    out = serve.main(["--mode", "search", "--device", "cpu", "--n", "2000",
                      "--d", "16", "--kc", "16", "--queries", "32",
                      "--reps", "2", *flags])
    text = capsys.readouterr().out
    assert out["recall"] >= 0.5
    if "--health" in flags:
        assert "health counters:" in text and "counters" in out
    if "7" in flags:   # seed 7's plan fails the first search: retried
        assert out["counters"]["retries"] > 0
    if "--snapshot-dir" in flags:
        assert out["restored_same"] and "restored search identical: True" \
            in text
        assert os.path.exists(tmp_path / "snap" / "index_manifest.json")
