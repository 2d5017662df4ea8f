"""The port's continuous-batching ``SearchEngine`` (``repro_torch.serve``),
on the CPU: each scenario of ``tests/serve/test_engine.py`` against the
port's ``IVFIndex``, and one op stream through the JAX package's engine
and the port's on bridged indexes.

The serving contract: ``submit``/``submit_add`` admit requests of any row
count into one FIFO queue; ``pump`` drains it (consecutive searches
coalesce into padded power-of-two units, oversized requests split with
the tail keeping its place in line, adds apply between units), and every
result equals, bit for bit, what the same operations give run one by one
through a synchronous engine (``pipeline_depth=1``) in FIFO order.

Against the JAX engine: the data is tie-free (the 16 nearest exact
distances of every query more than ``1e-6 * (max ||q||^2 + max ||x||^2)``
apart), so ids are equal; distances agree within ``rtol=1e-5`` plus
``atol = 1e-5 * (max ||q||^2 + max ||x||^2)``, the tolerance
``tests/test_torch_index.py`` states (the packages sum ``||x||^2 - 2 q.x``
in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import IVFIndex as JIVF
from repro.serve.engine import SearchConfig as JConfig
from repro.serve.engine import SearchEngine as JEngine
from repro_torch.index import IVFIndex, index_from_numpy
from repro_torch.serve import SearchConfig, SearchEngine

K, D = 16, 16


def _blobs(seed, n, k=K, d=D, spread=6.0, noise=0.3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)).astype(np.float32) * spread
    lab = rng.integers(0, k, n)
    x = centers[lab] + rng.standard_normal((n, d)).astype(np.float32) * noise
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    return _blobs(0, 1024), _blobs(7, 300)


def _engine(x, codec="fp32", **kw):
    scfg = SearchConfig(topk=5, nprobe=4, query_batch=32, refresh_every=2,
                        **kw)
    index = IVFIndex.build(x, k=K, max_iters=6, seed=0, device="cpu",
                           codec=codec)
    return SearchEngine(index, scfg)


def _equal(got, exp):
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_interleaved_queue_matches_synchronous_fifo(corpus, codec):
    """submit/submit_add traffic drained through the queue gives bit for
    bit the results of the same operations run synchronously in admission
    order: adds land between units, never reordered."""
    x, q = corpus
    eng = _engine(x, codec)
    ref = _engine(x, codec, pipeline_depth=1)
    ops = [("search", q[:20]), ("add", q[20:84]),
           ("search", q[84:100]), ("add", q[100:164]),
           ("search", q[164:230]), ("search", q[230:260])]
    rids = [(kind, eng.submit(p) if kind == "search"
             else eng.submit_add(p)) for kind, p in ops]
    assert eng.queue_depth == len(ops)
    got = [(kind, eng.take(rid)) for kind, rid in rids]
    assert eng.queue_depth == 0
    for (kind, payload), (_, res) in zip(ops, got):
        if kind == "search":
            _equal(res, ref.search(payload))
        else:
            assert torch.equal(res, ref.add(payload))
    assert eng.interleaved_adds == 2
    assert eng.refresh_count == ref.refresh_count == 1


def test_consecutive_searches_coalesce_into_units(corpus):
    """Eight 4-row requests = one 32-row unit: one padded dispatch, all
    eight results scattered back."""
    x, q = corpus
    eng = _engine(x)
    rids = [eng.submit(q[4 * i:4 * i + 4]) for i in range(8)]
    eng.pump()
    assert eng.batches_formed == 1
    assert eng.coalesced_requests == 8
    ids_ref, d_ref = _engine(x).search(q[:32])
    for i, rid in enumerate(rids):
        ids, dists = eng.take(rid)
        assert ids.shape == (4, 5) and dists.shape == (4, 5)
        _equal((ids, dists), (ids_ref[4 * i:4 * i + 4],
                              d_ref[4 * i:4 * i + 4]))


def test_ragged_sizes_never_rejected(corpus):
    """Any row count (0, 1, sub-bucket, bucket-straddling, larger than
    query_batch) is served, shape-correct and bit for bit stable."""
    x, q = corpus
    eng = _engine(x)
    ref = _engine(x, pipeline_depth=1)
    for n in (0, 1, 7, 9, 31, 33, 100):
        ids, dists = eng.search(q[:n])
        assert ids.shape == (n, 5) and dists.shape == (n, 5)
        assert ids.dtype == torch.int32 and dists.dtype == torch.float32
        _equal((ids, dists), ref.search(q[:n]))
    assert eng.queue_depth == 0


def test_oversized_request_splits_and_reassembles(corpus):
    """A 100-row request over a 32-row unit budget runs as ceil(100/32)
    units; the tail keeps its place at the head of the line and the slices
    concatenate back into one (100, topk) result."""
    x, q = corpus
    eng = _engine(x)
    rid = eng.submit(q[:100])
    eng.pump()
    assert eng.batches_formed == 4
    ids, dists = eng.take(rid)
    assert ids.shape == (100, 5)
    assert eng.queries_served == 100
    ids_ref, _ = eng.index.search(q[:100], topk=5, nprobe=4)
    assert torch.equal(ids, ids_ref)


def test_adds_interleave_between_search_units(corpus):
    """search | add | search admitted together: the first unit runs on the
    index before the add, the second sees the inserted rows."""
    x, q = corpus
    eng = _engine(x)
    n0 = len(eng.index)
    new = eng.index.centroids[:8].numpy() + 0.02
    r1 = eng.submit(q[:8])
    ra = eng.submit_add(new)
    r2 = eng.submit(new)               # should hit the new rows exactly
    eng.pump()
    assert eng.interleaved_adds == 1
    ids1, _ = eng.take(r1)
    assert int(ids1.max()) < n0
    cells = eng.take(ra)
    assert cells.shape == (8,)
    ids2, d2 = eng.take(r2)
    assert np.array_equal(ids2[:, 0].numpy(), n0 + np.arange(8))
    np.testing.assert_allclose(d2[:, 0].numpy(), 0.0, atol=1e-3)


def test_admission_backpressure(corpus):
    x, q = corpus
    eng = _engine(x, queue_max=3)
    for i in range(3):
        eng.submit(q[i:i + 1])
    with pytest.raises(RuntimeError, match="admission queue full"):
        eng.submit(q[:1])
    with pytest.raises(RuntimeError, match="admission queue full"):
        eng.submit_add(q[:1])
    eng.pump()                         # drains: admission reopens
    assert eng.queue_depth == 0
    eng.submit(q[:1])


def test_take_unknown_rid_raises(corpus):
    x, _ = corpus
    eng = _engine(x)
    with pytest.raises(KeyError, match="unknown or lost"):
        eng.take(999)


# --- the overlapped dispatch pipeline ----------------------------------------

@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_pump_overlaps_units_and_stays_bitwise(corpus, codec):
    """With pipeline_depth=2 pump dispatches unit i+1 while unit i is
    still in flight (``overlap_hits``), and the results stay bit for bit
    the synchronous FIFO answers."""
    x, q = corpus
    eng = _engine(x, codec)
    ref = _engine(x, codec, pipeline_depth=1)
    rids = [eng.submit(q[32 * i:32 * i + 32]) for i in range(4)]
    eng.pump()
    assert eng.batches_formed == 4
    assert eng.overlap_hits == 3
    for i, rid in enumerate(rids):
        _equal(eng.take(rid), ref.search(q[32 * i:32 * i + 32]))
    assert eng.latency_stats()["inflight"] == 0
    assert ref.overlap_hits == 0


def test_pipeline_depth_bounds_inflight_units(corpus):
    x, q = corpus
    for depth in (1, 2, 3):
        eng = _engine(x, pipeline_depth=depth)
        for i in range(5):
            eng.submit(q[32 * i:32 * i + 32])
        eng.pump()
        assert eng.latency_stats()["inflight"] == depth


def test_take_settles_inflight_before_returning(corpus):
    """take() hands back no result whose unit is still in flight."""
    x, q = corpus
    eng = _engine(x)
    r1 = eng.submit(q[:32])
    r2 = eng.submit(q[32:64])
    eng.pump()
    ids, _ = eng.take(r1)
    assert not any(r1 in rids for rids, *_ in eng._inflight)
    assert ids.shape == (32, 5)
    eng.take(r2)
    assert eng.latency_stats()["inflight"] == 0


def test_latency_stats_honest_timing(corpus):
    """Percentiles sample only warm shape buckets (first-seen buckets pay
    their planning and are excluded), and completion is never below
    dispatch."""
    x, q = corpus
    eng = _engine(x)
    lat0 = eng.latency_stats()
    assert set(lat0) == {"dispatch_p50_ms", "dispatch_p99_ms",
                         "complete_p50_ms", "complete_p99_ms",
                         "overlap_hits", "inflight"}
    assert lat0["dispatch_p50_ms"] == 0.0 and lat0["overlap_hits"] == 0
    for _ in range(3):                  # rep 1 is cold, 2-3 sample
        eng.search(q[:32])
    lat = eng.latency_stats()
    assert len(eng._dispatch_ms) == 2 and len(eng._complete_ms) == 2
    assert lat["dispatch_p50_ms"] >= 0.0
    assert lat["complete_p50_ms"] >= lat["dispatch_p50_ms"]
    assert lat["complete_p99_ms"] >= lat["complete_p50_ms"]
    assert lat["inflight"] == 0


def test_plans_are_pinned_and_repinned_on_geometry(corpus):
    """Every bucket is planned at construction; steady traffic plans
    nothing, and the engine re-pins when ``search_geometry`` moves."""
    x, q = corpus
    eng = _engine(x)
    assert eng._buckets == [8, 16, 32]
    assert eng._pinned_geom == eng.index.search_geometry(5, 4)
    geom0 = eng._pinned_geom
    misses = eng.index.planner.counters()["misses"]
    for n in (3, 12, 32, 50):
        eng.search(q[:n])
    assert eng.index.planner.counters()["misses"] == misses
    for _ in range(3):                  # grow the cells past their width
        eng.add(np.repeat(x[:300], 2, axis=0))
    assert eng.index.search_geometry(5, 4) != geom0
    eng.search(q[:8])
    assert eng._pinned_geom == eng.index.search_geometry(5, 4)
    assert eng.index.planner.counters()["misses"] > misses


# --- the reliability options (ported, on one device and onto a mesh) ---------

def test_unported_reliability_options_raise(corpus, tmp_path):
    """The reliability options of queue A item 5 now work (they raised
    before it was ported), and so does recovery onto a mesh (item 6b,
    which raised until it was ported): here onto a world of one rank with
    a cells axis."""
    from repro_torch.reliability import (FaultInjector, FaultPlan,
                                         HealthPolicy)
    x, _ = corpus
    index = IVFIndex.build(x[:256], k=4, max_iters=2, device="cpu")
    eng = SearchEngine(index, health=HealthPolicy(),
                       faults=FaultInjector(FaultPlan.seeded(7)))
    assert index.faults is not None and eng._lkg is not None
    assert eng.search(x[:8])[0].shape == (8, 10)   # seed 7: retried
    assert eng.counters.retries == 1
    index.faults = None
    snap = str(tmp_path / "snap")
    for cfg in ({"snapshot_dir": snap}, {"snapshot_every": 2},
                {"wal_log_every": 4, "snapshot_dir": snap}):
        SearchEngine(index, SearchConfig(**cfg))
    eng = SearchEngine(index, SearchConfig(snapshot_dir=snap))
    eng.add(x[256:300])
    assert eng.snapshot().endswith("index_00000001.npz")
    rec = SearchEngine.recover(snap, device="cpu")
    assert torch.equal(rec.search(x[:8])[0], eng.search(x[:8])[0])
    from repro_torch.core import parallel as par
    try:
        pk = par.ParallelContext(par.build_mesh(
            (1, 1), ("data", "model"), device_type="cpu"), k_axis="model")
        on_mesh = SearchEngine.recover(snap, pctx=pk)
        assert on_mesh.index.pctx is pk and on_mesh.index._k_sharded
        got, want = on_mesh.search(x[:8]), rec.search(x[:8])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    finally:
        par.release_world()
    # nprobe_c no longer raises (the two-level router is ported): the flat
    # router takes it and ignores it, as the reference's does
    eng = SearchEngine(index, SearchConfig(topk=5, nprobe=2, nprobe_c=2))
    ids, _ = eng.search(x[:8])
    assert torch.equal(ids, index.search(x[:8], topk=5, nprobe=2)[0])


# --- the port's engine against the JAX package's -----------------------------

def _atol(q, x):
    q, x = np.asarray(q, np.float64), np.asarray(x, np.float64)
    return 1e-5 * (float((q * q).sum(-1).max()) + float((x * x).sum(-1).max()))


def _assert_tie_free(q, x, depth=16):
    q, x = np.asarray(q, np.float64), np.asarray(x, np.float64)
    dist = ((q[:, None, :] - x[None]) ** 2).sum(-1)
    gap = np.diff(np.sort(dist, axis=1)[:, :depth], axis=1).min()
    assert gap > 0.1 * _atol(q, x), f"near-tie {gap:.3g}: pick another seed"


def _bridge(jidx):
    st = lambda s: tuple(np.asarray(a) for a in s)
    jc = getattr(jidx.store, "cache", None)
    cache = None if jc is None else {
        "keys": np.asarray(jc.keys), "rows": np.asarray(jc.rows),
        "ref": np.asarray(jc.ref), "hand": np.asarray(jc.hand),
        "sets": jc.sets, "ways": jc.ways, "max_bytes": jc.max_bytes,
        "inserted": jc.inserted}
    return index_from_numpy(
        np.asarray(jidx.centroids), jidx.store.state_arrays(),
        jidx.store.meta(), n_total=jidx.n_total, stats=st(jidx.stats),
        pending=st(jidx._pending), device="cpu", cache=cache)


@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_op_stream_matches_the_jax_engine(codec):
    """One ragged op stream with interleaved adds and a refresh through
    ``repro.serve.engine.SearchEngine`` and the port's, over bridged
    indexes: the adds assign the same cells and every request returns
    the same ids, distances within the stated tolerance."""
    x = _blobs(36, 1500, spread=2.0, noise=1.0)
    extra = _blobs(136, 400, spread=2.0, noise=1.0)
    q = x[1::7][:200]
    jidx = JIVF.build(jnp.asarray(x), k=K, max_iters=4, codec=codec)
    tidx = _bridge(jidx)
    kw = dict(topk=5, nprobe=4, query_batch=32, refresh_every=2)
    jeng = JEngine(jidx, JConfig(**kw))
    teng = SearchEngine(tidx, SearchConfig(**kw))
    ops = [("search", q[:13]), ("search", q[13:50]), ("add", extra[:200]),
           ("search", q[50:51]), ("search", q[51:120]), ("add", extra[200:]),
           ("search", q[120:200]), ("search", q[:0])]
    jr = [jeng.submit(jnp.asarray(p)) if kind == "search"
          else jeng.submit_add(jnp.asarray(p)) for kind, p in ops]
    tr = [teng.submit(p) if kind == "search" else teng.submit_add(p)
          for kind, p in ops]
    corpus_all = np.concatenate([x, extra])
    for (kind, p), a, b in zip(ops, jr, tr):
        got, exp = teng.take(b), jeng.take(a)
        if kind == "add":
            assert np.array_equal(got.numpy(), np.asarray(exp))
            continue
        ids, dists = got
        assert ids.shape == (p.shape[0], 5)
        if p.shape[0]:
            _assert_tie_free(p, corpus_all)
        assert np.array_equal(ids.numpy(), np.asarray(exp[0]))
        np.testing.assert_allclose(dists.numpy(), np.asarray(exp[1]),
                                   rtol=1e-5, atol=_atol(q, corpus_all))
    assert teng.refresh_count == jeng.refresh_count == 1
    assert (teng.batches_formed, teng.coalesced_requests,
            teng.interleaved_adds, teng.overlap_hits) == \
        (jeng.batches_formed, jeng.coalesced_requests,
         jeng.interleaved_adds, jeng.overlap_hits)


# --- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_launcher_serves_search_on_the_cpu(codec, capsys):
    from repro_torch.launch import serve
    out = serve.main(["--mode", "search", "--device", "cpu", "--n", "3000",
                      "--d", "16", "--kc", "16", "--queries", "40",
                      "--reps", "2", "--codec", codec])
    assert out["recall"] >= 0.9 and out["qps"] > 0
    assert out["inflight"] == 0
    text = capsys.readouterr().out
    assert "recall@10=" in text and "latency: dispatch p50" in text
    assert ("DeviceRescoreCache" in text) == (codec == "q8")


@pytest.mark.parametrize("flags,item", [
    (["--mode", "dense", "--arch", "llama3-8b", "--reduced", "--mesh",
      "1x1"], "item 8a"),
    (["--mode", "clustered", "--arch", "minicpm3-4b", "--reduced",
      "--mesh", "1x1"], "item 8a"),
    (["--mesh", "1x1", "--health"], None)])
def test_launcher_refuses_what_is_not_ported(flags, item):
    """Since item 8a's mesh half every flag here serves: LM serving over a
    mesh (here the dense-attention family and MLA, at world size 1: the
    ids of the launcher without ``--mesh``, no process group left behind;
    ``tests/test_torch_mesh_lm_serve.py`` serves on 4 ranks), and the
    sharded index with its health policy (``item`` None)."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    if item is None:
        out = serve.main(["--device", "cpu", "--n", "2000", "--d", "16",
                          "--kc", "16", "--queries", "32", "--reps", "2",
                          *flags])
        assert out["recall"] >= 0.9 and "counters" in out
        return
    lm = ["--device", "cpu", "--batch", "2", "--prompt-len", "32", "--gen",
          "4", "--recent", "2"]
    got = serve.main([*lm, *flags])
    assert not dist.is_initialized()
    want = serve.main([*lm, *flags[:-2]])
    assert torch.equal(got["ids"], want["ids"])


def test_launcher_serves_a_mesh_of_one(capsys):
    """``--mesh 1x1`` runs without torchrun, at world size 1, and leaves no
    process group behind."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    out = serve.main(["--mode", "search", "--device", "cpu", "--n", "2000",
                      "--d", "16", "--kc", "16", "--queries", "32",
                      "--reps", "2", "--mesh", "1x1"])
    assert out["recall"] >= 0.9 and out["collective_bytes"] == 0
    assert "sharded serving: ParallelContext" in capsys.readouterr().out
    assert not dist.is_initialized()


_RANK_MAIN = """
import json, sys
from repro_torch.launch import serve
out = serve.main(sys.argv[2:])
json.dump({k: out[k] for k in ("recall", "collective_bytes")},
          open(sys.argv[1], "w"))
"""


def test_launcher_mesh_rendezvous_from_the_torchrun_environment(tmp_path):
    """``--mesh 1x2`` on two ranks that find each other as ``torchrun``'s
    ranks do: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` in the environment (gloo on the CPU). Both exit 0,
    only rank 0 prints, and both report the same recall and the reference's
    modeled bytes of a batch."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path
    from repro.core.parallel import search_collective_bytes_model
    with socket.socket() as sock:   # a free port, not a fixed one
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    flags = ["--mode", "search", "--device", "cpu", "--n", "2000", "--d",
             "16", "--kc", "16", "--queries", "32", "--nprobe", "8",
             "--reps", "2", "--mesh", "1x2"]
    procs = []
    for r in range(2):
        env = {**os.environ, "PYTHONPATH": str(root / "src"),
               "OMP_NUM_THREADS": "1", "RANK": str(r), "LOCAL_RANK": str(r),
               "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_MAIN, str(tmp_path / f"{r}.json"),
             *flags], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r][1][-3000:]}"
    assert "sharded serving: ParallelContext" in outs[0][0]
    assert "recall@10=" in outs[0][0]
    assert outs[1][0] == ""
    res = [json.loads((tmp_path / f"{r}.json").read_text()) for r in range(2)]
    assert res[0] == res[1]
    assert res[0]["recall"] >= 0.9
    assert res[0]["collective_bytes"] == search_collective_bytes_model(
        32, 8, 10, 16, 2)


def test_launcher_mesh_must_fill_the_world():
    import torch.distributed as dist
    from repro_torch.launch import serve
    with pytest.raises(ValueError, match="ranks"):
        serve.main(["--device", "cpu", "--mesh", "1x8"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("flags", [
    ["--store", "paged", "--health"],
    ["--codec", "q8", "--chaos-seed", "7", "--health"],
    ["--router", "two_level", "--snapshot-dir", "SNAP"],
    ["--health"], ["--chaos-seed", "8"], ["--snapshot-dir", "SNAP"]])
def test_launcher_mesh_refuses_what_6b_ports(flags, tmp_path, capsys):
    """The reliability flags over a mesh, which waited for item 6b, serve
    beside any of the axes: at ``--mesh 1x1`` (world 1; ``2x2`` needs four
    ranks) the health counters print under a policy or a plan, and the
    durability demo recovers onto the mesh with the same ids. (Seed 7's
    plan fails the first search, which only a policy absorbs; seed 8's
    first search fault comes later.)"""
    import torch.distributed as dist
    from repro_torch.launch import serve
    flags = [str(tmp_path / "snap") if f == "SNAP" else f for f in flags]
    out = serve.main(["--mode", "search", "--device", "cpu", "--n", "2000",
                      "--d", "16", "--kc", "16", "--queries", "32",
                      "--reps", "2", "--mesh", "1x1", *flags])
    text = capsys.readouterr().out
    assert out["recall"] >= 0.9 and "sharded serving:" in text
    assert ("health counters:" in text) == any(
        f in flags for f in ("--health", "--chaos-seed"))
    if "--snapshot-dir" in flags:
        assert "restored search identical: True" in text
    assert not dist.is_initialized()


@pytest.mark.parametrize("flags", [
    ["--store", "paged", "--page-size", "16"], ["--codec", "q8"],
    ["--codec", "q8", "--rescore", "host", "--store", "paged"],
    ["--router", "two_level"]])
def test_launcher_mesh_serves_the_6b_axes(flags, capsys):
    """``--mesh`` with ``--store paged``, ``--codec q8`` and ``--router
    two_level`` (queue A item 6b, parts 1-3) serves a search at world 1
    and leaves no process group behind."""
    import torch.distributed as dist
    from repro_torch.launch import serve
    out = serve.main(["--mode", "search", "--device", "cpu", "--n", "2000",
                      "--d", "16", "--kc", "16", "--queries", "32",
                      "--reps", "2", "--mesh", "1x1", *flags])
    assert out["recall"] >= 0.9 and out["collective_bytes"] == 0
    assert "sharded serving: ParallelContext" in capsys.readouterr().out
    assert not dist.is_initialized()


@pytest.mark.parametrize("flags", [
    ["--health"], ["--snapshot-dir", "SNAP"], ["--snapshot-every", "4"],
    ["--chaos-seed", "8"]])
def test_launcher_takes_the_reliability_flags(flags, tmp_path, capsys):
    """The four flags of queue A item 5, which the launcher refused before
    the reliability layer was ported, each serve a search."""
    from repro_torch.launch import serve
    flags = [str(tmp_path / "snap") if f == "SNAP" else f for f in flags]
    out = serve.main(["--mode", "search", "--device", "cpu", "--n", "2000",
                      "--d", "16", "--kc", "16", "--queries", "32",
                      "--reps", "2", *flags])
    assert out["recall"] >= 0.9 and out["qps"] > 0
    text = capsys.readouterr().out
    assert ("health counters:" in text) == (flags[0] in ("--health",
                                                         "--chaos-seed"))
    assert out.get("restored_same", True)


@pytest.mark.parametrize("codec", ["fp32", "q8"])
def test_launcher_serves_the_paged_store(codec, capsys):
    """``--store paged --page-size 64`` (refused before the paged store was
    ported) builds the paged store and serves through it."""
    from repro_torch.launch import serve
    out = serve.main(["--mode", "search", "--device", "cpu", "--n", "3000",
                      "--d", "16", "--kc", "16", "--queries", "40",
                      "--reps", "2", "--codec", codec, "--store", "paged",
                      "--page-size", "64"])
    assert out["recall"] >= 0.9 and out["qps"] > 0
    assert out["inflight"] == 0
    assert "PagedBucketStore(k=16, d=16, page_size=64" in \
        capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--router", "two_level"]])
def test_launcher_serves_the_routed_search(flags, capsys):
    """``--router two_level`` (refused before the router was ported)
    trains the router, prints it as the reference's launcher does and
    serves through it."""
    from repro_torch.launch import serve
    out = serve.main(["--mode", "search", "--device", "cpu", "--n", "3000",
                      "--d", "16", "--kc", "32", "--queries", "40",
                      "--nprobe", "16", "--reps", "1", *flags])
    assert out["recall"] >= 0.9 and out["qps"] > 0
    assert "router: TwoLevelRouter(K_c=16, K=32" in capsys.readouterr().out
