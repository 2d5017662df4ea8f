"""The port's parallel layer in one process (a gloo world of one rank),
held to ``repro.core.parallel`` where both can run here: the mesh helpers,
the validation rules, the collective-bytes models, the int8 codec of the
compressed reduction, the merge's tie and ``valid`` rules, the sharded
index's reliability options on one rank, and the architecture guard (no
module of the port but ``core/parallel.py`` calls a collective). The
multi-rank equivalences run in ``tests/test_torch_parallel_ranks.py``.
"""
import datetime
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import KMeans, KMeansConfig, StreamingKMeans
from repro_torch.core import parallel as par
from repro_torch.core.parallel import ParallelContext

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A gloo world of one rank for this module, destroyed at its end (the
    worker runs other files afterwards)."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _mesh(shape=(1, 1), axes=("data", "model")):
    return par.build_mesh(shape, axes, device_type="cpu")


class _Shape(dict):
    """A mesh shape both packages read: by name (JAX) or by dim (port)."""

    def __getitem__(self, key):
        if isinstance(key, int):
            key = list(self)[key]
        return dict.__getitem__(self, key)


class _StubMesh:
    """Shape and names only: enough for the shard counts and byte models."""

    def __init__(self, **sizes):
        self.shape = _Shape(sizes)
        self.axis_names = self.mesh_dim_names = tuple(sizes)


# --- mesh helpers and validation ---------------------------------------------

def test_parse_mesh_flag_and_build_mesh(world):
    m = par.parse_mesh_flag("1x1", device_type="cpu")
    assert m.mesh_dim_names == ("data", "model") and tuple(m.shape) == (1, 1)
    m = par.parse_mesh_flag("1", device_type="cpu")
    assert tuple(m.shape) == (1, 1)
    for bad in ("2x2x2", "0x1", "1x0"):
        with pytest.raises(ValueError, match="--mesh"):
            par.parse_mesh_flag(bad, device_type="cpu")
    with pytest.raises(ValueError, match="ranks"):   # 8 ranks, world of 1
        par.parse_mesh_flag("1x8", device_type="cpu")
    with pytest.raises(ValueError, match="disagree"):
        par.build_mesh((1, 1), ("data",), device_type="cpu")
    with pytest.raises(ValueError, match="ranks"):
        par.make_production_mesh(device_type="cpu")
    m = par.make_host_mesh(4, 2, device_type="cpu")   # clamped to the world
    assert tuple(m.shape) == (1, 1)


def test_a_cuda_mesh_without_cuda_raises(world, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        par.build_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="CUDA"):
        par.parse_mesh_flag("1x1")


def test_a_backend_other_than_the_worlds_raises(world):
    with pytest.raises(ValueError, match="gloo"):
        par.build_mesh((1, 1), ("data", "model"), device_type="cpu",
                       backend="nccl")


def test_for_mesh_resolves_logical_axes(world):
    p = ParallelContext.for_mesh(_mesh())
    assert p.data_axes == ("data",) and p.k_axis is None   # size-1 cells
    p = ParallelContext.for_mesh(_mesh((1, 1, 1), ("pod", "data", "model")))
    assert p.data_axes == ("pod", "data") and p.k_axis is None
    p = ParallelContext.for_mesh(_StubMesh(data=2, model=4))
    assert p.data_axes == ("data",) and p.k_axis == "model"
    assert p.n_data_shards == 2 and p.n_k_shards == 4
    from repro.core.parallel import ParallelContext as JPC
    for sizes in ({"data": 2, "model": 4}, {"data": 8, "model": 1},
                  {"pod": 2, "data": 2, "model": 2}):
        jp = JPC.for_mesh(_StubMesh(**sizes))
        tp = ParallelContext.for_mesh(_StubMesh(**sizes))
        assert (tp.data_axes, tp.k_axis, tp.n_data_shards, tp.n_k_shards) \
            == (jp.data_axes, jp.k_axis, jp.n_data_shards, jp.n_k_shards)


@pytest.mark.parametrize("kw,match", [
    (dict(data_axes=("rows",)), "data_axes"),
    (dict(data_axes=()), "data_axes"),
    (dict(k_axis="cells"), "k_axis"),
    (dict(data_axes=("data", "model"), k_axis="model"), "overlaps")])
def test_validation_errors(world, kw, match):
    with pytest.raises(ValueError, match=match):
        ParallelContext(_mesh(), **kw)


def test_k_local_and_the_k_sharded_fit_need_k_to_divide(world):
    p = ParallelContext(_StubMesh(data=1, model=4), k_axis="model")
    assert p.k_local(16) == 4
    with pytest.raises(ValueError, match="divide"):
        p.k_local(10)
    with pytest.raises(ValueError, match="divide"):
        p.make_kmeans_fit(KMeansConfig(k=10))
    with pytest.raises(NotImplementedError, match="K-sharding"):
        p.make_kmeans_fit(KMeansConfig(k=16), compress_pod_axis="data")


# --- the collective-bytes models ---------------------------------------------

GRID = [dict(data=1, model=1), dict(data=2, model=4), dict(data=4, model=2),
        dict(data=8, model=1), dict(data=1, model=8)]


@pytest.mark.parametrize("sizes", GRID, ids=lambda s: f"{s['data']}x"
                         f"{s['model']}")
def test_collective_bytes_match_the_reference(sizes):
    from repro.core.parallel import ParallelContext as JPC
    mesh = _StubMesh(**sizes)
    jp, tp = JPC.for_mesh(mesh), ParallelContext.for_mesh(mesh)
    for k, d, n_local, b, l in [(1024, 128, 4096, 256, 16),
                                (65536, 512, 262144, 1, 1), (16, 8, 3, 7, 5)]:
        for op in ("stats_psum", "assign_merge", "topl_merge"):
            kw = dict(k=k, d=d, n_local=n_local, b=b, l=l)
            assert tp.collective_bytes(op, **kw) == jp.collective_bytes(
                op, **kw)
        for nprobe, topk in [(16, 10), (1, 1), (k, 10)]:
            assert tp.search_collective_bytes(b, nprobe, topk, k, cap=64,
                                              d=d) == \
                jp.search_collective_bytes(b, nprobe, topk, k, cap=64, d=d)
    with pytest.raises(ValueError, match="unknown"):
        tp.collective_bytes("gather")


def test_search_bytes_model_matches_the_reference():
    from repro.core.parallel import search_collective_bytes_model as jm
    for b in (1, 256):
        for nprobe in (1, 16, 64):
            for topk in (1, 10):
                for k in (64, 1024):
                    for p_k in (1, 2, 4, 64, 128):
                        assert par.search_collective_bytes_model(
                            b, nprobe, topk, k, p_k) == jm(b, nprobe, topk,
                                                           k, p_k)


def test_a_single_device_index_reports_zero_bytes(world):
    from repro_torch.index import IVFIndex
    x = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    assert IVFIndex(x[:4], 8, device="cpu").search_collective_bytes(
        256, 10, 4) == 0
    data_only = ParallelContext.for_mesh(_mesh())
    idx = IVFIndex(x[:4], 8, pctx=data_only)
    idx.add(x)
    assert idx.search_collective_bytes(256, 10, 4) == 0


# --- the int8 codec of the compressed reduction ------------------------------

@pytest.mark.parametrize("shape,scale", [((16, 8), 1.0), ((3, 100), 1e4),
                                         ((256,), 1e-3), ((1024, 3), 7.0),
                                         ((5,), 0.0)])
def test_int8_codec_bit_for_bit(shape, scale):
    from repro.optim import compression as jc
    from repro_torch.optim import compression as tc
    x = (np.random.default_rng(sum(shape)).standard_normal(shape)
         * scale).astype(np.float32)
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = tc.quantize_int8(torch.from_numpy(x))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    jd = jc.dequantize_int8(jq, js, shape)
    td = tc.dequantize_int8(tq, ts, shape)
    assert np.array_equal(td.numpy(), np.asarray(jd))


def test_ef_allreduce_on_one_rank_is_the_dequantized_input(world):
    from repro_torch.optim import compression as tc
    p = ParallelContext.for_mesh(_mesh())
    x = torch.randn(16, 8, generator=torch.Generator().manual_seed(1))
    err = torch.zeros(16, 8)
    total, new_err = tc.ef_quantized_allreduce(x, err, "data", pctx=p)
    q, s = tc.quantize_int8(x)
    assert torch.equal(total, tc.dequantize_int8(q, s, x.shape))
    assert torch.equal(new_err, x - total)


# --- merge_topl --------------------------------------------------------------

class _Peers(ParallelContext):
    """Two cell ranks played in one process: ``all_gather`` returns this
    rank's tensor stacked with the next scripted peer tensor."""

    def __init__(self, peers):
        super().__init__(_StubMesh(data=1, model=2), k_axis="model")
        self.peers = list(peers)

    def all_gather(self, t, axis):
        return torch.stack([t, self.peers.pop(0)])


def test_merge_topl_breaks_equal_values_toward_the_lower_rank():
    idx0 = torch.tensor([[3, 9]])
    val0 = torch.tensor([[1.0, 2.0]])
    p = _Peers([torch.tensor([[1.0, 2.0]]), torch.tensor([[20, 30]])])
    ids, vals = p.merge_topl(idx0, val0, 3)
    assert ids.tolist() == [[3, 20, 9]] and vals.tolist() == [[1, 1, 2]]


def test_merge_topl_with_tie_breaks_toward_the_lower_key():
    idx0, val0 = torch.tensor([[3, 9]]), torch.tensor([[1.0, 2.0]])
    tie0 = torch.tensor([[7, 1]])
    p = _Peers([torch.tensor([[1.0, 2.0]]), torch.tensor([[20, 30]]),
                torch.tensor([[5, 0]])])
    ids, vals = p.merge_topl(idx0, val0, 4, tie=tie0)
    assert ids.tolist() == [[20, 3, 30, 9]]
    assert vals.tolist() == [[1, 1, 2, 2]]


def test_merge_topl_valid_blanks_this_rank_and_pads_a_short_pool():
    idx0, val0 = torch.tensor([[3]]), torch.tensor([[0.5]])
    p = _Peers([torch.tensor([[4.0]]), torch.tensor([[11]])])
    ids, vals = p.merge_topl(idx0, val0, 3, valid=False)
    assert ids.tolist() == [[11, -1, -1]]
    assert vals[0, 0] == 4.0 and torch.isinf(vals[0, 1:]).all()
    p = _Peers([torch.tensor([[4.0]]), torch.tensor([[11]])])
    ids, _ = p.merge_topl(idx0, val0, 3, valid=torch.tensor(True))
    assert ids.tolist() == [[3, 11, -1]]


def test_merge_topl_without_a_cells_axis_cuts_the_local_list(world):
    p = ParallelContext.for_mesh(_mesh())
    ids, vals = p.merge_topl(torch.tensor([[1, 2, 3]]),
                             torch.tensor([[0.1, 0.2, 0.3]]), 2)
    assert ids.tolist() == [[1, 2]] and vals.shape == (1, 2)


# --- one rank: the programs equal the single-device ones ---------------------

def test_one_rank_fit_is_the_single_device_fit_bit_for_bit(world):
    x = torch.randn(999, 8, generator=torch.Generator().manual_seed(2))
    cfg = KMeansConfig(k=16, max_iters=7)
    c0 = x[:16].clone()
    st = KMeans(cfg, device="cpu").fit(x, c0=c0)
    r = ParallelContext.for_mesh(_mesh()).make_kmeans_fit(cfg)(x, c0)
    assert torch.equal(r.centroids, st.centroids)
    assert torch.equal(r.assignments, st.assignments)
    assert r.iterations == int(st.iteration) and torch.equal(r.inertia,
                                                             st.inertia)
    # one cells shard: the two-stage path; the first ids are bit for bit
    pk = ParallelContext(_mesh(), k_axis="model")
    a, _ = pk.make_assign(cfg)(x, c0)
    assert torch.equal(a, KMeans(cfg, device="cpu").iterate(x, c0)[1])
    r1 = pk.make_kmeans_fit(cfg)(x, c0)
    torch.testing.assert_close(r1.centroids, st.centroids, rtol=1e-5,
                               atol=1e-5)


def test_streaming_rejects_a_k_sharded_context(world):
    pk = ParallelContext(_mesh(), k_axis="model")
    with pytest.raises(ValueError, match="data-parallel"):
        StreamingKMeans(KMeansConfig(k=4), pctx=pk)
    sk = StreamingKMeans(KMeansConfig(k=4), pctx=ParallelContext.for_mesh(
        _mesh()))
    assert sk.device.type == "cpu"


# --- the sharded index's reliability (ported from queue A item 6b) -----------

def test_the_sharded_index_refuses_what_6b_ports(world, tmp_path):
    """Over each of its four kinds (padded, paged, q8, two-level) the
    options that raised until queue A item 6b was ported now work on a
    K-sharded index: the guarded and repairing refresh, snapshots and
    restores onto the mesh, the engine's policy and snapshots, recovery
    onto the mesh, and faults (a ``dead_shard`` of its one K-shard blanks
    every merge: honest ``(-1, 0.0)`` rows, then the next call heals).
    The multi-rank checks run in tests/test_torch_parallel_reliability.py."""
    from repro_torch.index import IVFIndex
    from repro_torch.reliability import (FaultEvent, FaultInjector,
                                         FaultPlan, HealthPolicy)
    from repro_torch.serve import SearchConfig, SearchEngine
    pk = ParallelContext(_mesh(), k_axis="model")
    x = torch.randn(64, 4, generator=torch.Generator().manual_seed(3))
    for i, kw in enumerate((dict(), dict(store="paged"), dict(codec="q8"),
                            dict(router="two_level"))):
        snap = str(tmp_path / f"kind{i}")
        idx = IVFIndex(x[:4], 8, pctx=pk, **kw)
        idx.add(x)
        for rkw in (dict(guard=True), dict(repair_dead=True)):
            idx.refresh(**rkw)
        assert idx.repaired_cells == 0 and idx.reseeded_cells == 0
        want = idx.search(x[:3], topk=2, nprobe=2)
        idx.save(snap)
        back = IVFIndex.load(snap, pctx=pk)
        assert back.pctx is pk and back.store.kind == idx.store.kind
        got = back.search(x[:3], topk=2, nprobe=2)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        eng = SearchEngine(idx, SearchConfig(topk=2, nprobe=2, query_batch=4,
                                             snapshot_dir=snap),
                           health=HealthPolicy())
        assert eng._lkg is not None and eng._lkg.pctx is pk
        assert torch.equal(eng.search(x[:3])[0], want[0])
        eng.add(x[:8])
        eng.snapshot()
        rec = SearchEngine.recover(snap, SearchConfig(topk=2, nprobe=2,
                                                      query_batch=4),
                                   pctx=pk)
        assert rec.index.pctx is pk and len(rec.index) == 72
        assert torch.equal(rec.search(x[:3])[0], eng.search(x[:3])[0])
        idx.faults = FaultInjector(FaultPlan(
            [FaultEvent("search", "dead_shard", 0, arg=0)]))
        ids, dists = idx.search(x[:2], topk=2, nprobe=2)
        assert (ids == -1).all() and bool(torch.isfinite(dists).all())
        assert torch.equal(idx.search(x[:3], topk=2, nprobe=2)[0],
                           rec.index.search(x[:3], topk=2, nprobe=2)[0])
        idx.faults = None


# --- the padded store over a mesh ---------------------------------------------

def _owner(rank, shards=2):
    """What ``place`` reads of a context: the cells axis, this rank's shard
    and the owned cell count."""
    from types import SimpleNamespace
    return SimpleNamespace(k_axis="model", k_rank=rank,
                           k_local=lambda k: k // shards)


def test_a_placed_store_holds_its_own_cells_and_the_global_bookkeeping():
    from repro_torch.index.store import PaddedBucketStore
    k, d = 8, 4
    rng = np.random.default_rng(5)
    whole = PaddedBucketStore(k, d, torch.float32, capacity=8, max_cap=32)
    parts = [PaddedBucketStore(k, d, torch.float32, capacity=8, max_cap=32)
             for _ in range(2)]
    for r, st in enumerate(parts):
        st.place(_owner(r))
        st.place(_owner(r))   # idempotent
        assert st.buckets.shape == (4, 8, d) and st.k_owned == 4
    with pytest.raises(ValueError, match="another shard"):
        parts[0].place(_owner(1))
    n_total = 0
    for n in (5, 40, 70):   # the second batch grows cap, the third spills
        cells = np.sort(rng.integers(0, k, n) if n != 70 else
                        np.full(n, 6))
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
        ids = np.arange(n_total, n_total + n, dtype=np.int32)
        n_total += n
        for st in (whole, *parts):
            st.append(cells, x, ids)
    for r, st in enumerate(parts):
        own = slice(4 * r, 4 * r + 4)
        assert st.cap == whole.cap and st.spilled == whole.spilled > 0
        assert torch.equal(st.counts, whole.counts)
        assert torch.equal(st.buckets, whole.buckets[own])
        assert torch.equal(st.bucket_ids, whole.bucket_ids[own])
        view = st.scan_view()
        assert view.counts.tolist() == whole.counts[own].tolist() + [0]
        assert view.rows.shape[0] == 4 and view.table is None
        assert st.resident_bytes() * 2 == whole.resident_bytes()
        assert st.shard_specs("model") == (("model", None, None),
                                           ("model", None))


@pytest.mark.parametrize("width", [8, 16])
def test_gather_cells_matches_the_reference(width):
    """The shard-local gather (ref. ``index/store.py:189``): local cells,
    the owned count being the padding cell."""
    from repro.index import store as jstore
    from repro.index.store import _PAD_COORD
    from repro_torch.index import store as tstore
    rng = np.random.default_rng(width)
    kl, cap, d = 4, 16, 3
    buckets = rng.standard_normal((kl, cap, d)).astype(np.float32)
    ids = rng.integers(0, 100, (kl, cap)).astype(np.int32)
    buckets[:, 10:] = _PAD_COORD
    ids[:, 10:] = -1
    cell = rng.integers(0, kl + 1, (5, 3)).astype(np.int32)
    jx, ji = jstore.gather_cells("padded", (jnp.asarray(buckets),
                                            jnp.asarray(ids)),
                                 jnp.asarray(cell), width, 0)
    tx, ti = tstore.gather_cells("padded", (torch.from_numpy(buckets),
                                            torch.from_numpy(ids)),
                                 torch.from_numpy(cell), width)
    assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    # the quantized gather (item 6b; the paged kinds: test_torch_sharded_
    # store.py): zero codes and scales, id -1 on the padding cell
    codes = np.clip(buckets * 20, -127, 127).astype(np.int8)
    aux = np.where(ids >= 0, 0.5, 0.0).astype(np.float32)
    jq = jstore.gather_cells_q8("padded", (jnp.asarray(codes),
                                           jnp.asarray(ids), jnp.asarray(aux)),
                                jnp.asarray(cell), width, 0)
    tq = tstore.gather_cells_q8("padded", (torch.from_numpy(codes),
                                           torch.from_numpy(ids),
                                           torch.from_numpy(aux)),
                                torch.from_numpy(cell), width)
    for j, t in zip(jq, tq):
        assert np.array_equal(t.numpy(), np.asarray(j))


# --- the architecture guard --------------------------------------------------

_BARE = (r"(?:all_reduce\w*|all_gather\w*|reduce_scatter\w*|all_to_all\w*|"
         r"broadcast_object_list|barrier|isend|irecv|new_group|"
         r"init_process_group)")
_QUALIFIED = rf"(?:{_BARE[3:-1]}|broadcast|reduce|scatter|gather|send|recv)"
_COLLECTIVE = re.compile(
    # importing torch.distributed at all
    r"(?:^|[^\w.])(?:import\s+torch\.distributed|from\s+torch\.distributed"
    r"|from\s+torch\s+import\s+distributed)"
    # a collective called by its bare (imported) name
    rf"|(?:^|[^\w.]){_BARE}\s*\("
    # or through torch.distributed under one of its usual names
    rf"|\b(?:dist|torch\.distributed|funcol|c10d)\.(?:\w+\.)*"
    rf"{_QUALIFIED}\w*\s*\("
    # DTensor's local views and placements
    r"|\.(?:to_local|from_local)\s*\(|\b(?:local_map|distribute_tensor|"
    r"distribute_module)\s*\(")


def test_no_collective_call_sites_outside_parallel():
    """The port's counterpart of ``test_zero_shard_map_call_sites_outside_
    parallel`` (tests/distributed/test_parallel.py:51): only
    ``core/parallel.py`` and ``utils/sharding.py`` (the LM path's DTensor
    redistributions) import ``torch.distributed`` or call a collective,
    ``to_local``, ``from_local``, ``local_map`` or ``distribute_tensor``;
    every other module goes through the ``ParallelContext``'s methods or
    ``utils.sharding``'s."""
    offenders = []
    for path in sorted(SRC.rglob("*.py")):
        rel = path.relative_to(SRC).as_posix()
        if rel in ("core/parallel.py", "utils/sharding.py"):
            continue
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0]
            if _COLLECTIVE.search(code):
                offenders.append(f"{rel}:{lineno}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
    assert _COLLECTIVE.search((SRC / "core" / "parallel.py").read_text())
    assert _COLLECTIVE.search((SRC / "utils" / "sharding.py").read_text())


def test_the_guard_catches_each_form():
    for line in ("import torch.distributed as dist",
                 "from torch.distributed import all_reduce",
                 "from torch import distributed",
                 "dist.all_reduce(t, group=g)", "dist.broadcast(t, 0)",
                 "x = t.to_local()", "DTensor.from_local(t, mesh, p)",
                 "local_map(f, out_placements)", "distribute_tensor(t, m, p)",
                 "torch.distributed.all_gather(out, t)",
                 "all_reduce(t)", "dist.new_group([0, 1])",
                 "dist.gather(t, lst, 0)", "dist.send(t, 1)",
                 "funcol.all_gather_tensor(t, 0, g)"):
        assert _COLLECTIVE.search(line), line
    for line in ("pctx.psum(s)", "pctx.all_gather(q, axis)",
                 "self.pctx.gather(t, spec)", "pctx.merge_topl(i, v, 4)",
                 "dist.sum(-1)", "torch.gather(v, 1, pos)",
                 "def gather_cells(kind, arrays):", "store.gather_global(k)"):
        assert not _COLLECTIVE.search(line), line
