"""One rank of the port's parallel-layer checks on the CPU (gloo).

    PYTHONPATH=src python tests/_torch_parallel_worker.py RANK WORLD STORE \
        OUT [axes|reliability|ef_tree]

Run WORLD copies at once (``tests/test_torch_parallel_ranks.py`` starts 4;
with ``axes``, ``tests/test_torch_parallel_axes.py`` starts 4 that drive the
sharded index's other axes instead, ``axes()``; with ``reliability``,
``tests/test_torch_parallel_reliability.py`` starts 4 that drive the sharded
index's faults, refresh repairs, snapshots and engine, ``reliability()``;
with ``ef_tree``, ``tests/test_torch_train_ef_tree.py`` starts 4 that
reduce a gradient tree with error feedback, ``ef_tree()``):
each rendezvouses through the ``FileStore`` at STORE, builds the meshes of
the cases below, drives the port's multi-rank programs on the same global
inputs (``inputs()``, made from numpy seeds) and writes what it got to
``OUT/rank<RANK>.npz``. It imports ``repro_torch`` only; the test process
holds the results against the JAX package's single-device functions.
"""
from __future__ import annotations

import datetime
import os
import sys

import numpy as np

K, D, N = 16, 8, 1024


def blobs(seed: int, n: int, k: int = K, d: int = D, spread: float = 5.0,
          noise: float = 0.3):
    rng = np.random.default_rng(seed)
    centers = (rng.standard_normal((k, d)) * spread).astype(np.float32)
    lab = rng.integers(0, k, n)
    x = centers[lab] + noise * rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32), centers


def inputs() -> dict:
    """The global inputs every rank and the test process share."""
    x, centers = blobs(0, N)
    rng = np.random.default_rng(1)
    out = {
        "x": x, "centers": centers,
        "c_assign": (rng.standard_normal((K, D)) * 3.0).astype(np.float32),
        "x_assign": rng.standard_normal((512, D)).astype(np.float32),
        "c0": x[rng.choice(N, K, replace=False)].copy(),
        "x_ragged": x[:1021].copy(),
        "q": x[rng.integers(0, N, 64)].copy(),
        "q_ragged": x[rng.integers(0, N, 63)].copy(),
        "x2": x[rng.integers(0, N, 257)] + np.float32(0.05),
        "stream": [blobs(3 + i, n)[0] for i, n in
                   enumerate((100, 257, 63, 300))],
        "ef_x": [(rng.standard_normal((K, D)) * 10.0 ** p).astype(np.float32)
                 for p in range(4)],
        "tie_centers": np.array([[0.0, 0.0], [6.0, 0.0]], np.float32),
        "tie_pts": np.array([[3.0, 0.0], [7.0, 0.0]], np.float32),
        "tie_q": np.array([[5.0, 0.0]], np.float32),
    }
    # a two-level router over the blob centres: 4 groups, each fine cell in
    # the group of its nearest coarse centre
    coarse = centers[[0, 5, 10, 15]].copy()
    out["coarse"] = coarse
    out["owner"] = ((centers[:, None] - coarse[None]) ** 2).sum(-1).argmin(
        1).astype(np.int32)
    return out


# the sharded indexes of ``axes()``: name -> IVFIndex keywords
AXES = {
    "paged": dict(store="paged", page_size=8),
    "q8": dict(codec="q8"),
    "q8_host": dict(codec="q8", rescore="host"),
    "q8_paged": dict(codec="q8", store="paged", page_size=8),
    "q8_paged_host": dict(codec="q8", store="paged", page_size=8,
                          rescore="host"),
    "routed": dict(router="two_level"),
    "routed_q8": dict(router="two_level", codec="q8", store="paged",
                      page_size=8),
}


def axes(rank: int, world: int, store: str, out: str) -> None:
    """The sharded index's other axes on a 2x2 mesh: paged, q8 (padded and
    paged, device cache and host oracle) and two-level, each built over
    the blob centres, then an add, searches at nprobe 4 and K, a second add
    and a refresh, and the searches again. The same index on one device
    runs beside it (``one/...``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.parallel import ParallelContext, build_mesh
    from repro_torch.index import IVFIndex
    from repro_torch.index.router import TwoLevelRouter

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    inp = inputs()
    t = {k: torch.from_numpy(v) for k, v in inp.items()
         if isinstance(v, np.ndarray)}
    res: dict[str, np.ndarray] = {}
    pctx = ParallelContext.for_mesh(build_mesh((2, 2), ("data", "model"),
                                               device_type="cpu"))
    for name, kw in AXES.items():
        for tag, ctx in ((name, pctx), (f"one/{name}", None)):
            if "router" in kw:
                kw = dict(kw, router=TwoLevelRouter(
                    inp["coarse"], inp["owner"], nprobe_c=2, device="cpu"))
            idx = IVFIndex(t["centers"], 128, pctx=ctx, device="cpu", **kw)
            res[f"{tag}/add"] = idx.add(t["x"]).numpy()
            for npb in (4, K):
                ids, d = idx.search(t["q"], topk=10, nprobe=npb)
                res[f"{tag}/search{npb}/ids"] = ids.numpy()
                res[f"{tag}/search{npb}/dists"] = d.numpy()
            idx.add(t["x2"])
            idx.refresh()
            for npb in (4, K):
                ids, d = idx.search(t["q_ragged"], topk=10, nprobe=npb)
                res[f"{tag}/after{npb}/ids"] = ids.numpy()
                res[f"{tag}/after{npb}/dists"] = d.numpy()
            res[f"{tag}/counts"] = idx.counts.numpy()
            res[f"{tag}/lists"] = idx.posting_lists()[0].numpy()
            res[f"{tag}/bytes"] = np.array(idx.search_collective_bytes(
                64, 10, 4))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


# the sharded indexes of ``reliability()``'s snapshot round trips: name ->
# IVFIndex keywords (the two-level router made from ``inputs()``)
SNAP_KINDS = {
    "padded": dict(),
    "paged": dict(store="paged", page_size=8),
    "q8": dict(codec="q8"),
    "q8_paged_routed": dict(codec="q8", store="paged", page_size=8,
                            router="two_level"),
}
MESHES = ((2, 2), (1, 4), (4, 1))
NAN_SEED, DEAD_SHARD = 9, 1
ENGINE = dict(topk=10, nprobe=4, query_batch=64, refresh_every=2)
CHAOS_SEED, CHAOS_UNITS = 7, 16


def dead_low_corpus() -> np.ndarray:
    """Rows only in cells 0..K/2-1 (the blob centres' lower half): on a 2x2
    mesh the last K-shard owns only dead cells (ref.
    tests/distributed/_parallel_worker.py:146-167)."""
    inp = inputs()
    rng = np.random.default_rng(5)
    lab = rng.integers(0, K // 2, N)
    return (inp["centers"][lab] + 0.4 * rng.standard_normal(
        (N, D))).astype(np.float32)


def index_kw(name: str, inp: dict, device: str = "cpu") -> dict:
    """``SNAP_KINDS[name]`` with its router built (the same on every rank
    and in the test's JAX index)."""
    kw = dict(SNAP_KINDS[name])
    if "router" in kw:
        from repro_torch.index.router import TwoLevelRouter
        kw["router"] = TwoLevelRouter(inp["coarse"], inp["owner"],
                                      nprobe_c=2, device=device)
    return kw


def reliability(rank: int, world: int, store: str, out: str) -> None:
    """The sharded index under faults, repairs and restores on a 2x2 mesh
    (2 data x 2 cell shards), and the engine over it; snapshots written by
    the test's JAX package (``OUT/jax_<kind>``) restored onto 2x2, 1x4, 4x1
    and no mesh. Every case writes its results under its name; the test
    holds them to the JAX package on one device."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.parallel import ParallelContext, build_mesh
    from repro_torch.index import IVFIndex
    from repro_torch.reliability import (FaultEvent, FaultInjector,
                                         FaultPlan, HealthPolicy)
    from repro_torch.serve import SearchConfig, SearchEngine
    from repro_torch.serve.engine import RanksDiverged

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    inp = inputs()
    t = {k: torch.from_numpy(v) for k, v in inp.items()
         if isinstance(v, np.ndarray)}
    res: dict[str, np.ndarray] = {}
    ctx = {shape: ParallelContext.for_mesh(build_mesh(
        shape, ("data", "model"), device_type="cpu")) for shape in MESHES}
    pctx = ctx[(2, 2)]

    def keep(tag, *arrays):
        for i, a in enumerate(arrays):
            res[f"{tag}/{i}"] = np.asarray(
                a.detach().cpu().numpy() if torch.is_tensor(a) else a)

    def searches(tag, idx):
        for npb in (4, K):
            keep(f"{tag}/search{npb}", *idx.search(t["q"], topk=10,
                                                   nprobe=npb))

    # the world's agreement: one rank's failure is every rank's; a write
    # rank 0 fails raises on every rank, one it makes is seen by every rank
    res["world/agree"] = np.array([pctx.agree(rank != 2), pctx.agree(True),
                                   pctx.agree(False)])
    res["world/all_ok"] = np.array([pctx.all_ok(rank != 2),
                                    pctx.all_ok(True)])
    res["world/rank0"] = np.array(pctx.is_world_rank0 == (rank == 0))

    def disk_full():
        raise OSError("no space left on device")
    try:
        pctx.rank0_write(disk_full)
        res["world/failed_write_raised"] = np.array(False)
    except OSError:
        res["world/failed_write_raised"] = np.array(True)
    marker = os.path.join(out, "rank0_wrote")
    pctx.rank0_write(lambda: open(marker, "w").close())
    res["world/write_seen"] = np.array(os.path.exists(marker))
    # (i) dead_shard: blanked out of every merge, healed on the next call
    for name in ("padded", "paged", "q8"):
        idx = IVFIndex(t["centers"], 128, pctx=pctx, **index_kw(name, inp))
        idx.add(t["x"])
        idx.faults = FaultInjector(FaultPlan(
            [FaultEvent("search", "dead_shard", 0, arg=DEAD_SHARD)]))
        keep(f"dead/{name}", *idx.search(t["q"], topk=10, nprobe=K))
        keep(f"dead/{name}/healed", *idx.search(t["q"], topk=10, nprobe=K))
        idx.faults = None
        keep(f"dead/{name}/healthy", *idx.search(t["q"], topk=10, nprobe=K))
    # a data-only mesh has no shard to lose: the event is a search error
    flat = IVFIndex(t["centers"], 128, pctx=ctx[(4, 1)])
    flat.add(t["x"])
    flat.faults = FaultInjector(FaultPlan(
        [FaultEvent("search", "dead_shard", 0, arg=0)]))
    try:
        flat.search(t["q"], topk=10, nprobe=4)
        res["dead/data_only_raised"] = np.array(False)
    except RuntimeError as e:
        res["dead/data_only_raised"] = np.array(
            type(e).__name__ == "InjectedFault")
    # (ii) nan_stats on an add, then the guarded refresh
    idx = IVFIndex(t["centers"], 128, pctx=pctx)
    idx.add(t["x"])
    idx.faults = FaultInjector(FaultPlan(
        [FaultEvent("add", "nan_stats", 0, arg=NAN_SEED)]))
    idx.add(t["x2"])
    idx.faults = None
    res["nan/pending_nan"] = np.array(bool(torch.isnan(
        idx._pending.sums).any()))
    idx.refresh(guard=True)
    keep("nan", idx.global_centroids(), idx.repaired_cells)
    searches("nan", idx)
    # (iii) the dead cells' repair: the last K-shard owns only dead cells
    idx = IVFIndex(t["centers"], 256, pctx=pctx)
    idx.add(torch.from_numpy(dead_low_corpus()))
    idx.refresh(repair_dead=True)
    keep("repair", idx.global_centroids(), idx.reseeded_cells)
    # (iv) snapshots: the port's 2x2 snapshot of each kind (read by the
    # test's JAX package) and its restores onto the other meshes and none;
    # the JAX package's snapshot restored onto every mesh and none
    for name in SNAP_KINDS:
        idx = IVFIndex(t["centers"], 128, pctx=pctx, **index_kw(name, inp))
        idx.add(t["x"])
        idx.add(t["x2"])
        idx.refresh()
        searches(f"snap/{name}/live", idx)
        idx.save(os.path.join(out, f"port_{name}"), seqno=3)
        for src in ("port", "jax"):
            d = os.path.join(out, f"{src}_{name}")
            for shape in MESHES:
                back = IVFIndex.load(d, pctx=ctx[shape])
                searches(f"snap/{name}/{src}/{shape[0]}x{shape[1]}", back)
            back = IVFIndex.load(d, device="cpu")
            searches(f"snap/{name}/{src}/none", back)
            del back
    # (v) the engine over the mesh: a durability run dropped after its
    # third add and recovered onto the same mesh, beside an uninterrupted
    # twin; then seeded chaos under the policy
    sdir = os.path.join(out, "engine")
    stream = [torch.from_numpy(b) for b in inp["stream"]]
    pol = HealthPolicy(backoff_s=0.0)
    eng = SearchEngine(IVFIndex(t["centers"], 128, pctx=pctx),
                       SearchConfig(**ENGINE, snapshot_dir=sdir,
                                    snapshot_every=2), health=pol)
    twin = SearchEngine(IVFIndex(t["centers"], 128, pctx=pctx),
                        SearchConfig(**ENGINE), health=pol)
    for b in stream[:3]:
        eng.add(b)
        eng.search(t["q"])
    del eng
    back = SearchEngine.recover(sdir, SearchConfig(**ENGINE,
                                                   snapshot_every=2),
                                health=pol, pctx=pctx)
    res["engine/replayed"] = np.array(back.counters.wal_records_replayed)
    back.add(stream[3])
    for b in stream:
        twin.add(b)
    keep("engine/recovered", *back.search(t["q"]))
    keep("engine/twin", *twin.search(t["q"]))
    idx = IVFIndex(t["centers"], 128, pctx=pctx)
    idx.add(t["x"])
    ce = SearchEngine(idx, SearchConfig(**ENGINE), health=pol,
                      faults=FaultInjector(FaultPlan.seeded(CHAOS_SEED)))
    finite = True
    for u in range(CHAOS_UNITS):
        if u % 3 == 0:
            ce.add(stream[u // 3 % len(stream)])
        _, dd = ce.search(t["q"])
        finite &= bool(torch.isfinite(dd).all())
    res["chaos/finite"] = np.array(finite)
    res["chaos/counters"] = np.array(list(ce.counters.as_dict().values()))
    res["chaos/fired"] = np.array([e.kind for e in idx.faults.fired])
    # an add that changed every rank's shard but failed on rank 2 after its
    # collectives: the shards differ, so every rank raises RanksDiverged
    # and none parks the batch
    idx = IVFIndex(t["centers"], 128, pctx=pctx)
    de = SearchEngine(idx, SearchConfig(**ENGINE), health=pol)
    if rank == 2:
        real_add = idx.add

        def add_then_fail(x):
            real_add(x)
            raise RuntimeError("rank 2's add failed after it applied")
        idx.add = add_then_fail
    try:
        de.add(stream[0])
        diverged = False
    except RanksDiverged:
        diverged = True
    res["engine/diverged"] = np.array([diverged, len(de._pending_adds),
                                       de.counters.adds_requeued])
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


def ef_tree(rank: int, world: int, store: str, out: str) -> None:
    """``optim.compression.ef_tree_allreduce`` over the ``pod`` axis of a
    2x2x1 ``pod x data x model`` mesh: a tree of three leaves (a dict in a
    dict), each rank's own scaled copy of ``tree_inputs()``, three rounds
    with the residuals fed back."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.parallel import ParallelContext, build_mesh
    from repro_torch.optim import compression

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    pctx = ParallelContext.for_mesh(build_mesh(
        (2, 2, 1), ("pod", "data", "model"), device_type="cpu"))
    scale = 1.0 + pctx.axis_rank("pod") + 10.0 * pctx.axis_rank("data")
    res = {"pod": np.array(pctx.axis_rank("pod")),
           "data": np.array(pctx.axis_rank("data"))}
    err = None
    for i, tree in enumerate(tree_inputs()):
        x = {"a": torch.from_numpy(tree["a"]) * scale,
             "b": {"c": torch.from_numpy(tree["c"]) * scale,
                   "d": torch.from_numpy(tree["d"]) * scale}}
        if err is None:
            err = compression.init_error_tree(x)
        total, new_err = compression.ef_tree_allreduce(x, err, "pod",
                                                       pctx=pctx)
        for name, get in (("a", lambda t: t["a"]),
                          ("c", lambda t: t["b"]["c"]),
                          ("d", lambda t: t["b"]["d"])):
            res[f"{i}/{name}/x"] = get(x).numpy()
            res[f"{i}/{name}/err"] = get(err).numpy()
            res[f"{i}/{name}/total"] = get(total).numpy()
            res[f"{i}/{name}/new_err"] = get(new_err).numpy()
        err = new_err
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


def tree_inputs() -> list:
    """Three rounds of a small gradient tree (leaves of 256 + 1, 5 and 21
    values: a ragged last block, a leaf under one block)."""
    rng = np.random.default_rng(7)
    return [{"a": (rng.standard_normal((257,)) * 10.0 ** p).astype(np.float32),
             "c": rng.standard_normal((5,)).astype(np.float32),
             "d": rng.standard_normal((3, 7)).astype(np.float32)}
            for p in range(3)]


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.core import KMeansConfig, StreamingKMeans, SufficientStats
    from repro_torch.core.parallel import ParallelContext, build_mesh
    from repro_torch.index import IVFIndex
    from repro_torch.optim import compression

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    inp = inputs()
    t = {k: torch.from_numpy(v) for k, v in inp.items()
         if isinstance(v, np.ndarray)}
    res: dict[str, np.ndarray] = {}

    def mesh(shape, axes=("data", "model")):
        return build_mesh(shape, axes, device_type="cpu")

    def keep(tag, *arrays):
        for i, a in enumerate(arrays):
            res[f"{tag}/{i}"] = np.asarray(
                a.detach().cpu().numpy() if torch.is_tensor(a) else a)

    cfg = KMeansConfig(k=K, max_iters=50)
    # two-stage assignment at two meshes
    for shape in ((2, 2), (1, 4)):
        pctx = ParallelContext.for_mesh(mesh(shape))
        keep(f"assign/{shape[0]}x{shape[1]}",
             *pctx.make_assign(cfg)(t["x_assign"], t["c_assign"]))
    # the N- and K-sharded fits, and the ragged masked fit
    for shape in ((4, 1), (1, 4), (2, 2)):
        pctx = ParallelContext.for_mesh(mesh(shape))
        r = pctx.make_kmeans_fit(cfg)(t["x"], t["c0"])
        keep(f"fit/{shape[0]}x{shape[1]}", *r, r.iterations)
        x_pad, m, n = pctx.pad_points(t["x_ragged"])
        r = pctx.make_kmeans_fit(cfg, masked=True)(x_pad, m, t["c0"])
        keep(f"masked/{shape[0]}x{shape[1]}", r[0], r[1][:n], r[2],
             r.iterations)
    # the compressed fit over pods: record every error-feedback exchange
    pctx = ParallelContext.for_mesh(mesh((2, 2, 1), ("pod", "data",
                                                     "model")))
    calls = []
    ef = compression.ef_quantized_allreduce

    def recording(x, err, axis_name, *, pctx):
        total, new_err = ef(x, err, axis_name, pctx=pctx)
        calls.append((x.clone(), err.clone(), total.clone()))
        return total, new_err

    compression.ef_quantized_allreduce = recording
    try:
        r = pctx.make_kmeans_fit(KMeansConfig(k=K, max_iters=3),
                                 compress_pod_axis="pod")(t["x"], t["c0"])
        errs = [torch.zeros(K, D)]
        for xe in inp["ef_x"]:
            s, e = compression.ef_quantized_allreduce(
                torch.from_numpy(xe) * (1 + pctx.axis_rank("pod")), errs[-1],
                "pod", pctx=pctx)
            errs.append(e)
    finally:
        compression.ef_quantized_allreduce = ef
    keep("compressed/fit", *r, r.iterations)
    res["compressed/pod"] = np.array(pctx.axis_rank("pod"))
    res["compressed/data"] = np.array(pctx.axis_rank("data"))
    for i, (x, err, total) in enumerate(calls):
        keep(f"compressed/call{i}", x, err, total)
    res["compressed/ncalls"] = np.array(len(calls))
    # the data-parallel stream: make_partial_fit and StreamingKMeans
    pctx = ParallelContext.for_mesh(mesh((4, 1)))
    step = pctx.make_partial_fit(cfg, decay=0.9, local_iters=2)
    xb = torch.from_numpy(inp["stream"][1])
    x_pad, m, n = pctx.pad_points(xb)
    z = SufficientStats.zero(K, D)
    out_step = step(x_pad, m, t["c0"], *z)
    keep("partial", *out_step[:4], out_step[4][:n], out_step[5])
    sk = StreamingKMeans(cfg, decay=0.9, pctx=pctx)
    sk.centroids, sk.stats = t["c0"].clone(), SufficientStats.zero(K, D)
    for i, b in enumerate(inp["stream"]):
        sk.partial_fit(b)
        keep(f"stream/{i}", sk.centroids, *sk.stats)
    keep("stream/update", sk.update(inp["stream"][2]), sk.centroids)
    # the sharded index (ref. tests/distributed/test_parallel.py:172, :372)
    pctx = ParallelContext.for_mesh(mesh((2, 2)))
    idx = IVFIndex(t["centers"], 128, pctx=pctx)
    keep("ivf/add", idx.add(t["x"]))
    for npb in (4, K):
        keep(f"ivf/search{npb}", *idx.search(t["q"], topk=10, nprobe=npb))
    keep("ivf/ragged", *idx.search(t["q_ragged"], topk=10, nprobe=4))
    keep("ivf/add2", idx.add(t["x2"]))
    idx.refresh()
    keep("ivf/refreshed", idx.global_centroids(), idx.counts)
    for npb in (4, K):
        keep(f"ivf/after{npb}", *idx.search(t["q"], topk=10, nprobe=npb))
    keep("ivf/brute", *idx.search_brute(t["q"], topk=10))
    keep("ivf/lists", *idx.posting_lists())
    keep("ivf/bytes", idx.search_collective_bytes(64, 10, 4))
    tie = IVFIndex(t["tie_centers"], 8, pctx=pctx)
    tie.add(t["tie_pts"])
    keep("tie", *tie.search(t["tie_q"], topk=1, nprobe=2))
    # bf16 payloads, and the out-of-core build (one-device training, the
    # mesh from the inversion on)
    half = IVFIndex(t["centers"].to(torch.bfloat16), 128, pctx=pctx)
    half.add(t["x"].to(torch.bfloat16))
    keep("bf16", *half.search(t["q"].to(torch.bfloat16), topk=10, nprobe=4))
    chunked = IVFIndex.build(t["x"].numpy(), k=K, max_iters=3, chunk_size=256,
                             pctx=pctx)
    keep("chunked", chunked.global_centroids(),
         *chunked.search(t["q"], topk=10, nprobe=4))
    # a mesh of data shards only: the add is sharded, the store is whole
    data_only = ParallelContext.for_mesh(mesh((4, 1)))
    idx = IVFIndex(t["centers"], 128, pctx=data_only)
    keep("data_only/add", idx.add(t["x"]), idx.store.k_owned)
    keep("data_only", *idx.search(t["q"], topk=10, nprobe=4))
    pctx = ParallelContext.for_mesh(mesh((2, 2)))
    built = IVFIndex.build(t["x"], k=K, max_iters=3, pctx=pctx)
    keep("build", built.global_centroids(), *built.search(t["q"], topk=10,
                                                          nprobe=4),
         *built.search_brute(t["q"], topk=10))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    run = {"axes": axes, "reliability": reliability, "ef_tree": ef_tree}.get(
        (sys.argv[5:] or [""])[0], main)
    run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
