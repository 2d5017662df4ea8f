"""One rank of the port's parallel-layer checks on the CPU (gloo).

    PYTHONPATH=src python tests/_torch_parallel_worker.py RANK WORLD STORE OUT

Run WORLD copies at once (``tests/test_torch_parallel_ranks.py`` starts 4):
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
    return out


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
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
