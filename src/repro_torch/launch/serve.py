"""Serving launcher of the port: FlashIVF vector search through
``SearchEngine`` (``--mode search``), the counterpart of
``repro/launch/serve.py`` l.64-160.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode search \\
      --n 20000 --d 64 --kc 64 --queries 512 --topk 10 --nprobe 8

  # reliability: durable snapshots + WAL, the health ladder, seeded chaos
  PYTHONPATH=src python -m repro_torch.launch.serve --mode search \\
      --snapshot-dir /tmp/ivf-snap --health --chaos-seed 7

  # sharded serving: 2 data x 2 cell shards, one rank a card (NCCL)
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.serve --mode search --mesh 2x2

It builds an index over a synthetic clustered corpus (Gaussian blobs made
from ``--seed`` on the device: centres x5, noise 0.4, as the reference),
warms a ``SearchEngine``, times ``--reps`` searches of ``--queries`` rows
through it and prints build time, queries/s, recall@topk against
``search_brute`` and ``latency_stats()``. ``--device`` defaults to
``cuda``; ``--device cpu`` runs the kernels' plain versions.

``--store paged`` builds the paged store (``--page-size`` rows a page,
default 64), as the reference's flags do. ``--router two_level`` trains
the two-level router over the built centroids and prints it. ``--health``
serves under a ``HealthPolicy`` and ``--chaos-seed`` injects
``FaultPlan.seeded(seed)``; either prints the health counters.
``--snapshot-dir`` keeps snapshots and the WAL there (``--snapshot-every``
adds between automatic snapshots) and runs the reference's demo:
snapshot, drop the engine, ``recover``, and check that the restored
engine's search returns the same ids.

``--mesh DATAxCELLS`` builds and serves the index sharded over a ``DATA x
CELLS`` mesh (``core.parallel``), with any ``--store``, ``--codec`` and
``--router``: under ``torchrun`` (the
rendezvous from the environment, NCCL, one rank a card; gloo with
``--device cpu``), or without it at world size 1 for ``--mesh 1x1``. A
mesh whose size is not the world's raises ``ValueError``. Every rank builds the same corpus from ``--seed``; only
rank 0 prints, and it reports the modeled cross-rank bytes of a search
batch beside queries/s.

Not ported yet (ROADMAP.md, queue A), and refused with
``NotImplementedError``: ``--mode dense|clustered`` (items 7-8), and
``--mesh`` with ``--health``, ``--chaos-seed`` or ``--snapshot-dir`` (item
6b).
"""
from __future__ import annotations

import argparse
import time

import torch


def _not_ported(flag: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{flag} is not ported yet (ROADMAP.md, "
                               f"queue A {item})")


def _refuse_unported(args) -> None:
    if args.mode != "search":
        raise _not_ported(f"--mode {args.mode} (LM serving)", "items 7-8")
    if args.mesh is not None:
        given = [flag for flag, on in (
            ("--health", args.health),
            ("--chaos-seed", args.chaos_seed is not None),
            ("--snapshot-dir", args.snapshot_dir is not None)) if on]
        if given:
            raise _not_ported(f"--mesh with {', '.join(given)}", "item 6b")


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    if args.mesh is None:
        return _serve_search(args, None, print)
    from repro_torch.core.kmeans import resolve_device
    from repro_torch.core.parallel import (ParallelContext, parse_mesh_flag,
                                           release_world)
    dev = resolve_device(args.device)
    try:
        pctx = ParallelContext.for_mesh(parse_mesh_flag(
            args.mesh, device_type=dev.type))
        rank0 = int(pctx.mesh.get_rank()) == 0
        say = print if rank0 else (lambda *a, **k: None)
        say(f"sharded serving: {pctx.describe()}")
        return _serve_search(args, pctx, say)
    finally:
        release_world()


def _serve_search(args, pctx, say) -> dict:
    """Build, warm, serve; returns what it printed (``say``) as numbers."""
    from repro_torch.core.kmeans import resolve_device
    from repro_torch.index import IVFIndex, recall_at_k
    from repro_torch.reliability import (FaultInjector, FaultPlan,
                                         HealthPolicy)
    from repro_torch.serve import SearchConfig, SearchEngine

    dev = pctx.device if pctx is not None else resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    centers = torch.randn(args.kc, args.d, device=dev, generator=gen) * 5.0
    lbl = torch.randint(0, args.kc, (args.n,), device=dev, generator=gen)
    x = centers[lbl] + 0.4 * torch.randn(args.n, args.d, device=dev,
                                         generator=gen)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    t0 = time.perf_counter()
    rescore_mult = ("auto" if args.rescore_mult == "auto"
                    else int(args.rescore_mult))
    index = IVFIndex.build(x, k=args.kc, max_iters=args.kmeans_iters,
                           seed=args.seed, device=dev, store=args.store,
                           page_size=args.page_size,
                           codec=args.codec, rescore_mult=rescore_mult,
                           rescore=args.rescore, router=args.router,
                           pctx=pctx)
    sync()
    t_build = time.perf_counter() - t0
    say(f"bucket store: {index.store!r} "
        f"({index.resident_bytes() / 1e6:.1f} MB resident)")
    if index.router.kind != "flat":
        say(f"router: {index.router!r}")

    scfg = SearchConfig(topk=args.topk, nprobe=args.nprobe,
                        query_batch=args.queries,
                        snapshot_dir=args.snapshot_dir,
                        snapshot_every=args.snapshot_every)
    health = HealthPolicy() if args.health else None
    faults = FaultInjector(FaultPlan.seeded(args.chaos_seed)) \
        if args.chaos_seed is not None else None
    eng = SearchEngine(index, scfg, health=health, faults=faults)
    q = x[torch.randint(0, args.n, (args.queries,), device=dev,
                        generator=gen)]
    eng.search(q)                          # warm: every kernel built
    sync()
    t0 = time.perf_counter()
    for _ in range(args.reps):
        ids, _ = eng.search(q)
    sync()
    qps = args.reps * args.queries / (time.perf_counter() - t0)

    ids_ref, _ = index.search_brute(q, topk=args.topk)
    recall = recall_at_k(ids, ids_ref)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (the kernels' plain versions)")
    say(f"mode=search n={args.n} d={args.d} kc={args.kc} "
        f"nprobe={args.nprobe} topk={args.topk} on {name}")
    say(f"build {t_build:.2f}s ({args.n / t_build:.0f} pts/s); "
        f"serve {qps:.0f} qps; recall@{args.topk}={recall:.3f}")
    say(f"scheduler: {eng.batches_formed} units, "
        f"{eng.coalesced_requests} coalesced, "
        f"{eng.interleaved_adds} interleaved adds, "
        f"queue depth {eng.queue_depth}")
    lat = eng.latency_stats()
    say(f"latency: dispatch p50 {lat['dispatch_p50_ms']:.3f}ms "
        f"p99 {lat['dispatch_p99_ms']:.3f}ms; "
        f"complete p50 {lat['complete_p50_ms']:.3f}ms "
        f"p99 {lat['complete_p99_ms']:.3f}ms; "
        f"{lat['overlap_hits']} overlapped units")
    out = {"build_s": t_build, "qps": qps, "recall": recall, **lat}
    if pctx is not None:
        cb = index.search_collective_bytes(args.queries, args.topk,
                                           args.nprobe)
        say(f"collective bytes/batch (modeled, O(b*L)): {cb}")
        out["collective_bytes"] = cb
    if health is not None or faults is not None:
        hot = {k: v for k, v in eng.counters.as_dict().items() if v}
        say(f"health counters: {hot or 'all healthy'}")
        out["counters"] = eng.counters.as_dict()
    if args.snapshot_dir:
        # durability demo: snapshot, kill, recover, check the identity
        t0 = time.perf_counter()
        eng.snapshot()
        t_snap = time.perf_counter() - t0
        index.faults = None   # the dead engine's injector dies with it
        del eng
        t0 = time.perf_counter()
        eng2 = SearchEngine.recover(args.snapshot_dir, scfg, device=dev)
        t_rec = time.perf_counter() - t0
        ids2, _ = eng2.search(q)
        same = bool(torch.equal(ids, ids2))
        say(f"snapshot {t_snap * 1e3:.1f}ms; recover {t_rec:.2f}s "
            f"(replayed {eng2.counters.wal_records_replayed} WAL "
            f"records); restored search identical: {same}")
        out.update(snapshot_s=t_snap, recover_s=t_rec, restored_same=same,
                   wal_records_replayed=eng2.counters.wal_records_replayed)
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="search",
                    choices=["dense", "clustered", "search"],
                    help="only search is ported")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--mesh", default=None,
                    help="serve on a DATAxCELLS mesh (e.g. 2x2): the "
                         "sharded index; run under torchrun with "
                         "DATA*CELLS ranks (1x1: no torchrun)")
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--kc", type=int, default=64,
                    help="coarse cells (IVF k)")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--kmeans-iters", type=int, default=8)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--store", default=None, choices=["padded", "paged"],
                    help="posting-list backend (default: "
                         "REPRO_BUCKET_STORE, else padded)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="rows a page of the paged store (default 64)")
    ap.add_argument("--codec", default=None, choices=["fp32", "q8"],
                    help="payload codec (default: REPRO_BUCKET_CODEC, else "
                         "fp32); q8 searches in two phases")
    ap.add_argument("--rescore-mult", default="4",
                    help="q8 proposal depth R = rescore_mult * topk, or "
                         "'auto'")
    ap.add_argument("--rescore", default=None, choices=["device", "host"],
                    help="q8 rescore rows (default: REPRO_RESCORE, else "
                         "device): the device cache, or the host "
                         "reservoir round trip")
    ap.add_argument("--router", default=None, choices=["flat", "two_level"],
                    help="cell selection (default: REPRO_ROUTER, else "
                         "flat)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="index snapshots and the write-ahead add-log here; "
                         "also runs a kill/recover identity demo")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="adds between automatic snapshots (0 = manual)")
    ap.add_argument("--health", action="store_true",
                    help="serve under a HealthPolicy (retry/backoff and the "
                         "degradation ladder); prints its counters")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="inject FaultPlan.seeded(seed) into the serving "
                         "path")
    return ap


if __name__ == "__main__":
    main()
