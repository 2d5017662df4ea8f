"""Serving launcher of the port: FlashIVF vector search through
``SearchEngine`` (``--mode search``), the counterpart of
``repro/launch/serve.py`` l.64-160.

  PYTHONPATH=src python -m repro_torch.launch.serve --mode search \\
      --n 20000 --d 64 --kc 64 --queries 512 --topk 10 --nprobe 8

It builds an index over a synthetic clustered corpus (Gaussian blobs made
from ``--seed`` on the device: centres x5, noise 0.4, as the reference),
warms a ``SearchEngine``, times ``--reps`` searches of ``--queries`` rows
through it and prints build time, queries/s, recall@topk against
``search_brute`` and ``latency_stats()``. ``--device`` defaults to
``cuda``; ``--device cpu`` runs the kernels' plain versions.

Not ported yet (ROADMAP.md, queue A), and refused with
``NotImplementedError``: ``--mode dense|clustered`` (items 7-8),
``--mesh`` (item 6), ``--health``, ``--snapshot-dir``,
``--snapshot-every``, ``--chaos-seed`` (item 5). ``--store paged`` builds
the paged store (``--page-size`` rows a page, default 64), as the
reference's flags do. ``--router two_level`` trains the two-level router
over the built centroids and prints it.
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
        raise _not_ported("--mesh (sharded serving)", "item 6")
    for flag, given in (("--health", args.health),
                        ("--snapshot-dir", args.snapshot_dir is not None),
                        ("--snapshot-every", args.snapshot_every != 0),
                        ("--chaos-seed", args.chaos_seed is not None)):
        if given:
            raise _not_ported(f"{flag} (reliability)", "item 5")


def _serve_search(args) -> dict:
    """Build, warm, serve; returns what it printed as numbers."""
    from repro_torch.core.kmeans import resolve_device
    from repro_torch.index import IVFIndex, recall_at_k
    from repro_torch.serve import SearchConfig, SearchEngine

    dev = resolve_device(args.device)
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
                           rescore=args.rescore, router=args.router)
    sync()
    t_build = time.perf_counter() - t0
    print(f"bucket store: {index.store!r} "
          f"({index.resident_bytes() / 1e6:.1f} MB resident)")
    if index.router.kind != "flat":
        print(f"router: {index.router!r}")

    eng = SearchEngine(index, SearchConfig(topk=args.topk,
                                           nprobe=args.nprobe,
                                           query_batch=args.queries))
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
    print(f"mode=search n={args.n} d={args.d} kc={args.kc} "
          f"nprobe={args.nprobe} topk={args.topk} on {name}")
    print(f"build {t_build:.2f}s ({args.n / t_build:.0f} pts/s); "
          f"serve {qps:.0f} qps; recall@{args.topk}={recall:.3f}")
    print(f"scheduler: {eng.batches_formed} units, "
          f"{eng.coalesced_requests} coalesced, "
          f"{eng.interleaved_adds} interleaved adds, "
          f"queue depth {eng.queue_depth}")
    lat = eng.latency_stats()
    print(f"latency: dispatch p50 {lat['dispatch_p50_ms']:.3f}ms "
          f"p99 {lat['dispatch_p99_ms']:.3f}ms; "
          f"complete p50 {lat['complete_p50_ms']:.3f}ms "
          f"p99 {lat['complete_p99_ms']:.3f}ms; "
          f"{lat['overlap_hits']} overlapped units")
    return {"build_s": t_build, "qps": qps, "recall": recall, **lat}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="search",
                    choices=["dense", "clustered", "search"],
                    help="only search is ported")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--mesh", default=None, help="not ported (item 6)")
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
    ap.add_argument("--snapshot-dir", default=None, help="not ported")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="not ported")
    ap.add_argument("--health", action="store_true", help="not ported")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="not ported")
    args = ap.parse_args(argv)
    _refuse_unported(args)
    return _serve_search(args)


if __name__ == "__main__":
    main()
