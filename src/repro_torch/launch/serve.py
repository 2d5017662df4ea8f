"""Serving launcher of the port: batched LM prefill + decode through
``Engine`` (``--mode dense|clustered``) and FlashIVF vector search through
``SearchEngine`` (``--mode search``, the default), the counterpart of
``repro/launch/serve.py``.

  # Llama-3-8B at full width on the card, clustered KV cache
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --mode clustered --batch 4 --prompt-len 2048 --gen 32 --recent 16

  # zamba2-7b (Mamba2 + one shared attention block) at full width
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --mode clustered --batch 4 --prompt-len 2048 --gen 32 --recent 16

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --reduced --batch 4 --prompt-len 128 --gen 32 --mode clustered \\
      --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --mode search \\
      --n 20000 --d 64 --kc 64 --queries 512 --topk 10 --nprobe 8

  # reliability: durable snapshots + WAL, the health ladder, seeded chaos
  PYTHONPATH=src python -m repro_torch.launch.serve --mode search \\
      --snapshot-dir /tmp/ivf-snap --health --chaos-seed 7

  # sharded serving: 2 data x 2 cell shards, one rank a card (NCCL)
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.serve --mode search --mesh 2x2

LM serving (ref. ``_serve_lm``, l.31-58): ``--arch`` (``--reduced`` for
the same-family miniature) is initialised from ``--seed`` on the device,
``--batch`` prompts of ``--prompt-len`` random tokens are generated for
``--gen`` steps (``--temperature`` > 0 samples, else greedy; ``--recent``
slots of the clustered mode's recent buffer, the reference's 128 by
default), and it prints the arch, mode and shape, the wall time and tok/s,
and the first sample ids. Every one of the ten records is served; for
phi-3-vision's patches and whisper's frames (``frontend_seq`` rows of
``d_model``) the input is drawn from a ``torch.Generator`` seeded by
``--seed`` (the reference draws them from its key), and learned positions
get ``--prompt-len + --gen + 64`` rows, as the reference's. The cache
holds ``--prompt-len + --gen + 8`` slots, and phi-3-vision's patches
besides (the reference's launcher leaves them out, and its prefill then
refuses phi-3-vision). ``--mesh DATAxMODEL`` serves the LM through
``Engine(mesh=)`` over the world ``torchrun`` started (each rank draws the
same params and prompts from ``--seed`` and keeps its slices; only rank 0
prints):

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.serve --arch llama3-8b --mode clustered \\
      --mesh 1x4

Search serving builds an index over a synthetic clustered corpus (Gaussian blobs made
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
``--router`` and with the reliability flags (``--health``, ``--chaos-seed``,
``--snapshot-dir``: every rank injects the same seeded plan; rank 0 writes
the snapshots and the WAL; the demo recovers onto the same mesh): under
``torchrun`` (the
rendezvous from the environment, NCCL, one rank a card; gloo with
``--device cpu``), or without it at world size 1 for ``--mesh 1x1``. A
mesh whose size is not the world's raises ``ValueError``. Every rank builds the same corpus from ``--seed``; only
rank 0 prints, and it reports the modeled cross-rank bytes of a search
batch beside queries/s.
"""
from __future__ import annotations

import argparse
import time

import torch


def main(argv=None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.mode != "search" and not args.arch:
        ap.error("--arch is required for dense/clustered serving")
    if args.mesh is None:
        if args.mode != "search":
            return _serve_lm(args, None, print)
        return _serve_search(args, None, print)
    from repro_torch.core.kmeans import resolve_device
    from repro_torch.core.parallel import (ParallelContext, parse_mesh_flag,
                                           release_world)
    dev = resolve_device(args.device)
    try:
        if args.mode != "search":
            mesh = parse_mesh_flag(args.mesh, device_type=dev.type)
            say = print if int(mesh.get_rank()) == 0 else \
                (lambda *a, **k: None)
            return _serve_lm(args, mesh, say)
        pctx = ParallelContext.for_mesh(parse_mesh_flag(
            args.mesh, device_type=dev.type))
        rank0 = int(pctx.mesh.get_rank()) == 0
        say = print if rank0 else (lambda *a, **k: None)
        say(f"sharded serving: {pctx.describe()}")
        return _serve_search(args, pctx, say)
    finally:
        release_world()


def _serve_lm(args, mesh, say) -> dict:
    """Prefill + decode through ``Engine`` (over ``mesh`` if one is given);
    returns the ids and times."""
    from repro_torch.configs import get_config
    from repro_torch.core.kmeans import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = M.init_model(cfg, seed=args.seed, device=dev,
                          max_pos=args.prompt_len + args.gen + 64)
    # the vlm's patches sit in the cache before the prompt: its cache holds
    # them too (the reference's launcher sizes it to the text alone, and its
    # prefill's assertion then stops phi-3-vision)
    patches = cfg.frontend_seq if cfg.frontend and cfg.family != "audio" \
        else 0
    engine = Engine(cfg, params,
                    ServeConfig(max_seq=patches + args.prompt_len + args.gen
                                + 8,
                                mode=args.mode, recent=args.recent,
                                temperature=args.temperature), mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    frontend = None
    if cfg.frontend:
        frontend = torch.randn(
            (args.batch, cfg.frontend_seq, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(args.seed + 2))
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = engine.generate(tokens, args.gen, frontend=frontend,
                          generator=gen if args.temperature > 0 else None)
    sync()
    dt = time.perf_counter() - t0
    tok_s = args.batch * args.gen / dt
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (the kernels' plain versions)")
    say(f"arch={cfg.name} mode={args.mode} batch={args.batch} "
        f"prompt={args.prompt_len} gen={args.gen}"
        + ("" if mesh is None else f" mesh={tuple(mesh.shape)}"))
    say(f"on {name}: {M.n_elements(params)} parameters, "
        f"{engine.recluster_count} incremental re-clusters")
    say(f"wall {dt:.2f}s -> {tok_s:.1f} tok/s")
    say("sample ids:", out[0, :16].tolist())
    return {"ids": out, "wall_s": dt, "tok_s": tok_s,
            "recluster_count": engine.recluster_count}


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
        eng2 = SearchEngine.recover(args.snapshot_dir, scfg, device=dev,
                                    pctx=pctx)
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
                    help="LM serving (dense or clustered KV cache, needs "
                         "--arch) or vector search (the default)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--mesh", default=None,
                    help="serve on a DATAxCELLS mesh (e.g. 2x2): the "
                         "sharded index, or with --mode dense|clustered "
                         "the LM over DATAxMODEL; run under torchrun with "
                         "DATA*CELLS ranks (1x1: no torchrun)")
    # LM serving
    ap.add_argument("--arch", default=None,
                    help="architecture record (configs), e.g. llama3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's same-family miniature")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--recent", type=int, default=128,
                    help="slots of the clustered mode's recent buffer "
                         "(tokens between incremental re-clusters)")
    # vector-search serving
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
