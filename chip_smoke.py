#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
sm_90a), holds each kernel against its plain PyTorch version on the card,
then drives the exact Lloyd fit (``KMeans.fit`` / ``fit_batched`` and the
online ``iterate``) at the widths of the paper's four regimes
(``benchmarks/bench_e2e.py``), with the launch counters zeroed just before
each regime's run and read just after. It prints the kernel table as one
JSON line, the card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``. It exits non-zero, printing no result,
without a CUDA device or outside a checkout of the repository, and when
any check fails. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BW = 3.35e12                    # H100 SXM data sheet, bytes/s
PEAK = {"float32": 67e12,           # fp32 on CUDA cores, FLOP/s
        "bfloat16": 989e12}         # dense bf16 tensor cores, FLOP/s
U32 = 2.0 ** -24                    # fp32 unit roundoff

# name, N, K, d, B, dtype, Lloyd iterations (paper regimes, widths as
# benchmarks/bench_e2e.py; largeN_largeK's N is cut from 1,048,576)
REGIMES = [
    ("smallN_smallK", 65536, 256, 128, 1, "float32", 10),
    ("largeN_smallK", 8388608, 1024, 128, 1, "float32", 4),
    ("largeN_smallK", 8388608, 1024, 128, 1, "bfloat16", 4),
    ("batched_B32", 65536, 1024, 128, 32, "float32", 4),
    ("largeN_largeK", 262144, 65536, 512, 1, "float32", 1),
]
LARGE_K_FULL_N = 1048576
PLAIN_ELEMS = 2 ** 28   # entries of one plain score matrix (1 GiB in f32)
# (B, N, K, d): tails of every tile dim, K = 1, d = 1, a single point
RAGGED = [(1, 1000, 37, 19), (3, 777, 100, 64), (1, 1, 1, 1),
          (2, 130, 1, 3), (1, 4097, 65, 129)]

failures: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("  ok   " if ok else "  FAIL ") + what, flush=True)
    if not ok:
        failures.append(what)


def plain_chunks(b: int, n: int, k: int):
    """(batch, row) slices that cover every row of every problem, each
    with a plain score matrix of at most ``PLAIN_ELEMS`` entries."""
    rows = max(1, PLAIN_ELEMS // k)
    if n <= rows:
        step = max(1, rows // n)
        return [(slice(i, i + step), slice(0, n)) for i in range(0, b, step)]
    return [(slice(i, i + 1), slice(r, r + rows))
            for i in range(b) for r in range(0, n, rows)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    from repro_torch.core import KMeans, KMeansConfig
    from repro_torch.core import heuristics as H
    from repro_torch.kernels import flash_assign as fa
    from repro_torch.kernels import flash_lloyd as fl
    from repro_torch.kernels import sort_inverse_update as siu

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # ---- phase 1: build ------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    print(f"[build] {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_seconds}) -> {_build.build()}", flush=True)
    for line in _build.ptxas_log.splitlines():
        if "Used" in line or line.startswith("=="):
            print("  " + line.strip())
    model = H.fused_footprint(64, 64, 1, 4, 0)
    for bf16 in (False, True):
        got = _build.lloyd_static_smem(bf16)
        check(got == model, f"flash_lloyd static smem {got} == the "
                            f"planner's model {model} (bf16={bf16})")

    mods = {"flash_assign": fa, "sort_inverse_update": siu,
            "flash_lloyd": fl}
    launches = {k: 0 for k in mods}
    max_err = {k: 0.0 for k in mods}
    timing: dict[str, dict] = {}
    details = {"card": smi, "regimes": [], "kernel_checks": []}

    def ms_of(fn, reps=3):
        fn()  # warm-up
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    def mixture(b, n, k, d, gen):
        centers = torch.randn(b, k, d, device=dev, generator=gen) * 2.0
        lab = torch.randint(0, k, (b, n), device=dev, generator=gen)
        x = torch.randn(b, n, d, device=dev, generator=gen)
        for i in range(b):
            x[i].add_(centers[i].index_select(0, lab[i]))
        return x

    # ---- phase 2 helpers: kernel vs plain on the card -------------------
    def assign_check(x, c, tag):
        """x (B, N, d), c (B, K, d) of one dtype: the kernel runs over the
        whole batch and every row is held against the plain version, which
        runs in chunks that fit the card. Returns the kernel's ids."""
        a, m = fa.flash_assign_raw(x, c)
        b, n, d = x.shape
        k = c.shape[1]
        c32 = c.float()
        xn = torch.linalg.vector_norm(x, dim=-1, dtype=torch.float32).max()
        mag = (c32 * c32).sum(-1).max() + 2 * xn * c32.norm(dim=-1).max()
        tol = float(2 * d * U32 * mag)   # worst-case fp32 dot error, 2 orders
        err, mism, gap = 0.0, 0, 0.0
        for bs, rs in plain_chunks(b, n, k):
            ap, mp = fa.flash_assign_plain(x[bs, rs], c[bs])
            ak = a[bs, rs]
            err = max(err, float((m[bs, rs] - mp).abs().max()))
            diff = ak != ap
            if bool(diff.any()):  # a differing id must be a near-tie
                bi, ni = diff.nonzero().unbind(1)
                xr = x[bs, rs][bi, ni].float()
                cc = c32[bs]

                def score(kk):
                    ck = cc[bi, kk.long()]
                    return (ck * ck).sum(-1) - 2 * (xr * ck).sum(-1)
                gap = max(gap, float((score(ak[bi, ni])
                                      - score(ap[bi, ni])).abs().max()))
                mism += int(diff.sum())
        rec = {"kernel": "flash_assign", "at": tag, "dtype": str(x.dtype),
               "shape": [b, n, k, d], "rows_compared": b * n,
               "max_abs_err": err, "tol": tol, "mismatches": mism,
               "tie_gap": gap}
        details["kernel_checks"].append(rec)
        check(err <= tol and gap <= tol,
              f"flash_assign {tag} {x.dtype}: all {b * n} rows, score err "
              f"{err:.3g}, {mism} id mismatches (max gap {gap:.3g}) <= "
              f"tol {tol:.3g}")
        max_err["flash_assign"] = max(max_err["flash_assign"], err)
        return a

    def sums_tol(x2, ids, segments, cnt):
        """|sum error| bound per (segment, column): 2 n u sum |x|."""
        absx = x2.abs().float()
        abssum = torch.zeros((segments, x2.shape[1]), device=dev)
        abssum.index_add_(0, ids.long(), absx)
        return 2 * U32 * cnt.unsqueeze(1) * abssum + 1e-30

    def siu_check(x2, ids, segments, tag):
        ids_s, order = torch.sort(ids, stable=True)
        order = order.to(torch.int32)
        s, cnt = siu.sort_inverse_update_raw(x2, order, ids_s, segments)
        sp, cp = siu.sort_inverse_update_plain(x2, order, ids_s, segments)
        torch.cuda.synchronize()
        err_t = (s - sp).abs()
        bound = sums_tol(x2, ids, segments, cp)
        err = float(err_t.max())
        ok = bool((err_t <= bound).all()) and torch.equal(cnt, cp)
        details["kernel_checks"].append(
            {"kernel": "sort_inverse_update", "at": tag,
             "dtype": str(x2.dtype), "rows": x2.shape[0],
             "segments": segments, "max_abs_err": err,
             "counts_equal": torch.equal(cnt, cp)})
        check(ok, f"sort_inverse_update {tag} {x2.dtype}: sums err {err:.3g}"
                  f" within 2nu*sum|x|, counts equal {torch.equal(cnt, cp)}")
        max_err["sort_inverse_update"] = max(max_err["sort_inverse_update"],
                                             err)
        return order, ids_s

    def lloyd_check(x, c, tag):
        a, s, cnt, j = fl.flash_lloyd_raw(x, c)
        torch.cuda.synchronize()
        a_assign = assign_check(x, c, tag + "/fused-argmin")
        b, n, d = x.shape
        k = c.shape[1]
        ids = (a.long() + k * torch.arange(b, device=dev).unsqueeze(1))
        ids = ids.reshape(-1)
        x2 = x.reshape(-1, d)
        sp = torch.zeros((b * k, d), device=dev).index_add_(
            0, ids, x2.float())
        cp = torch.bincount(ids, minlength=b * k).float()
        _, _, _, jp = fl.flash_lloyd_plain(x, c)
        bound = sums_tol(x2, ids, b * k, cp)
        err_t = (s.reshape(b * k, d) - sp).abs()
        err = float(err_t.max())
        jerr = float(((j - jp).abs() / jp.abs()).max())
        same_a = int((a != a_assign).sum())
        ok = (bool((err_t <= bound).all()) and torch.equal(
            cnt.reshape(-1), cp) and jerr <= 1e-4 and same_a == 0)
        details["kernel_checks"].append(
            {"kernel": "flash_lloyd", "at": tag, "dtype": str(x.dtype),
             "shape": [b, n, k, d], "max_abs_err": err,
             "inertia_rel_err": jerr, "ids_differ_from_assign": same_a})
        check(ok, f"flash_lloyd {tag} {x.dtype}: sums err {err:.3g} within "
                  f"2nu*sum|x|, counts equal, inertia rel err {jerr:.2g} <= "
                  f"1e-4, ids == FlashAssign's ({same_a} differ)")
        max_err["flash_lloyd"] = max(max_err["flash_lloyd"], err)
        return a_assign

    # ---- phase 2a: ragged and degenerate shapes, every kernel ------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    print("\n[ragged shapes]", flush=True)
    for b, n, k, d in RAGGED:
        for cdt in (torch.float32, torch.bfloat16):
            x = torch.randn(b, n, d, device=dev, generator=gen).to(cdt)
            c = torch.randn(b, k, d, device=dev, generator=gen).to(cdt)
            a = lloyd_check(x, c, f"ragged{(b, n, k, d)}")
            ids = a + k * torch.arange(b, device=dev,
                                       dtype=torch.int32).unsqueeze(1)
            siu_check(x.reshape(-1, d), ids.reshape(-1), b * k,
                      f"ragged{(b, n, k, d)}")

    # ---- phases 2-3: per regime, compare, then drive the main path ------
    for name, n, k, d, b, dt, iters in REGIMES:
        dtype = getattr(torch, dt)
        print(f"\n[{name}] N={n} K={k} d={d} B={b} {dt}, {iters} Lloyd "
              f"iteration(s)", flush=True)
        if name == "largeN_largeK":
            print(f"  N cut from {LARGE_K_FULL_N} to {n} so that the "
                  "fp32 FlashAssign fits the run's time", flush=True)
        x = mixture(b, n, k, d, gen).to(dtype)
        c0 = torch.stack([x[i, torch.randperm(n, device=dev, generator=gen)
                            [:k]] for i in range(b)])
        # phase 2: each kernel against its plain version, f32 and bf16,
        # over every row of the run
        for cdt in (torch.float32, torch.bfloat16):
            xc, cc = x.to(cdt), c0.to(cdt)
            if name == "smallN_smallK":
                lloyd_check(xc, cc, name)
                continue
            a_k = assign_check(xc, cc, name)
            if cdt == dtype:   # sort-inverse from the checked ids
                ids = (a_k + k * torch.arange(
                    b, device=dev, dtype=torch.int32).unsqueeze(1))
                siu_check(x.reshape(-1, d), ids.reshape(-1), b * k, name)
                del ids
            del xc, cc, a_k
        torch.cuda.synchronize()

        # phase 3: the main path, counted
        cfg = KMeansConfig(k=k, max_iters=iters, tol=0.0)
        km = KMeans(cfg)
        impl = cfg.resolved_step_impl(n, d, x.element_size(), device=dev)
        for mod in mods.values():
            mod.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if b == 1:
            st = km.fit(x[0], c0=c0[0])
        else:
            st = km.fit_batched(x, c0=c0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        # the online step from the same start: per-iteration inertia and
        # device time (the first step is the warm-up)
        c, traj, step_ms = c0 if b > 1 else c0[0], [], []
        for it in range(iters + 1):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            if b == 1:
                c, _, j = km.iterate(x[0], c)
            else:
                c, _, j = km.iterate_batched(x, c)
            e1.record()
            torch.cuda.synchronize()
            traj.append(j.float().reshape(-1).cpu())
            if it > 0:
                step_ms.append(e0.elapsed_time(e1))
        extra = []
        if name == "smallN_smallK":
            # the other entry points: fits that draw their own start on
            # the card, and predict (FlashAssign), whose ids must equal the
            # fused kernel's: both run the same argmin code
            for init in ("random", "kmeans++"):
                g1 = torch.Generator(device=dev).manual_seed(SEED + 1)
                s2 = KMeans(KMeansConfig(k=k, max_iters=3, init=init)).fit(
                    x[0], generator=g1)
                extra.append((f"fit(init={init!r}) finite, "
                               f"{int(s2.iteration)} iterations",
                               bool(torch.isfinite(s2.inertia))
                               and int(s2.iteration) >= 1))
            _, a_fused, _ = km.iterate(x[0], st.centroids)
            pred = km.predict(x[0], st.centroids)
            extra.append(("predict ids == the fused step's ids",
                          torch.equal(pred, a_fused)))
        counts = {kname: mod.launches for kname, mod in mods.items()}
        for kname in mods:
            launches[kname] += counts[kname]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        want = "fused" if name == "smallN_smallK" else "two_pass"
        check(impl == want, f"step_impl auto -> {impl} (expected {want})")
        need = (["flash_lloyd"] if want == "fused" else
                ["flash_assign", "sort_inverse_update"])
        idle = ["sort_inverse_update"] if want == "fused" else ["flash_lloyd"]
        check(all(counts[kn] > 0 for kn in need)
              and all(counts[kn] == 0 for kn in idle),
              f"kernels launched: {counts}")
        for what, ok in extra:
            check(ok, what)
        fin = bool(torch.isfinite(st.centroids.float()).all()) and bool(
            torch.isfinite(st.inertia).all())
        shapes = (tuple(st.centroids.shape) == ((k, d) if b == 1 else
                                                 (b, k, d))
                  and tuple(st.assignments.shape) == ((n,) if b == 1 else
                                                      (b, n)))
        check(fin and shapes, f"fit state finite with the expected shapes "
                              f"(iterations {st.iteration.tolist()})")
        ok_a = bool(((st.assignments >= 0) & (st.assignments < k)).all())
        check(ok_a, "assignments in [0, K)")
        rtol = 1e-5 if dt == "float32" else 1e-3
        rising = [(t, (traj[t + 1] - traj[t]).max().item())
                  for t in range(len(traj) - 1)
                  if bool((traj[t + 1] > traj[t] * (1 + rtol)).any())]
        check(not rising, f"inertia does not rise over {len(traj)} steps "
                          f"(rtol {rtol}): {[float(t[0]) for t in traj]}")
        ms_iter = statistics.median(step_ms)
        print(f"  fit {fit_s:.3f} s host wall for {iters} iteration(s); "
              f"{ms_iter:.3f} ms per Lloyd iteration (CUDA events, median "
              f"of {len(step_ms)} after a warm-up); peak {peak_gib:.2f} GiB",
              flush=True)
        details["regimes"].append(
            {"name": name, "N": n, "K": k, "d": d, "B": b, "dtype": dt,
             "impl": impl, "fit_iterations": st.iteration.tolist(),
             "fit_host_s": fit_s, "ms_per_iteration": ms_iter,
             "step_ms": step_ms, "inertia": [t.tolist() for t in traj],
             "launches": counts, "peak_gib": peak_gib})

        # kernel times at this regime's shapes (after the counted run)
        xb, cb = x, c0
        tag = f"{name}/{dt}"
        nb = b * n
        if want == "fused":
            # inputs read once, outputs (a, sums, counts, inertia) once
            byt = ((nb * d + b * k * d) * x.element_size() + nb * 4
                   + b * (k * d + k + 1) * 4)
            ops_ = 2.0 * nb * k * d + nb * d
            timing[tag + "/flash_lloyd"] = {
                "ms": ms_of(lambda: fl.flash_lloyd_raw(xb, cb)),
                "plain_ms": ms_of(lambda: fl.flash_lloyd_plain(xb, cb)),
                "library_ms": None, "bytes": byt, "ops": ops_,
                "dtype": dt, "shape": [b, n, k, d]}
        else:
            a_full, _ = fa.flash_assign_raw(xb, cb)

            def assign_plain_chunked():
                for bs, rs in plain_chunks(b, n, k):
                    fa.flash_assign_plain(xb[bs, rs], cb[bs])
            timing[tag + "/flash_assign"] = {
                "ms": ms_of(lambda: fa.flash_assign_raw(xb, cb)),
                "plain_ms": ms_of(assign_plain_chunked, reps=1),
                "library_ms": None,
                "bytes": (nb * d + b * k * d) * x.element_size() + nb * 8,
                "ops": 2.0 * nb * k * d, "dtype": dt, "shape": [b, n, k, d]}
            ids = (a_full + k * torch.arange(
                b, device=dev, dtype=torch.int32).unsqueeze(1)).reshape(-1)
            ids_s, order = torch.sort(ids, stable=True)
            order = order.to(torch.int32)
            x2 = xb.reshape(-1, d)
            blk = cfg.blocks_for(n, d, x.element_size(), dev)
            ids_l = ids.long()
            timing[tag + "/sort_inverse_update"] = {
                "ms": ms_of(lambda: siu.sort_inverse_update_raw(
                    x2, order, ids_s, b * k, chunk=blk.update_block_n,
                    threads=blk.update_block_k)),
                "plain_ms": ms_of(lambda: siu.sort_inverse_update_plain(
                    x2, order, ids_s, b * k)),
                # index_add_ computes the f32 sums only from f32 rows
                "library_ms": ms_of(lambda: torch.zeros(
                    (b * k, d), device=dev).index_add_(0, ids_l, x2))
                if x2.dtype == torch.float32 else None,
                "sort_ms": ms_of(lambda: torch.sort(ids, stable=True)),
                "bytes": nb * d * x.element_size() + nb * 8
                + b * k * (d + 1) * 4,
                "ops": float(nb * d), "dtype": dt, "shape": [b, n, k, d]}
            del a_full, ids, ids_s, order, ids_l
        del x, c0, xb, cb, st, c
        torch.cuda.empty_cache()

    # ---- phase 4: the kernel table ---------------------------------------
    main_shape = {"flash_assign": "largeN_smallK/float32",
                  "sort_inverse_update": "largeN_smallK/float32",
                  "flash_lloyd": "smallN_smallK/float32"}
    sources = {"flash_assign": "src/repro_torch/csrc/flash_assign.cu",
               "sort_inverse_update":
                   "src/repro_torch/csrc/sort_inverse_update.cu",
               "flash_lloyd": "src/repro_torch/csrc/flash_lloyd.cu"}
    replaces = {"flash_assign": "src/repro/kernels/flash_assign.py:77",
                "sort_inverse_update":
                    "src/repro/kernels/sort_inverse_update.py:104",
                "flash_lloyd": "src/repro/kernels/flash_lloyd.py:118"}
    table = []
    for kname in mods:
        t = timing[f"{main_shape[kname]}/{kname}"]
        t_bytes = t["bytes"] / HBM_BW * 1e3
        t_ops = t["ops"] / PEAK[t["dtype"]] * 1e3
        table.append({
            "name": kname, "route": "cuda", "source": sources[kname],
            "replaces": replaces[kname], "launches": launches[kname],
            "max_abs_err": max_err[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": t["library_ms"], "shape": t["shape"],
            "dtype": t["dtype"]})
        check(launches[kname] > 0, f"{kname} launched on the main path "
                                   f"({launches[kname]} launches)")
    for tag, t in timing.items():
        t_bytes = t["bytes"] / HBM_BW * 1e3
        t_ops = t["ops"] / PEAK[t["dtype"]] * 1e3
        t["bound_ms"] = max(t_bytes, t_ops)
        t["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"  {tag}: {t['ms']:.3f} ms (bound {t['bound_ms']:.3f} ms by "
              f"{t['bound_by']}; plain {t['plain_ms']:.3f} ms)")
    details["timing"] = timing
    details["failures"] = failures
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(details, indent=1))

    if failures:
        print(f"\nchip_smoke: {len(failures)} check(s) failed:",
              file=sys.stderr)
        for f in failures:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
