"""FlashLloyd's device time in turns with another tree's, and its bits run to run.

Run on the card from the repository's root:

    python3 tools/lloyd_turns.py [--other DIR] [--turns N] [--out FILE]

``DIR`` is the root of another checkout (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Each measurement runs in a child process whose ``PYTHONPATH`` is one tree's
``src``, in turns: other, this, this, other, ... (``--turns`` children a tree,
default 2). A child times ``flash_lloyd_raw`` at each shape of ``SHAPES`` on
data drawn on the card from a fixed seed: the device time of a call by kernel
(``torch.profiler``; the main kernel, the fold and the rest), and how many of
``RUNS`` calls give the first call's ids, sums, counts and inertia bit for
bit. Each child prints one JSON line; the parent prints a table and writes
all children's records to ``--out`` (default ``chiprun_out/lloyd_turns.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# (tag, B, N, K, d, dtype): the paper regimes where the fused step runs
SHAPES = [("smallN_smallK", 1, 65536, 256, 128, "float32"),
          ("smallN_smallK", 1, 65536, 256, 128, "bfloat16"),
          ("largeN_smallK", 1, 8388608, 1024, 128, "float32"),
          ("batched_B32", 32, 65536, 1024, 128, "float32")]
RUNS = 5     # calls compared bit for bit
REPS = 20    # profiled calls a shape
SEED = 25


def child() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_lloyd as fl

    dev = torch.device("cuda")
    out = {"device": torch.cuda.get_device_name(0), "shapes": []}
    for tag, b, n, k, d, dt in SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED)
        centres = 2.0 * torch.randn((b, k, d), device=dev, generator=g)
        pick = torch.randint(0, k, (b, n), device=dev, generator=g)
        x = (torch.gather(centres, 1, pick.unsqueeze(-1).expand(b, n, d))
             + torch.randn((b, n, d), device=dev, generator=g))
        c = x[:, torch.randperm(n, device=dev, generator=g)[:k]]
        x, c = x.to(getattr(torch, dt)), c.to(getattr(torch, dt)).contiguous()
        del centres, pick
        first = fl.flash_lloyd_raw(x, c)
        torch.cuda.synchronize()
        same = 1 + sum(all(torch.equal(u, v) for u, v in zip(
            first, fl.flash_lloyd_raw(x, c))) for _ in range(RUNS - 1))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fl.flash_lloyd_raw(x, c)
            torch.cuda.synchronize()
        kernels = {}
        for ev in prof.key_averages():
            if "cuda" not in str(getattr(ev, "device_type", "")).lower():
                continue
            t = getattr(ev, "self_device_time_total", None)
            if t is None:
                t = getattr(ev, "self_cuda_time_total", 0.0)
            if t > 0:
                kernels[ev.key] = t / REPS / 1e3
        main = sum(v for kk, v in kernels.items() if "flash_lloyd_tc" in kk)
        fold = sum(v for kk, v in kernels.items() if "flash_lloyd_fold" in kk)
        out["shapes"].append({
            "tag": f"{tag}/{dt}", "shape": [b, n, k, d],
            "device_ms": sum(kernels.values()), "main_ms": main,
            "fold_ms": fold, "kernels": kernels, "bit_runs": same,
            "runs": RUNS})
        del x, c, first
        torch.cuda.empty_cache()
    print("LLOYD_TURNS " + json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default=None)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/lloyd_turns.json")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child()
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = [("this", here)]
    if args.other:
        trees.insert(0, ("other", os.path.abspath(args.other)))
    order = []
    for i in range(args.turns):
        order += trees if i % 2 == 0 else trees[::-1]
    records = []
    for name, root in order:
        env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child"], cwd=root, env=env,
                              capture_output=True, text=True, timeout=900)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("LLOYD_TURNS ")]
        if proc.returncode != 0 or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"{name}: child failed with code {proc.returncode}")
            return 1
        rec = json.loads(line[0].split(" ", 1)[1])
        rec["tree"] = name
        records.append(rec)
        for s in rec["shapes"]:
            print(f"{name:5s} {s['tag']:24s} device {s['device_ms']:.4f} ms "
                  f"(kernel {s['main_ms']:.4f}, fold {s['fold_ms']:.4f}); "
                  f"{s['bit_runs']} of {s['runs']} runs bit for bit",
                  flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records, f, indent=1)
    bad = [s["tag"] for r in records if r["tree"] == "this"
           for s in r["shapes"] if s["bit_runs"] != s["runs"]]
    print(f"this tree: bit for bit at every shape: {not bad} {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
