"""Where a training step's device time goes, on the card.

Run from the repository's root:

    python3 tools/train_profile.py [--arch NAME] [--batch B] [--seq S]
                                   [--steps N] [--layers L] [--kmeans-attn]
                                   [--f32] [--out FILE]

Builds the launcher's training step (``launch/train.py`` without
``--reduced``: bfloat16 mixed precision over f32 masters, remat, the
params and moments updated in place) for ``--arch`` (default
granite-moe-1b-a400m) at full width and depth from seed 0 (``--layers``
cuts the depth, ``--kmeans-attn`` routes the attention by clusters,
``--f32`` computes in f32), takes one warm-up step, then ``--steps`` steps
(default 2) under ``torch.profiler`` with the model's parts in named
scopes: the attention, the routed attention and its clustering, the MoE
dispatch and experts, the MLP, the logits and loss, and the AdamW update.
It prints the step's time (CUDA events), the device's busy time (its
kernels' sum) and idle share, the span of each scope on the device's
timeline, the backward's device time by autograd function, and the kernels
of most device time; ``--out`` (default ``chiprun_out/train_profile.json``) gets them all.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCOPES = ("step", "attention", "moe", "mlp", "logits+loss", "adamw",
          "routed", "kmeans")


def _scoped(mod, name: str, scope: str):
    """Wrap ``mod.name`` in a ``record_function`` scope."""
    import torch
    fn = getattr(mod, name)

    def wrapped(*a, **kw):
        with torch.profiler.record_function(scope):
            return fn(*a, **kw)
    setattr(mod, name, wrapped)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: the "
                         "config's)")
    ap.add_argument("--kmeans-attn", action="store_true",
                    help="the train-time cluster-routed attention")
    ap.add_argument("--f32", action="store_true",
                    help="compute in f32 (no mixed precision)")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "train_profile.json"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data.pipeline import pipeline_for, put_batch
    from repro_torch.models import common, model as M
    from repro_torch.models import kmeans_attention as kma
    from repro_torch.models.layers import attention, moe
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts

    if not torch.cuda.is_available():
        sys.exit("train_profile: no CUDA device")
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers or args.kmeans_attn:
        cfg = dataclasses.replace(cfg, num_layers=args.layers
                                  or cfg.num_layers,
                                  kmeans_attn=args.kmeans_attn)
    shape = SHAPES["train_4k"]
    shape = type(shape)(shape.name, args.seq, args.batch, shape.kind)
    for mod, name, scope in (
            (attention, "chunked_attention", "attention"),
            (attention, "project_qkv", "attention"),
            (attention, "attn_out", "attention"),
            (moe, "moe", "moe"), (common, "mlp", "mlp"),
            (M, "_logits", "logits+loss"), (adamw, "update", "adamw"),
            (kma, "kmeans_routed_attention", "routed"),
            (kma, "cluster_keys", "kmeans")):
        _scoped(mod, name, scope)
    params = M.init_model(cfg, seed=0, device=dev,
                          max_pos=max(args.seq, 1024))
    opt = adamw.init(params)
    step_fn = ts.make_train_step(
        cfg, compute_dtype=torch.float32 if args.f32 else torch.bfloat16,
        remat=True,
        lr_schedule=adamw.cosine_schedule(3e-4, 10, 20))
    pipe = pipeline_for(cfg, shape, seed=0)

    def step(i):
        nonlocal params, opt
        batch = put_batch(pipe.batch_at(i), dev)
        params, opt, met = step_fn(params, opt, batch, i)
        return met

    step(0)
    torch.cuda.synchronize()
    times = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(1, args.steps + 1):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            with torch.profiler.record_function("step"):
                met = step(i)
            e1.record()
            met["loss"].item()
            times.append(e0.elapsed_time(e1))
    torch.cuda.synchronize()
    kernels, scopes, backward = [], {}, {}
    for ev in prof.key_averages():
        dev_t = getattr(ev, "self_device_time_total", None)
        if dev_t is None:
            dev_t = getattr(ev, "self_cuda_time_total", 0.0)
        tot = getattr(ev, "device_time_total", None)
        if tot is None:
            tot = getattr(ev, "cuda_time_total", 0.0)
        on_dev = "cuda" in str(getattr(ev, "device_type", "")).lower()
        if ev.key in SCOPES:
            if on_dev:     # the scope's span on the device's timeline
                scopes[ev.key] = dev_t / args.steps / 1e3
        elif on_dev and dev_t > 0:
            kernels.append({"name": ev.key, "ms": dev_t / args.steps / 1e3,
                            "calls": ev.count / args.steps})
        elif ev.key.startswith("autograd::engine::evaluate_function"):
            name = ev.key.split(": ", 1)[-1]
            backward[name] = backward.get(name, 0.0) + tot / args.steps / 1e3
    kernels.sort(key=lambda r: -r["ms"])
    busy = sum(k["ms"] for k in kernels)
    ms = statistics.median(times)
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "kmeans_attn": cfg.kmeans_attn, "f32": args.f32,
           "batch": args.batch, "seq": args.seq,
           "card": torch.cuda.get_device_name(0), "step_ms": times,
           "device_busy_ms": busy, "idle_share": 1 - busy / ms,
           "scopes_ms": scopes, "backward_ms": dict(sorted(
               backward.items(), key=lambda kv: -kv[1])[:25]),
           "kernels": kernels[:40],
           "launches": sum(k["calls"] for k in kernels)}
    print(f"{cfg.name} ({cfg.num_layers} layers, kmeans_attn "
          f"{cfg.kmeans_attn}, {'f32' if args.f32 else 'bf16'}) B "
          f"{args.batch} S {args.seq}: {ms:.1f} ms a step "
          f"(CUDA events, median of {len(times)}), device busy {busy:.1f} "
          f"ms in {out['launches']:.0f} launches (idle "
          f"{out['idle_share']:.3f})")
    print("device ms spanned by the forward's scopes (remat's re-run "
          "included), and by the whole step: "
          + ", ".join(f"{k} {v:.1f}" for k, v in scopes.items()))
    print("backward functions, device ms: " + ", ".join(
        f"{k} {v:.1f}" for k, v in list(out["backward_ms"].items())[:12]))
    for k in kernels[:25]:
        print(f"  {k['ms']:9.3f} ms {k['calls']:8.1f} calls  "
              f"{k['name'][:110]}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
