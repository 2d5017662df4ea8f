"""The JAX package's own gap between xLSTM's decode steps and its forward.

Run on the CPU from the repository's root:

    PYTHONPATH=src python tools/xlstm_reference_gap.py [--out FILE]

The reference's mLSTM chunk scan rounds q, k, v and its weights to
bfloat16, and its one-step recurrence is all f32, so a decode step equals
the forward only to bfloat16 rounding; its own test holds one block at
head_dim 16 within rtol = atol = 2e-2 (``tests/models/test_layers.py``).
This script measures that gap in the JAX package itself, with its own
random weights (``init_model`` from ``PRNGKey(seed)``) and tokens drawn
with numpy from the seed, B 1, a prompt of 128 and 16 decode steps:

* block: one mLSTM and one sLSTM block of xlstm-1.3b at full width
  (d_model 2,048, 4 heads; mLSTM head_dim 1,024) on rows of unit variance:
  the chunk scan over the prompt then one-token steps from its cache,
  against one pass over all 144 rows;
* model: xlstm-1.3b's layout (7 mLSTM and 1 sLSTM block a group) at each
  (d_model, layers) of ``MODELS``: ``prefill`` then ``decode_step``
  against the forward over all 144 tokens, and the forward over the 128
  prompt tokens against it at position 127; and, as a control of what a
  state that is not carried looks like, the same decode steps from zero
  caches.

For each it prints the largest absolute difference, the excess over the
reference's ``allclose(rtol=2e-2, atol=2e-2)``, and the least tolerance
``tau`` with which ``allclose(rtol=tau, atol=tau)`` holds,
``max |got - want| / (1 + |want|)``; and writes every record to ``--out``
(default ``chiprun_out/xlstm_reference_gap.json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.models.common import Ctx  # noqa: E402
from repro.models.layers import xlstm as xl  # noqa: E402

CTX = Ctx(mesh=None, compute_dtype=jnp.float32)
PROMPT, STEPS = 128, 16
TOL = 2e-2
# (d_model, layers): reduced widths at one group and at the full depth,
# then the full width (2,048) at one group
MODELS = ((64, 8), (64, 48), (256, 8), (256, 48), (1024, 8), (2048, 8))


def gap(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    return {"max_abs": float(d.max()),
            "excess_2e-2": float((d - TOL - TOL * np.abs(want)).max()),
            "tau": float((d / (1 + np.abs(want))).max()),
            "scale": float(np.abs(want).max())}


def block_gaps(seed):
    """One mLSTM and one sLSTM block at full width: prefill and steps
    against one pass over the whole sequence."""
    cfg = base.get_config("xlstm-1.3b")
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(jax.random.fold_in(key, 1),
                          (1, PROMPT + STEPS, cfg.d_model))
    x = (x - x.mean(-1, keepdims=True)) / x.std(-1, keepdims=True)
    out = {}
    for sub in ("mlstm", "slstm"):
        if sub == "mlstm":
            p, _ = xl.mlstm_init(key, cfg.d_model, cfg.num_heads,
                                 proj_factor=cfg.mlstm_proj_factor)
            run = functools.partial(xl.mlstm, p, ctx=CTX,
                                    num_heads=cfg.num_heads,
                                    chunk=cfg.ssm_chunk)
        else:
            p, _ = xl.slstm_init(key, cfg.d_model, cfg.num_heads)
            run = functools.partial(xl.slstm, p, ctx=CTX,
                                    num_heads=cfg.num_heads)
        zero = T.init_cache(dataclasses.replace(cfg, num_layers=1,
                                                slstm_every=1 if sub ==
                                                "slstm" else 0),
                            1, 1, jnp.float32)
        zero = jax.tree_util.tree_map(lambda t: t[0],
                                      next(iter(zero.values())))
        full, _ = run(x, cache=zero)
        y, c = run(x[:, :PROMPT], cache=zero)
        ys = [y]
        step = jax.jit(lambda x_, c_: run(x_, cache=c_))
        for t in range(PROMPT, PROMPT + STEPS):
            y, c = step(x[:, t:t + 1], c)
            ys.append(y)
        out[sub] = gap(jnp.concatenate(ys, 1), full)
    return out


def model_gaps(d_model, layers, seed):
    cfg = dataclasses.replace(
        base.get_config("xlstm-1.3b").reduced(), d_model=d_model,
        num_layers=layers, slstm_every=8,
        vocab_size=base.get_config("xlstm-1.3b").vocab_size)
    params, _ = M.init_model(jax.random.PRNGKey(seed), cfg,
                             max_pos=PROMPT + STEPS + 8)
    toks = jnp.asarray(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, PROMPT + STEPS)).astype(np.int32))

    def forward(params, tokens):
        x = M._embed_tokens(cfg, params, tokens, CTX)
        x, _, _ = T.apply_stack(params["stack"], x, CTX, cfg,
                                positions=M._positions(x))
        return M._logits(cfg, params, M._final_norm(cfg, params, x, CTX),
                         CTX)
    fwd = jax.jit(forward)
    full = fwd(params, toks)
    short = fwd(params, toks[:, :PROMPT])
    _, caches, _ = M.prefill(params, toks[:, :PROMPT], CTX, cfg,
                             max_seq=PROMPT + STEPS + 8)
    dec = jax.jit(functools.partial(M.decode_step, ctx=CTX, cfg=cfg))
    zero = T.init_cache(cfg, 1, PROMPT + STEPS + 8, jnp.float32)
    out = {"forward_128_vs_144": gap(short[:, -1], full[:, PROMPT - 1])}
    for name, c in (("decode", caches), ("control", zero)):
        steps = []
        for t in range(PROMPT, PROMPT + STEPS):
            lg, c = dec(params, toks[:, t:t + 1], c)
            steps.append(lg[:, 0])
        out[name] = gap(jnp.stack(steps, 1), full[:, PROMPT:])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=2,
                    help="model draws (seeds 0, 1, ...)")
    ap.add_argument("--blocks", type=int, default=2,
                    help="block draws (seeds 0, 1, ...)")
    ap.add_argument("--out", default="chiprun_out/xlstm_reference_gap.json")
    args = ap.parse_args()
    rec = {"prompt": PROMPT, "steps": STEPS, "block": {}, "model": {}}
    for seed in range(args.blocks):
        t0 = time.perf_counter()
        b = rec["block"][seed] = block_gaps(seed)
        for sub, g in b.items():
            print(f"seed {seed} block {sub} (d_model 2048): max abs "
                  f"{g['max_abs']:.4g}, excess over 2e-2 "
                  f"{g['excess_2e-2']:.4g}, tau {g['tau']:.4g} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for sub in ("mlstm", "slstm"):
        taus = [b[sub]["tau"] for b in rec["block"].values()]
        if taus:
            print(f"block {sub}, {len(taus)} draws: tau {min(taus):.4g} to "
                  f"{max(taus):.4g}", flush=True)
    for seed in range(args.seeds):
        for d_model, layers in MODELS:
            t0 = time.perf_counter()
            g = rec["model"][f"{d_model}x{layers}/{seed}"] = model_gaps(
                d_model, layers, seed)
            dg, fg = g["decode"], g["forward_128_vs_144"]
            print(f"seed {seed} model d_model {d_model}, {layers} layers: "
                  f"decode max abs {dg['max_abs']:.4g}, excess over 2e-2 "
                  f"{dg['excess_2e-2']:.4g}, tau {dg['tau']:.4g}; from zero "
                  f"caches tau {g['control']['tau']:.4g}; the "
                  f"forwards over 128 and 144 tokens at 127 "
                  f"{fg['max_abs']:.4g}; logits of scale {dg['scale']:.3g} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for d_model, layers in MODELS:
        gs = [rec["model"][f"{d_model}x{layers}/{s}"]
              for s in range(args.seeds)]
        if gs:
            print(f"model d_model {d_model}, {layers} layers, {len(gs)} "
                  f"draws: tau {min(g['decode']['tau'] for g in gs):.4g} to "
                  f"{max(g['decode']['tau'] for g in gs):.4g}, from zero "
                  f"caches {min(g['control']['tau'] for g in gs):.4g} to "
                  f"{max(g['control']['tau'] for g in gs):.4g}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
