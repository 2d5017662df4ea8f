"""Training launcher of the port, the counterpart of
``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --device cpu --steps 5

  # granite-moe-1b-a400m at full width and depth on the card
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --batch 4 --steps 20 --ckpt-every 10

It initialises ``--arch`` (``--reduced``: the same-family miniature) from
``--seed`` on ``--device`` (``cuda`` by default, ``cpu`` runs the kernels'
plain versions), builds the AdamW state and ``make_train_step``, and runs
the fault-tolerant ``Trainer`` over ``pipeline_for``'s synthetic batches
(``--shape``, its batch and length overridable by ``--batch`` and
``--seq``), checkpointing every ``--ckpt-every`` steps into ``--ckpt-dir`` (the
last ``--ckpt-keep`` kept) and printing the loss every ``--log-every``. As the reference chooses,
``--reduced`` computes in f32 without remat, else bfloat16 mixed
precision over f32 masters with remat; the learning rate is a cosine
schedule from ``--lr`` with 10 warmup steps. The params and moments are
updated in place, as the reference's jitted step donates them.
``--mesh``, ``--production-mesh`` and ``--multi-pod`` are refused
(ROADMAP.md, queue A item 8a). ``main`` returns a summary: every logged
loss, each step's wall time and, on a CUDA device, its device time.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core.kmeans import resolve_device
from repro_torch.data.pipeline import pipeline_for, put_batch
from repro_torch.launch.specs import train_batch_specs
from repro_torch.models import model as M
from repro_torch.models.common import not_ported
from repro_torch.optim import adamw
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--reduced", action="store_true",
                    help="same-family miniature config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0,
                    help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="explicit DATAxMODEL mesh, e.g. 2x4")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="checkpoints kept on disk")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    return ap


def _refuse_unported(args) -> None:
    for flag, on in (("--mesh", args.mesh is not None),
                     ("--production-mesh", args.production_mesh),
                     ("--multi-pod", args.multi_pod)):
        if on:
            raise not_ported(f"training over a mesh ({flag})")


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    _refuse_unported(args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = SHAPES[args.shape]
    if args.batch or args.seq:
        shape = dataclasses.replace(
            shape,
            global_batch=args.batch or shape.global_batch,
            seq_len=args.seq or shape.seq_len)
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} params~{cfg.n_params()/1e6:.1f}M device={dev} "
          f"batch={shape.global_batch} seq={shape.seq_len}", flush=True)

    # --- state
    params = M.init_model(cfg, seed=args.seed, device=dev,
                          max_pos=max(shape.seq_len, 1024))
    opt = adamw.init(params)
    compute_dtype = torch.float32 if args.reduced else torch.bfloat16
    step_fn = make_train_step(
        cfg, compute_dtype=compute_dtype, remat=not args.reduced,
        lr_schedule=adamw.cosine_schedule(args.lr, 10, args.steps))
    specs = train_batch_specs(cfg, shape)
    pipe = pipeline_for(cfg, shape, seed=args.seed)

    def put(batch):
        got = {k: tuple(v.shape) for k, v in batch.items()}
        want = {k: s for k, (s, _) in specs.items()}
        if got != want:
            raise ValueError(f"batch shapes {got} are not {want}")
        return put_batch(batch, dev)

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps,
                      checkpoint_every=args.ckpt_every,
                      checkpoint_dir=args.ckpt_dir,
                      keep=args.ckpt_keep, log_every=args.log_every),
        step_fn, pipe, put)

    t0 = time.time()
    losses = []

    def log(step, metrics):
        losses.append((step, metrics["loss"]))
        print(f"step {step:5d} loss {metrics['loss']:.4f} "
              f"gnorm {metrics['grad_norm']:.3f} "
              f"({(time.time()-t0)/max(step,1):.2f}s/step)", flush=True)

    state, final = trainer.run(params, opt, metrics_cb=log)
    print(f"done at step {final}; stragglers={len(trainer.straggler_steps)} "
          f"retries={trainer.retries}")
    if len(losses) >= 2:
        print(f"loss first->last: {losses[0][1]:.4f} -> {losses[-1][1]:.4f}")
    return {"arch": cfg.name, "n_params": M.n_elements(state["params"]),
            "batch": shape.global_batch, "seq": shape.seq_len,
            "final_step": final, "losses": losses,
            "step_s": trainer.step_times, "device_ms": trainer.device_ms,
            "stragglers": trainer.straggler_steps,
            "retries": trainer.retries}


if __name__ == "__main__":
    main()
