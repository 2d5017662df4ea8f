"""Training launcher of the port, the counterpart of
``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --device cpu --steps 5

  # granite-moe-1b-a400m at full width and depth on the card
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-moe-1b-a400m --batch 4 --steps 20 --ckpt-every 10

  # a 2x2 data x model mesh, one rank a card
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m \\
      repro_torch.launch.train --arch llama3-8b --reduced --mesh 2x2

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
``--mesh DATAxMODEL``, ``--production-mesh`` (16x16) and ``--multi-pod``
(2x16x16) build the mesh through ``launch.mesh`` over the world
``torchrun`` started (a world of another size raises ``build_mesh``'s
``ValueError``, which names the ranks the mesh needs): the params and
moments are placed by their resolved spec trees, each rank keeps its
slice of every batch, and the ``Trainer`` agrees its decisions over the
mesh; only world rank 0 prints. ``main`` returns a summary: every logged
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
from repro_torch.core.parallel import ParallelContext, release_world
from repro_torch.data.pipeline import pipeline_for, put_batch
from repro_torch.launch.mesh import make_production_mesh, parse_mesh_flag
from repro_torch.launch.specs import train_batch_specs
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.utils import sharding as shd
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


def _mesh(args, device_type: str):
    """The mesh the flags ask for (``--mesh`` overrides the production
    meshes), or None: one device."""
    if args.mesh:
        return parse_mesh_flag(args.mesh, device_type=device_type)
    if args.production_mesh or args.multi_pod:
        return make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=device_type)
    return None


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    try:
        return _main(args)
    finally:
        if args.mesh or args.production_mesh or args.multi_pod:
            release_world()   # the process group the mesh flag started


def _main(args) -> dict:
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
    mesh = _mesh(args, dev.type)
    pctx = None if mesh is None else ParallelContext.for_mesh(mesh)
    say = print if pctx is None or pctx.is_world_rank0 else \
        (lambda *a, **k: None)
    say(f"arch={cfg.name} params~{cfg.n_params()/1e6:.1f}M device={dev} "
        f"mesh={None if mesh is None else tuple(mesh.shape)} "
        f"batch={shape.global_batch} seq={shape.seq_len}", flush=True)

    # --- state: every rank draws the same params and keeps its slice
    params = M.init_model(cfg, seed=args.seed, device=dev,
                          max_pos=max(shape.seq_len, 1024))
    if mesh is not None:
        params = shd.place_tree(params, M.model_specs(cfg), mesh)
    opt = adamw.init(params)
    compute_dtype = torch.float32 if args.reduced else torch.bfloat16
    step_fn = make_train_step(
        cfg, mesh, compute_dtype=compute_dtype, remat=not args.reduced,
        lr_schedule=adamw.cosine_schedule(args.lr, 10, args.steps))
    specs = train_batch_specs(cfg, shape)
    pipe = pipeline_for(cfg, shape, seed=args.seed)

    def put(batch):
        got = {k: tuple(v.shape) for k, v in batch.items()}
        want = {k: s for k, (s, _) in specs.items()}
        if got != want:
            raise ValueError(f"batch shapes {got} are not {want}")
        return put_batch(batch, dev, mesh=mesh)

    trainer = Trainer(
        TrainerConfig(total_steps=args.steps,
                      checkpoint_every=args.ckpt_every,
                      checkpoint_dir=args.ckpt_dir,
                      keep=args.ckpt_keep, log_every=args.log_every),
        step_fn, pipe, put, pctx=pctx)

    t0 = time.time()
    losses = []

    def log(step, metrics):
        losses.append((step, metrics["loss"]))
        say(f"step {step:5d} loss {metrics['loss']:.4f} "
            f"gnorm {metrics['grad_norm']:.3f} "
            f"({(time.time()-t0)/max(step,1):.2f}s/step)", flush=True)

    state, final = trainer.run(params, opt, metrics_cb=log)
    say(f"done at step {final}; stragglers={len(trainer.straggler_steps)} "
        f"retries={trainer.retries}")
    if len(losses) >= 2:
        say(f"loss first->last: {losses[0][1]:.4f} -> {losses[-1][1]:.4f}")
    return {"arch": cfg.name, "n_params": M.n_elements(state["params"]),
            "batch": shape.global_batch, "seq": shape.seq_len,
            "final_step": final, "losses": losses,
            "step_s": trainer.step_times, "device_ms": trainer.device_ms,
            "stragglers": trainer.straggler_steps,
            "retries": trainer.retries,
            "mesh": None if mesh is None else tuple(mesh.shape),
            "state": state}


if __name__ == "__main__":
    main()
