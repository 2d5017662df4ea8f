"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro/optim/adamw.py`` with the reference's own update (l.45-66),
not ``torch.optim.AdamW``'s: the bias corrections divide ``m`` and ``v``
before the square root, ``eps`` is added after it, and the decay is
``lr * wd * p`` inside the step. The state mirrors the parameter tree,
``{"m", "v", "count"}`` (``count`` a 0-dim int32 tensor on the parameters'
device), so ``checkpoint.Checkpointer`` saves it as the reference saves
its own. The bias corrections stay on the device: an update reads nothing
back to the host.

``update`` writes the new parameters and moments into the tensors it is
given, and ``clip_by_global_norm`` scales the gradients in place, as the
reference's launcher donates its buffers to the jitted step: a step
allocates no second copy of the parameters or the moments.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params: Any) -> dict:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32 (a 0-dim tensor)."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in leaves))


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """Scales ``tree``'s leaves in place so that their global norm is at
    most ``max_norm``. Returns (``tree``, the norm before)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(tree):
        g.mul_(scale)
    return tree, norm


def update(params: Any, grads: Any, state: dict, lr,
           cfg: AdamWConfig = AdamWConfig()) -> tuple[Any, dict]:
    """One AdamW step, written into ``params`` and ``state``'s moments
    (``grads`` is clipped in place); ``lr`` a float or a 0-dim tensor.
    Returns (``params``, the new state: the same moments, the next
    count)."""
    if cfg.clip_norm:
        clip_by_global_norm(grads, cfg.clip_norm)
    count = state["count"] + 1
    b1c = 1.0 - torch.pow(cfg.b1, count.float())
    b2c = 1.0 - torch.pow(cfg.b2, count.float())
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay

    def upd(p, g, m, v):
        # a function, so that a leaf's temporaries are freed before the
        # next leaf's are made
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / b1c).div_(torch.sqrt(v / b2c).add_(eps))
        p.sub_(step.add_(wd * p).mul_(lr))

    for leaves in zip(*map(tree_leaves, (params, grads, state["m"],
                                         state["v"]))):
        upd(*leaves)
    return params, {"m": state["m"], "v": state["v"], "count": count}


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1):
    """Linear warmup to ``base_lr``, then a cosine down to ``min_frac`` of
    it: ``lr(step) -> float``, computed in float32 as the reference's."""
    f32 = np.float32

    def lr(step) -> float:
        s = f32(step)
        warm = f32(base_lr) * np.minimum(s / f32(max(warmup, 1)), f32(1.0))
        prog = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(min_frac) + f32((1 - min_frac) * 0.5) * (
            f32(1.0) + np.cos(f32(np.pi) * prog))
        return float(warm if s < warmup else f32(base_lr) * cos)
    return lr
