"""train_step / serve_step factories.

Port of ``repro/train/train_step.py`` for one device:

  train_step(params, opt_state, batch, step) -> (params, opt_state, metrics)
  serve_step(params, token, caches)          -> (logits, caches)

``mixed_precision`` (default: on when the compute dtype is bfloat16)
differentiates a bfloat16 cast copy of the f32 master params: each master
leaf requires grad and is cast with ``.to(bfloat16)``, whose backward
hands back the f32 gradient the reference casts its bfloat16 one to, and
AdamW updates the f32 masters under ``torch.no_grad``, in place
(``adamw.update``), as the reference's launcher donates them to the jitted
step: the step returns the tensors it was given.

On a mesh the masters and the moments are DTensors of their resolved
placements (``launch.specs.abstract_state``, ``utils.sharding.place_tree``)
and the batch is ``data.pipeline.put_batch(mesh=)``'s. The bf16 cast copy
keeps the masters' placements, so the parameter gathers that DTensor's
propagation makes move bf16; each gradient is redistributed to its
master's placements (a reduce-scatter of the partial sums) before AdamW,
and the metrics come back whole on every rank.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.common import Ctx
from repro_torch.optim import adamw
from repro_torch.utils import sharding as shd
from repro_torch.utils.tree import tree_leaves, tree_map


def make_train_step(cfg: ArchConfig, mesh=None, *,
                    compute_dtype=torch.bfloat16, remat: bool = True,
                    lr_schedule=None, adamw_cfg=adamw.AdamWConfig(),
                    mixed_precision: bool | None = None):
    """``train_step(params, opt_state, batch, step)``: one AdamW step on
    ``loss_fn``'s gradients at ``lr_schedule(step)``. ``batch`` holds
    tensors on the params' device. ``metrics``: the loss, ``nll``,
    ``aux``, ``ntok`` and the global norm of the (unclipped) gradients,
    as device tensors."""
    ctx = Ctx(compute_dtype=compute_dtype, mesh=mesh)
    lr_fn = lr_schedule or adamw.cosine_schedule(3e-4, 100, 10000)
    if mixed_precision is None:
        mixed_precision = compute_dtype == torch.bfloat16

    def train_step(params, opt_state, batch, step):
        with shd.region(mesh):
            return _step(params, opt_state, batch, step)

    def _step(params, opt_state, batch, step):
        with torch.enable_grad():
            masters = tree_map(lambda p: p.detach().requires_grad_(
                p.is_floating_point()), params)
            params_c = masters
            if mixed_precision:
                params_c = tree_map(lambda p: p.to(compute_dtype)
                                    if p.is_floating_point() else p, masters)
            loss, metrics = M.loss_fn(params_c, batch, ctx, cfg, remat=remat)
            leaves = [p for p in tree_leaves(masters) if p.requires_grad]
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_leaf = {id(p): g for p, g in zip(leaves, grads)}

        def grad_of(p):
            g = by_leaf.get(id(p))
            if g is None:
                return torch.zeros_like(p)
            return shd.to_placements(g, p.placements) if mesh is not None \
                else g
        grads = tree_map(grad_of, masters)
        with torch.no_grad():
            grad_norm = adamw.global_norm(grads)
            new_params, new_opt = adamw.update(
                params, grads, opt_state, lr_fn(step), adamw_cfg)
        metrics = dict({k: v.detach() for k, v in metrics.items()},
                       loss=loss.detach(), grad_norm=grad_norm)
        metrics = {k: shd.gather(v) for k, v in metrics.items()}
        return new_params, new_opt, metrics

    return train_step


def make_serve_step(cfg: ArchConfig, mesh=None, *,
                    compute_dtype=torch.bfloat16):
    """One-token decode step (the decode_32k / long_500k cells); the caches
    are written in place, as ``decode_step`` writes them."""
    ctx = Ctx(compute_dtype=compute_dtype, mesh=mesh)

    @torch.no_grad()
    def serve_step(params, token, caches, cross_kv=None):
        return M.decode_step(params, token, caches, ctx, cfg,
                             cross_kv=cross_kv)

    return serve_step


def make_prefill(cfg: ArchConfig, mesh=None, *, max_seq: int,
                 compute_dtype=torch.bfloat16):
    ctx = Ctx(compute_dtype=compute_dtype, mesh=mesh)

    @torch.no_grad()
    def prefill_step(params, tokens, frontend=None):
        return M.prefill(params, tokens, ctx, cfg, max_seq=max_seq,
                         frontend=frontend)

    return prefill_step
