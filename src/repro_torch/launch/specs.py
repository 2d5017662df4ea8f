"""Abstract inputs and logical sharding specs for the launchers and the
dry-run: parameters, optimizer state, batches and decode caches as shapes
on the meta device (never materialized), with their mesh-resolved
placements.

Port of ``repro/launch/specs.py`` (l.24-213). Where the reference returns
``ShapeDtypeStruct``s and ``NamedSharding``s, the port returns meta tensors
(or ``(shape, dtype)`` pairs for a batch) and trees of DTensor placement
lists (``utils.sharding.named_tree`` of the resolved specs).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.utils import sharding as shd
from repro_torch.utils.tree import tree_map


# ---------------------------------------------------------------------------
# logical specs for batches and caches
# ---------------------------------------------------------------------------

BATCH_SPECS = {
    "tokens": ("dp", None),
    "labels": ("dp", None),
    "frontend": ("dp", None, None),
}


def _cache_leaf_specs(kv_heads_shardable: bool) -> dict:
    """Cache specs (without the leading stacked-groups dim).

    When kv_heads divides the model axis the model axis goes on heads
    (classic TP decode); otherwise the *sequence / cluster-capacity*
    dimension is split over the model axis (flash-decoding-style split-KV),
    so GQA archs with few KV heads (starcoder2 kv=2, llama3 kv=8) still
    shard their caches.
    """
    if kv_heads_shardable:
        return {
            "k": ("dp", None, "tp", None),
            "v": ("dp", None, "tp", None),
            "centroids": ("dp", "tp", "sp", None),
            "bk": ("dp", "tp", "sp", None, None),
            "bv": ("dp", "tp", "sp", None, None),
            "bcount": ("dp", "tp", "sp"),
            "cweight": ("dp", "tp", "sp"),
            "recent_k": ("dp", "tp", None, None),
            "recent_v": ("dp", "tp", None, None),
            "append_k": ("dp", None, "tp", None),
            "append_v": ("dp", None, "tp", None),
            "latent": ("dp", "mdl", None),
            "k_rope": ("dp", "mdl", None),
            "ssm": ("dp", "tp", None, None),
            "conv": ("dp", None, "tp"),
        }
    return {
        "k": ("dp", "mdl", None, None),
        "v": ("dp", "mdl", None, None),
        # clustered cache: clusters over the data axis, head_dim over the
        # model axis
        "centroids": ("dp", None, "sp", "mdl"),
        "bk": ("dp", None, "sp", None, "mdl"),
        "bv": ("dp", None, "sp", None, "mdl"),
        "bcount": ("dp", None, "sp"),
        "cweight": ("dp", None, "sp"),
        "recent_k": ("dp", None, None, "mdl"),
        "recent_v": ("dp", None, None, "mdl"),
        "append_k": ("dp", None, None, None),
        "append_v": ("dp", None, None, None),
        "latent": ("dp", "mdl", None),
        "k_rope": ("dp", "mdl", None),
        "ssm": ("dp", "tp", None, None),
        "conv": ("dp", None, "tp"),
    }


def cache_logical_specs(cache_tree: Any,
                        kv_heads_shardable: bool = True) -> Any:
    """Logical spec tree matching a (stacked-groups) cache tree: a leaf
    takes its table entry (after the groups' dim) by the name of the last
    dict key on its path; a 0- or 1-dim leaf is replicated; any other
    splits its batch dim (after the groups') over ``"dp"``."""
    table = _cache_leaf_specs(kv_heads_shardable)

    def spec(name, leaf):
        nd = leaf.ndim
        base = table.get(name)
        if base is not None and len(base) == nd - 1:
            return (None, *base)
        if nd <= 1:
            return (None,) * nd
        return (None, "dp") + (None,) * (nd - 2)

    def walk(t, name):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v, name) for v in t)
        return spec(name, t)

    return walk(cache_tree, "")


def resolve(logical_tree: Any, shape_tree: Any, mesh) -> Any:
    """The placements tree of ``logical_tree`` resolved over the shapes of
    ``shape_tree`` on ``mesh``."""
    return shd.named_tree(shd.resolve_tree(logical_tree, shape_tree, mesh),
                          mesh)


# ---------------------------------------------------------------------------
# abstract model state
# ---------------------------------------------------------------------------

def abstract_state(cfg: ArchConfig, mesh, *, max_pos: int = 32768,
                   with_opt: bool = True, params_dtype=None):
    """Meta tensors + placements for the params (and the AdamW state).

    ``params_dtype``: override the stored floating-point parameter dtype
    (serving keeps bf16 weights, so that the parameter gathers move half
    the bytes)."""
    params = M.init_model(cfg, device="meta", max_pos=max_pos)
    if params_dtype is not None:
        params = tree_map(lambda t: t.to(params_dtype)
                          if t.is_floating_point() else t, params)
    shardings = resolve(M.model_specs(cfg), params, mesh)
    if not with_opt:
        return params, shardings
    opt = {"m": params, "v": params,
           "count": torch.empty((), dtype=torch.int32, device="meta")}
    opt_shardings = {"m": shardings, "v": shardings,
                     "count": shd.placements((), mesh)}
    return params, shardings, opt, opt_shardings


# ---------------------------------------------------------------------------
# abstract batches / caches per shape cell
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh=None):
    """``{name: (shape, dtype)}`` of a training batch: tokens and labels
    (B, S_text) int32 (phi-3-vision's patches take ``frontend_seq`` of the
    sequence), and the frontend (B, F, D) f32 where the config has one.
    With a mesh, ``(batch, placements)`` as the reference returns them."""
    b, s = shape.global_batch, shape.seq_len
    s_text = s
    if cfg.frontend and cfg.family != "audio":
        s_text = s - cfg.frontend_seq
    batch = {"tokens": ((b, s_text), torch.int32),
             "labels": ((b, s_text), torch.int32)}
    if cfg.frontend:
        batch["frontend"] = ((b, cfg.frontend_seq, cfg.d_model),
                             torch.float32)
    if mesh is None:
        return batch
    rules = shd.rules_for_mesh(mesh)
    return batch, {k: shd.placements(shd.resolve_spec(
        BATCH_SPECS[k], v[0], mesh, rules), mesh) for k, v in batch.items()}


def decode_inputs_specs(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
                        mode: str, dtype=torch.bfloat16):
    """(token, token placements, caches, cache placements, cross_kv, its
    placements): meta tensors and placement trees."""
    b, s = shape.global_batch, shape.seq_len
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    token_sh = shd.placements(shd.resolve_spec(("dp", None), (b, 1), mesh),
                              mesh)
    caches = M.init_decode_caches(cfg, b, s, mode=mode, dtype=dtype,
                                  device="meta")
    kv_shardable = cfg.num_kv_heads % shd.axis_size(mesh, "model") == 0
    cache_sh = resolve(cache_logical_specs(caches, kv_shardable), caches,
                       mesh)
    cross = cross_sh = None
    if cfg.cross_attention:
        subs, n_groups = T.group_layout(cfg)
        hd = cfg.resolved_head_dim
        kv = (n_groups, b, cfg.frontend_seq, cfg.num_kv_heads, hd)
        cross = {f"{i}_{sub}": {
            "k": torch.empty(kv, dtype=dtype, device="meta"),
            "v": torch.empty(kv, dtype=dtype, device="meta")}
            for i, sub in enumerate(subs)}
        cross_sh = resolve(cache_logical_specs(cross), cross, mesh)
    return token, token_sh, caches, cache_sh, cross, cross_sh


def decode_mode_for(cfg: ArchConfig, shape: ShapeSpec) -> str:
    """dense cache for decode_32k; clustered (kmeans) for long_500k on
    attention archs (recurrent archs keep their state caches)."""
    if shape.name != "long_500k":
        return "dense"
    if cfg.family == "ssm":
        return "dense"            # pure recurrent states
    return "clustered"
