"""The training batch's shapes and dtypes.

Port of ``train_batch_specs`` of ``repro/launch/specs.py`` (l.164-176)
without its shardings: the parameter, cache and batch sharding trees wait
for the mesh half of the LM path (ROADMAP.md, queue A item 8a) and the
dry-run (item 8d).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.common import not_ported


def train_batch_specs(cfg: ArchConfig, shape: ShapeSpec, mesh=None) -> dict:
    """``{name: (shape, dtype)}`` of a training batch: tokens and labels
    (B, S_text) int32 (phi-3-vision's patches take ``frontend_seq`` of the
    sequence), and the frontend (B, F, D) f32 where the config has one."""
    if mesh is not None:
        raise not_ported("the training batch's shardings")
    b, s = shape.global_batch, shape.seq_len
    s_text = s
    if cfg.frontend and cfg.family != "audio":
        s_text = s - cfg.frontend_seq
    batch = {"tokens": ((b, s_text), torch.int32),
             "labels": ((b, s_text), torch.int32)}
    if cfg.frontend:
        batch["frontend"] = ((b, cfg.frontend_seq, cfg.d_model),
                             torch.float32)
    return batch
