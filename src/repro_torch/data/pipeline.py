"""Deterministic synthetic data pipeline.

Port of ``repro/data/pipeline.py``. Every batch is a pure function of
``(seed, step)``: the same numpy draw from ``SeedSequence([seed, step])``
as the reference, so its batches are the JAX package's bit for bit, and
after a restart the pipeline resumes at exactly the same batch (what
makes a checkpoint restart bitwise reproducible). Tokens are drawn from a
Zipfian distribution so MoE routing and the clustering see realistic skew
rather than uniform noise.

``put_batch`` places a host batch on one device, or on a mesh (the
reference's ``shard_batch``): every rank makes the same global batch from
the same seed and keeps its own slice of it, by ``launch.specs``'
``BATCH_SPECS``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.utils import sharding as shd


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 50304
    batch: int = 8
    seq_len: int = 256
    frontend_seq: int = 0
    d_model: int = 0
    zipf_a: float = 1.2


class SyntheticPipeline:
    """Host-side numpy batches; ``put_batch`` moves them to the device."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        # zipf over the vocab (clipped)
        z = rng.zipf(cfg.zipf_a, size=(cfg.batch, cfg.seq_len + 1))
        tokens_full = (z - 1) % cfg.vocab_size
        tokens = tokens_full[:, :-1].astype(np.int32)
        labels = tokens_full[:, 1:].astype(np.int32)
        out = {"tokens": tokens, "labels": labels}
        if cfg.frontend_seq:
            out["frontend"] = rng.standard_normal(
                (cfg.batch, cfg.frontend_seq, cfg.d_model)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def pipeline_for(arch: ArchConfig, shape: ShapeSpec, *, seed: int = 0,
                 batch_override: int | None = None,
                 seq_override: int | None = None) -> SyntheticPipeline:
    seq = seq_override or shape.seq_len
    text_seq = seq - (arch.frontend_seq if (arch.frontend
                                            and arch.family != "audio") else 0)
    return SyntheticPipeline(DataConfig(
        seed=seed,
        vocab_size=arch.vocab_size,
        batch=batch_override or shape.global_batch,
        seq_len=text_seq,
        frontend_seq=arch.frontend_seq if arch.frontend else 0,
        d_model=arch.d_model,
    ))


def put_batch(batch: dict, device, *, mesh=None) -> dict:
    """A host numpy batch as tensors on ``device`` (tokens and labels
    int32, the frontend f32); a copy to a CUDA device goes from pinned
    memory without a host sync. On a mesh each leaf becomes a DTensor of
    its ``BATCH_SPECS`` placements, the rank copying only its own slice of
    the global batch it was given."""
    from repro_torch.launch.specs import BATCH_SPECS
    dev = torch.device(device)
    rules = None if mesh is None else shd.rules_for_mesh(mesh)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        pl = None
        if mesh is not None:
            pl = shd.placements(shd.resolve_spec(BATCH_SPECS[k], t.shape,
                                                 mesh, rules), mesh)
            t = shd.local_slice(t, mesh, pl).contiguous()
        t = (t.pin_memory().to(dev, non_blocking=True)
             if dev.type == "cuda" else t.to(dev))
        if pl is not None:
            t = shd.global_of(t, mesh, pl, v.shape)
        out[k] = t
    return out
