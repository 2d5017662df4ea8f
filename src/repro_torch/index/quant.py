"""Bucket payload codecs — the cheap-propose half of two-phase search.

Port of ``repro/index/quant.py``. ``Fp32Codec`` is the identity layout;
``Int8ResidualCodec`` stores per-slot symmetric int8 codes of the residual
``x - anchor[cell]`` plus one f32 scale per slot (``d + 4`` bytes a row
instead of ``4 d``). The quantized scan only proposes candidates; search
rescores them at full precision. Rounding follows ``core.quant8``, so the
codes equal the JAX package's bit for bit.
"""
from __future__ import annotations

import os

import torch

from repro_torch.core.quant8 import (dequantize_symmetric, quantize_symmetric,
                                     symmetric_scale)

CODEC_KINDS = ("fp32", "q8")


def default_codec_kind() -> str:
    """Process-wide default codec: ``REPRO_BUCKET_CODEC`` env, else fp32."""
    kind = os.environ.get("REPRO_BUCKET_CODEC", "fp32").strip().lower()
    if kind not in CODEC_KINDS:
        raise ValueError(f"REPRO_BUCKET_CODEC={kind!r}: "
                         f"expected one of {CODEC_KINDS}")
    return kind


class Codec:
    """Contract: ``encode(points, centroid) -> (codes, scales)`` with codes
    of ``pool_dtype`` and one f32 scale per row; ``decode`` inverts it;
    ``score_bytes(d)`` is the modeled bytes per scanned row."""

    kind: str = "fp32"
    pool_dtype = torch.float32

    def encode(self, points: torch.Tensor, centroid: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def decode(self, codes: torch.Tensor, scales: torch.Tensor,
               centroid: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def score_bytes(self, d: int) -> int:
        raise NotImplementedError

    def meta(self) -> dict:
        return {"kind": self.kind}


class Fp32Codec(Codec):
    """Identity codec: payload rows are the f32 points themselves."""

    kind = "fp32"
    pool_dtype = torch.float32

    def encode(self, points, centroid):
        points = points.float()
        return points, torch.ones(points.shape[:-1], dtype=torch.float32,
                                  device=points.device)

    def decode(self, codes, scales, centroid):
        return codes.float()

    def score_bytes(self, d: int) -> int:
        return 4 * d


class Int8ResidualCodec(Codec):
    """Per-slot symmetric int8 over the residual ``x - centroid[c]``. The
    scale is strictly positive for real rows (``SCALE_EPS`` floor) and
    exactly 0.0 on empty slots, which is how the scan masks padding."""

    kind = "q8"
    pool_dtype = torch.int8

    def encode(self, points, centroid):
        resid = points.float() - centroid
        scale = symmetric_scale(resid.abs().amax(dim=-1))
        return quantize_symmetric(resid, scale.unsqueeze(-1)), scale

    def decode(self, codes, scales, centroid):
        return centroid + dequantize_symmetric(codes, scales.unsqueeze(-1))

    def score_bytes(self, d: int) -> int:
        return d + 4


def make_codec(kind: str | None = None) -> Codec:
    kind = default_codec_kind() if kind is None else kind
    if kind == "fp32":
        return Fp32Codec()
    if kind == "q8":
        return Int8ResidualCodec()
    raise ValueError(f"unknown codec kind {kind!r}: "
                     f"expected one of {CODEC_KINDS}")
