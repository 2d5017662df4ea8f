"""The port's copy of the repo's one symmetric-int8 convention.

Port of ``repro/core/quant8.py``:

    scale = max(absmax / 127, SCALE_EPS)        # per block / row / cell
    q     = clip(round(x / scale), -127, 127)   # int8, symmetric
    x'    = float32(q) * scale

``torch.round`` rounds half to even, as ``jnp.round`` does, and every step
is one IEEE float32 operation, so codes and decoded values equal the JAX
package's bit for bit on the same inputs.
"""
from __future__ import annotations

import torch

# Guards scale against all-zero blocks; small enough that any real
# payload's absmax/127 dominates it.
SCALE_EPS = 1e-12


def symmetric_scale(absmax: torch.Tensor) -> torch.Tensor:
    """Per-block scale from a per-block absmax (any shape)."""
    return torch.clamp(absmax.float() / 127.0, min=SCALE_EPS)


def quantize_symmetric(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize ``x`` with a broadcastable ``scale`` -> int8 codes."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_symmetric(q: torch.Tensor, scale: torch.Tensor
                         ) -> torch.Tensor:
    """Decode int8 codes with a broadcastable ``scale`` -> float32."""
    return q.float() * scale
