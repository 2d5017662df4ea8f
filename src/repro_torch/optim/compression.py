"""Statistics compression for slow (cross-pod) links.

Port of ``quantize_int8``, ``dequantize_int8`` and
``ef_quantized_allreduce`` of ``repro/optim/compression.py`` (l.30-70).
``ef_quantized_allreduce`` is error-feedback int8 compression: each rank
quantizes its residual-corrected contribution to int8 with per-block
scales, the int8 payload and its f32 scales are all-gathered over one mesh
axis (``P * n`` bytes on the wire instead of the ``~8 n`` of an f32 ring
all-reduce), and every rank dequantizes and sums them. The quantization
error is fed back into the next call's input, so the scheme is unbiased
over time. The distributed Lloyd loop uses it for the cross-pod ``(sums,
counts)`` reduction (``ParallelContext.make_kmeans_fit(compress_pod_axis=)``).

The gather goes through the ``ParallelContext`` that owns the mesh (its
``all_gather``): this module calls no collective itself. The rounding and
scale rule is the port's ``core.quant8``, bit for bit the JAX package's.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant8 import (dequantize_symmetric, quantize_symmetric,
                                     symmetric_scale)

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8: ``x`` of any shape -> ``(q (blocks, 256)
    int8, scales (blocks,) f32)``; the flattened ``x`` is zero-padded to a
    whole block."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = symmetric_scale(blocks.abs().amax(dim=1))
    return quantize_symmetric(blocks, scale.unsqueeze(1)), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape
                    ) -> torch.Tensor:
    """Inverse of ``quantize_int8``: f32 of ``shape``."""
    flat = dequantize_symmetric(q, scale.unsqueeze(1)).reshape(-1)
    n = 1
    for s in shape:
        n *= int(s)
    return flat[:n].reshape(tuple(shape))


def ef_quantized_allreduce(x: torch.Tensor, err: torch.Tensor,
                           axis_name: str, *, pctx
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce of this rank's ``x`` over the mesh
    axis ``axis_name`` of ``pctx`` (a ``core.parallel.ParallelContext``).
    Returns ``(sum f32 of x's shape, the new error-feedback residual)``;
    the sum is the same on every rank of the axis."""
    xe = x.float() + err
    q, scale = quantize_int8(xe)
    new_err = xe - dequantize_int8(q, scale, x.shape)
    qg = pctx.all_gather(q, axis_name)          # int8 on the wire
    sg = pctx.all_gather(scale, axis_name)      # the f32 sidecar
    total = dequantize_int8(qg[0], sg[0], x.shape)
    for p in range(1, qg.shape[0]):
        total = total + dequantize_int8(qg[p], sg[p], x.shape)
    return total, new_err
