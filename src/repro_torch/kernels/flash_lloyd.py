"""FlashLloyd — fused assignment + centroid statistics in one pass.

The kernel is ``csrc/flash_lloyd.cu`` (CUDA C++ for sm_90a); it replaces
the Pallas TPU kernel ``repro/kernels/flash_lloyd.py:flash_lloyd_raw``.
A persistent grid of about one CTA per SM holds the ``(K, d)`` f32 sums and
``(K,)`` counts in shared memory, so ``4 (K d + K)`` bytes plus the
kernel's static stages must fit the block's opt-in shared memory
(``core.heuristics.fused_footprint``); the planner
(``core.heuristics.choose_step_impl``) sends larger shapes to the two-pass
path and this wrapper raises on them.

``flash_lloyd_raw(x (B, N, d), c (B, K, d))`` returns ``(a int32 (B, N),
sums f32 (B, K, d), counts f32 (B, K), inertia f32 (B,))``. CPU tensors go
to ``flash_lloyd_plain``, CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_assign import check_xc, flash_assign_plain

TILE_N = 64   # points per CTA tile (csrc/common.cuh kTileN)
TILE_K = 64   # centroids per sweep step (kTileK)

launches = 0  # kernel launches (CUDA only); reset by callers that count


def flash_lloyd_plain(x: torch.Tensor, c: torch.Tensor):
    """Plain PyTorch version (``ref.lloyd_stats_ref`` math, batched)."""
    b, n, d = x.shape
    k = c.shape[1]
    a, score = flash_assign_plain(x, c)
    x32 = x.float()
    dist = torch.clamp(score + (x32 * x32).sum(-1), min=0.0)
    ids = (a.long() + k * torch.arange(b, device=x.device).unsqueeze(1))
    ids = ids.reshape(-1)
    sums = torch.zeros((b * k, d), dtype=torch.float32, device=x.device)
    sums.index_add_(0, ids, x32.reshape(-1, d))
    counts = torch.bincount(ids, minlength=b * k).float()
    return (a, sums.reshape(b, k, d), counts.reshape(b, k), dist.sum(-1))


def _default_grid(device: torch.device, n: int, b: int) -> int:
    """Persistent grid width: about one CTA per SM over the whole batch."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = max(1, math.ceil(n / TILE_N))
    return max(1, min(tiles, math.ceil(sms / max(1, b))))


def flash_lloyd_raw(x: torch.Tensor, c: torch.Tensor):
    """Fused Lloyd statistics over a batch: x (B, N, d), c (B, K, d)."""
    global launches
    check_xc(x, c, "flash_lloyd")
    if x.device.type == "cpu":
        return flash_lloyd_plain(x, c)
    if x.device.type != "cuda":
        raise ValueError(f"flash_lloyd: unsupported device {x.device}")
    b, n, d = x.shape
    k = c.shape[1]
    is_bf16 = x.dtype == torch.bfloat16
    need = 4 * (k * d + k) + _build.lloyd_static_smem(is_bf16)
    limit = _build.max_smem_optin(x.device.index or 0)
    if need > limit:
        raise ValueError(
            f"flash_lloyd: the (K={k}, d={d}) accumulator needs {need} bytes "
            f"of shared memory, over the block limit of {limit}; use the "
            "two-pass path (step_impl='two_pass')")
    x, c = x.contiguous(), c.contiguous()
    grid_x = _default_grid(x.device, n, b)
    dev = x.device
    a = torch.empty((b, n), dtype=torch.int32, device=dev)
    sums = torch.zeros((b, k, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((b, k), dtype=torch.float32, device=dev)
    part = torch.zeros((b, grid_x), dtype=torch.float32, device=dev)
    if n == 0:
        return a, sums, counts, part.sum(-1)
    csq = torch.empty((b, k), dtype=torch.float32, device=dev)
    code = _build.lib().fk_flash_lloyd(
        x.data_ptr(), c.data_ptr(), csq.data_ptr(), a.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), part.data_ptr(), b, n, k, d,
        grid_x, int(is_bf16), _build.stream_ptr(dev))
    _build.check(code, "flash_lloyd kernel launch")
    launches += 1
    return a, sums, counts, part.sum(-1)
