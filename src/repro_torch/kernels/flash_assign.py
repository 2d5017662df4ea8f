"""FlashAssign — fused distance + online-argmin assignment.

The kernel is ``csrc/flash_assign.cu`` (CUDA C++ for sm_90a); it replaces
the Pallas TPU kernel ``repro/kernels/flash_assign.py:flash_assign_raw``.
``flash_assign_raw`` dispatches by the tensors' device: CPU tensors go to
``flash_assign_plain`` (the same math in plain PyTorch), CUDA tensors
launch the kernel or raise.

Both return ``(a int32 (B, N), score f32 (B, N))`` for x ``(B, N, d)`` and
c ``(B, K, d)``, where ``score = ||c_a||^2 - 2 x.c_a`` (add ``||x||^2`` for
the true squared distance). Ties go to the lower centroid index.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

TILE_N = 64   # points per CTA (csrc/common.cuh kTileN)
TILE_K = 64   # centroids per sweep step (kTileK)
DTYPES = (torch.float32, torch.bfloat16)

launches = 0  # kernel launches (CUDA only); reset by callers that count


def check_xc(x: torch.Tensor, c: torch.Tensor, who: str) -> None:
    """Shared input contract of the assign and fused kernels."""
    if x.ndim != 3 or c.ndim != 3:
        raise ValueError(f"{who}: x must be (B, N, d) and c (B, K, d), got "
                         f"{tuple(x.shape)} and {tuple(c.shape)}")
    if x.shape[0] != c.shape[0] or x.shape[2] != c.shape[2]:
        raise ValueError(f"{who}: batch or feature dims differ: "
                         f"{tuple(x.shape)} vs {tuple(c.shape)}")
    if c.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError(f"{who}: needs K >= 1 and d >= 1")
    if x.dtype not in DTYPES or c.dtype != x.dtype:
        raise TypeError(f"{who}: x and c must both be float32 or bfloat16, "
                        f"got {x.dtype} and {c.dtype}")
    if x.device != c.device:
        raise ValueError(f"{who}: x on {x.device} but c on {c.device}")
    if max(x.shape[1], c.shape[1], x.shape[2], x.shape[0]) >= 2**31:
        raise ValueError(f"{who}: dims must fit int32")


def flash_assign_plain(x: torch.Tensor, c: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch FlashAssign (``ref.assign_ref_crossterm`` math)."""
    c32 = c.float()
    csq = (c32 * c32).sum(-1)
    score = csq.unsqueeze(-2) - 2.0 * torch.matmul(x.float(),
                                                   c32.transpose(-1, -2))
    a = torch.argmin(score, dim=-1)  # first occurrence on ties
    m = torch.gather(score, -1, a.unsqueeze(-1)).squeeze(-1)
    return a.to(torch.int32), m


def flash_assign_raw(x: torch.Tensor, c: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """FlashAssign over a batch: x (B, N, d), c (B, K, d)."""
    global launches
    check_xc(x, c, "flash_assign")
    if x.device.type == "cpu":
        return flash_assign_plain(x, c)
    if x.device.type != "cuda":
        raise ValueError(f"flash_assign: unsupported device {x.device}")
    x, c = x.contiguous(), c.contiguous()
    b, n, d = x.shape
    k = c.shape[1]
    a = torch.empty((b, n), dtype=torch.int32, device=x.device)
    m = torch.empty((b, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return a, m
    csq = torch.empty((b, k), dtype=torch.float32, device=x.device)
    code = _build.lib().fk_flash_assign(
        x.data_ptr(), c.data_ptr(), csq.data_ptr(), a.data_ptr(),
        m.data_ptr(), b, n, k, d, int(x.dtype == torch.bfloat16),
        _build.stream_ptr(x.device))
    _build.check(code, "flash_assign kernel launch")
    launches += 1
    return a, m
