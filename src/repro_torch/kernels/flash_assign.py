"""FlashAssign — fused distance + online-argmin assignment.

The kernel is ``csrc/flash_assign.cu`` (CUDA C++ for sm_90a, ``wgmma`` on
the tensor cores: 3xTF32 for float32 inputs, bf16 for bfloat16 inputs; TMA
loads into a ring of shared-memory stages); it replaces the Pallas TPU
kernel ``repro/kernels/flash_assign.py:flash_assign_raw``.
``flash_assign_raw`` dispatches by the tensors' device: CPU tensors go to
``flash_assign_plain`` (the same function in plain PyTorch), CUDA tensors
launch the kernel or raise.

Both return ``(a int32 (B, N), m f32 (B, N))`` for x ``(B, N, d)`` and
c ``(B, K, d)``, where ``m = ||c_a||^2 - 2 x.c_a`` (the score) or, with
``want_dists``, the true squared distance ``max(m + ||x||^2, 0)``. The
kernel sums that ``||x||^2`` from the x chunks its consumers read for the
argmin, so no pass over x follows it. Ties go to the lower centroid index.
``score_tol`` bounds how far the kernel's scores may lie from the plain
version's, ``dist_tol`` its distances.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

TILE_N = 128   # points per CTA: two warpgroups of 64 rows (csrc kBM)
TILE_K = 128   # centroids per tile, the wgmma N (kBN)
ROW_BYTES = 128  # feature bytes of a stage row: the 128-byte swizzle
RES_CHUNKS = 4   # x stays in shared memory while d * itemsize <= 4 * 128
STAGES = {4: 3, 2: 4}  # depth of the TMA ring by input itemsize (f32, bf16)
DTYPES = (torch.float32, torch.bfloat16)
U32 = 2.0 ** -24  # fp32 unit roundoff

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


def flash_assign_plain(x: torch.Tensor, c: torch.Tensor,
                       want_dists: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch FlashAssign (``ref.assign_ref_crossterm`` math); with
    ``want_dists`` the score plus ``||x||^2``, clamped at 0, as the JAX
    package's ``ops.flash_assign`` adds it."""
    c32 = c.float()
    csq = (c32 * c32).sum(-1)
    score = csq.unsqueeze(-2) - 2.0 * torch.matmul(x.float(),
                                                   c32.transpose(-1, -2))
    a = torch.argmin(score, dim=-1)  # first occurrence on ties
    m = torch.gather(score, -1, a.unsqueeze(-1)).squeeze(-1)
    if want_dists:
        x32 = x.float()
        m = torch.clamp(m + (x32 * x32).sum(-1), min=0.0)  # fp residue
    return a.to(torch.int32), m


def score_tol(x: torch.Tensor, c: torch.Tensor) -> float:
    """Bound on ``|kernel score - plain score|`` for x ``(B, N, d)``, c
    ``(B, K, d)``: the kernel's worst-case error plus the plain version's.

    With ``u = 2^-24``, ``P = sum_j |x_j c_j| <= ||x|| ||c||`` and
    ``mag = max ||c||^2 + 2 max ||x|| max ||c||`` (which bounds ``|score|``):

    - plain (fp32 products and sums rounded to nearest, ``d`` terms):
      ``||c||^2`` is off by ``d u ||c||^2``, ``x.c`` by ``d u P``, the final
      ``csq - 2 x.c`` by ``u |score|``: in all ``(d + 1) u mag``;
    - kernel, float32 (3xTF32): a split ``v = hi + lo + r`` leaves
      ``|r| <= 2^-22 |v|``, so the three products miss ``x.c`` by at most
      ``3 * 2^-22 P = 12 u P`` (the dropped ``x_lo c_lo`` and the two ``r``).
      The ``3 d`` tf32 products are exact in fp32; the tensor core's
      accumulation is not documented to round to nearest, so each of the
      ``3 d`` additions may truncate (``2 u`` of the running sum):
      ``6 d u P``. With ``csq`` as above and the subtraction:
      ``(6 d + 13) u mag``;
    - kernel, bfloat16: bf16 products are exact in fp32; ``d`` truncating
      additions give ``2 d u P``: ``(2 d + 1) u mag``.

    Zero padding of the feature axis adds exact zeros and changes no term.
    """
    return (_kernel_terms(x) + x.shape[-1] + 1) * U32 * _mag(x, c)[0]


def _mag(x: torch.Tensor, c: torch.Tensor) -> tuple[float, float]:
    """``(mag, max ||x||^2)``: ``mag = max ||c||^2 + 2 max ||x|| max ||c||``
    bounds ``|score|``."""
    cn = torch.linalg.vector_norm(c.float(), dim=-1).max()
    xn = torch.linalg.vector_norm(x, dim=-1, dtype=torch.float32).max()
    return float(cn * cn + 2 * xn * cn), float(xn * xn)


def _kernel_terms(x: torch.Tensor) -> int:
    d = x.shape[-1]
    return 6 * d + 13 if x.dtype == torch.float32 else 2 * d + 1


def sq_chain(d: int, itemsize: int) -> int:
    """Roundings on the path of one row's ``||x||^2`` in the kernel: each of
    the 8 threads that hold a row's 16-byte pieces of a stage row (the
    128-byte swizzle) adds the squares of its ``16 / itemsize`` values of
    each of the ``ceil(d itemsize / 128)`` chunks into one fp32
    accumulator, one FMA (one rounding) a value; a xor tree of 3 additions
    then sums the 8 pieces. The zeros of the padded tail add exactly."""
    chunks = -(-d * itemsize // ROW_BYTES)
    return 16 // itemsize * chunks + 3


def dist_tol(x: torch.Tensor, c: torch.Tensor) -> float:
    """Bound on ``|kernel distance - plain distance|`` (``want_dists``), for
    x ``(B, N, d)``, c ``(B, K, d)``.

    Both sides take ``max(m + ||x||^2, 0)``, a 1-Lipschitz clamp, so the
    difference is at most the scores' (``score_tol``) plus the two
    ``||x||^2`` errors plus the rounding of the two final additions. With
    ``u = 2^-24`` and ``X = max ||x||^2``, a sum of non-negative terms
    whose path has ``h`` roundings misses by at most ``h u X / (1 - h u)``:

    - kernel: ``h = sq_chain(d, itemsize)`` (the fused square-adds of a
      thread's piece, then the xor tree), at most ``d / 8 + 11``;
    - plain: ``(x * x).sum(-1)``, ``d`` rounded products and at most
      ``d - 1`` additions on any path of its reduction: ``h = 2 d``;
    - the additions ``m + ||x||^2``: ``u (|m| + X) <= u (mag + X)`` each.

    So ``score_tol + (h_kernel + 2 d + 2) u X (1 + 1/64) + 2 u mag``; the
    factor covers ``1 / (1 - h u)`` for any ``h u <= 1/64`` (``d`` up to
    ``2^17``). The bf16 values widen to fp32 exactly on both sides.
    """
    d = x.shape[-1]
    mag, xsq = _mag(x, c)
    h = sq_chain(d, x.element_size()) + 2 * d + 2
    return score_tol(x, c) + (h * xsq * (1 + 1 / 64) + 2 * mag) * U32


def pad_features(x: torch.Tensor, c: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Contiguous x and c whose feature axis TMA can read: rows of a
    multiple of 16 bytes (d % 4 == 0 in f32, d % 8 == 0 in bf16). Other d
    are copied into zero-padded ``(B, ., d_pad)`` buffers; zero columns
    change no dot product and no norm. The main paths (d = 128, 512) never
    pay the copy."""
    d = x.shape[-1]
    align = 16 // x.element_size()
    pad = -d % align
    if pad == 0:
        return x.contiguous(), c.contiguous()
    return F.pad(x, (0, pad)), F.pad(c, (0, pad))


def flash_assign_raw(x: torch.Tensor, c: torch.Tensor, *,
                     want_dists: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """FlashAssign over a batch: x (B, N, d), c (B, K, d). Returns the
    scores, or with ``want_dists`` the squared distances."""
    global launches
    check_xc(x, c, "flash_assign")
    if x.device.type == "cpu":
        return flash_assign_plain(x, c, want_dists)
    if x.device.type != "cuda":
        raise ValueError(f"flash_assign: unsupported device {x.device}")
    b, n, _ = x.shape
    k = c.shape[1]
    a = torch.empty((b, n), dtype=torch.int32, device=x.device)
    m = torch.empty((b, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return a, m
    x, c = pad_features(x, c)
    d = x.shape[-1]
    is_bf16 = x.dtype == torch.bfloat16
    # ||c||^2, padded with +inf to a multiple of the kernel's centroid tile
    csq = torch.empty((b, -(-k // TILE_K) * TILE_K), dtype=torch.float32,
                      device=x.device)
    # f32: the centroids' tf32 split (c_hi, c_lo), written by the prologue
    split = torch.empty((0 if is_bf16 else 2, b, k, d), dtype=torch.float32,
                        device=x.device)
    code = _build.lib().fk_flash_assign(
        x.data_ptr(), c.data_ptr(), csq.data_ptr(), split.data_ptr(),
        a.data_ptr(), m.data_ptr(), b, n, k, d, int(is_bf16),
        int(want_dists), _build.stream_ptr(x.device))
    _build.check(code, "flash_assign kernel launch")
    launches += 1
    return a, m
