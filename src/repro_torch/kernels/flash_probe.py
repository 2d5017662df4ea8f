"""FlashProbe — fused distance + online top-L (the IVF search primitive).

The kernels are ``csrc/flash_probe.cu`` (CUDA C++ for sm_90a); they
replace the Pallas TPU kernels of ``repro/kernels/flash_probe.py``:

- ``flash_probe_raw`` (``flash_probe_kernel``): queries against one shared
  centroid set — the ``nprobe`` cell selection;
- ``flash_probe_grouped_raw`` (``flash_probe_grouped_kernel``): each query
  against its own gathered candidate block — the posting-list scan and
  the exact rescore;
- ``flash_probe_grouped_q8_raw`` (``flash_probe_grouped_q8_kernel``): the
  same scan over int8 residual codes with per-slot scales, dequantized in
  registers — the q8 proposal.

Each returns ``(indices int32 (B, l), scores f32 (B, l))``, ascending by
(score, index): equal scores go to the lower index, as ``lax.top_k``.
The port returns exactly ``l`` columns (the reference pads ``l`` to a
multiple of 8 and slices). ``splits`` is the number of CTAs that share
one query's candidate axis (``core.heuristics.choose_probe_splits``); the
result does not depend on it.

Dispatch is by the tensors' device: CPU tensors go to the ``*_plain``
versions (the same math in plain PyTorch, with a stable sort), CUDA
tensors launch the kernel or raise. ``launches`` counts kernel launches
per kernel name.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

TILE = 1024            # candidate rows per selection round (csrc kTile)
LIST_SMEM_MAX = 2048   # longest running list held in shared memory
DTYPES = (torch.float32, torch.bfloat16)

# kernel launches (CUDA only); reset by callers that count
launches = {"flash_probe": 0, "flash_probe_grouped": 0,
            "flash_probe_grouped_q8": 0}


def _topl(score: torch.Tensor, l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``l`` smallest entries of each row, ascending, ties to the lower
    index (a stable sort; ``torch.topk`` leaves tie order unspecified)."""
    v, i = torch.sort(score, dim=-1, stable=True)
    return i[:, :l].to(torch.int32).contiguous(), v[:, :l].contiguous()


def _check_l(l: int, c: int, who: str, axis: str) -> None:
    if l < 1:
        raise ValueError(f"{who} needs l >= 1, got l={l}")
    if l > c:
        raise ValueError(f"{who} needs l <= {axis}, got l={l} > {axis}={c}")


def _check_float(who: str, *ts: torch.Tensor) -> None:
    if ts[0].dtype not in DTYPES or any(t.dtype != ts[0].dtype for t in ts):
        raise TypeError(f"{who}: inputs must all be float32 or all bfloat16, "
                        f"got {[t.dtype for t in ts]}")


def _check_device(who: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"{who}: inputs on different devices "
                         f"{[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {dev}")
    return dev


def _launch_geometry(c: int, l: int, splits: int) -> tuple[int, int, int]:
    """(splits, chunk, lp): no split CTA is left without rows, and each
    keeps a partial list of ``lp = min(l, chunk)`` entries. ``splits`` is
    the grid's y dimension, at most 65,535."""
    splits = max(1, min(int(splits), c, 65535))
    chunk = -(-c // splits)
    splits = -(-c // chunk)
    return splits, chunk, min(l, chunk)


def _buffers(b: int, l: int, splits: int, lp: int, device):
    """Outputs, partial lists and the global list scratch the kernel needs
    (``None`` where a list fits shared memory). Returns the pointer tuple
    ``(out_v, out_i, part_v, part_i, lws_v, lws_i, mws_v, mws_i)`` and the
    tensors that own them."""
    f32, i32 = torch.float32, torch.int32
    out_v = torch.empty((b, l), dtype=f32, device=device)
    out_i = torch.empty((b, l), dtype=i32, device=device)
    keep = [out_v, out_i]
    if splits == 1:
        part_v, part_i = out_v, out_i
    else:
        part_v = torch.empty((b, splits, lp), dtype=f32, device=device)
        part_i = torch.empty((b, splits, lp), dtype=i32, device=device)
        keep += [part_v, part_i]

    def scratch(n_lists: int, length: int):
        if length <= LIST_SMEM_MAX:
            return None, None
        sv = torch.empty((n_lists, 2, length), dtype=f32, device=device)
        si = torch.empty((n_lists, 2, length), dtype=i32, device=device)
        keep.extend((sv, si))
        return sv, si

    lws = scratch(b * splits, lp)
    mws = scratch(b, l) if splits > 1 else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()
    ptrs = tuple(ptr(t) for t in (out_v, out_i, part_v, part_i, *lws, *mws))
    return ptrs, keep


# ---------------------------------------------------------------------------
# kernel 4: shared centroids
# ---------------------------------------------------------------------------

def flash_probe_plain(q: torch.Tensor, c: torch.Tensor, c_sq: torch.Tensor,
                      l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the ``(N, K)`` score ``c_sq - 2 q.c``, then a
    stable sort."""
    score = c_sq.float().unsqueeze(0) - 2.0 * torch.matmul(
        q.float(), c.float().t())
    return _topl(score, l)


def flash_probe_raw(q: torch.Tensor, c: torch.Tensor, c_sq: torch.Tensor,
                    l: int, *, splits: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-l centroids per query: q (N, d), c (K, d), c_sq (K,) f32 (the
    centroids' ``||c||^2``). Returns ``(indices int32 (N, l), scores f32
    (N, l))``, score ``||c||^2 - 2 q.c``."""
    if q.ndim != 2 or c.ndim != 2 or q.shape[1] != c.shape[1]:
        raise ValueError(f"flash_probe: q must be (N, d) and c (K, d), got "
                         f"{tuple(q.shape)} and {tuple(c.shape)}")
    n, d = q.shape
    k = c.shape[0]
    _check_l(l, k, "flash_probe", "K")
    _check_float("flash_probe", q, c)
    if c_sq.shape != (k,) or c_sq.dtype != torch.float32:
        raise TypeError(f"flash_probe: c_sq must be float32 ({k},), got "
                        f"{c_sq.dtype} {tuple(c_sq.shape)}")
    if _check_device("flash_probe", q, c, c_sq).type == "cpu":
        return flash_probe_plain(q, c, c_sq, l)
    if max(n, k, d) >= 2**31:
        raise ValueError("flash_probe: dims must fit int32")
    if n == 0:
        return (torch.empty((0, l), dtype=torch.int32, device=q.device),
                torch.empty((0, l), dtype=torch.float32, device=q.device))
    q, c, c_sq = q.contiguous(), c.contiguous(), c_sq.contiguous()
    splits, chunk, lp = _launch_geometry(k, l, splits)
    ptrs, keep = _buffers(n, l, splits, lp, q.device)
    code = _build.lib().fk_flash_probe(
        q.data_ptr(), c.data_ptr(), c_sq.data_ptr(), *ptrs, n, k, d, l,
        splits, chunk, lp, int(q.dtype == torch.bfloat16),
        _build.stream_ptr(q.device))
    _build.check(code, "flash_probe kernel launch")
    launches["flash_probe"] += 1
    return keep[1], keep[0]


# ---------------------------------------------------------------------------
# kernel 5: per-query candidate blocks
# ---------------------------------------------------------------------------

def flash_probe_grouped_plain(q: torch.Tensor, c: torch.Tensor, l: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: per query, ``||c||^2 - 2 q.c`` over its own
    block, then a stable sort."""
    c32 = c.float()
    cross = torch.matmul(c32, q.float().unsqueeze(-1)).squeeze(-1)
    return _topl((c32 * c32).sum(-1) - 2.0 * cross, l)


def flash_probe_grouped_raw(q: torch.Tensor, c: torch.Tensor, l: int, *,
                            splits: int = 1
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-l of each query's own candidates: q (B, d), c (B, C, d).
    Returns ``(indices int32 (B, l) into the candidate axis, scores f32
    (B, l))``, score ``||c||^2 - 2 q.c``."""
    if (q.ndim != 2 or c.ndim != 3 or c.shape[0] != q.shape[0]
            or c.shape[2] != q.shape[1]):
        raise ValueError(f"flash_probe_grouped: q must be (B, d) and c "
                         f"(B, C, d), got {tuple(q.shape)} and "
                         f"{tuple(c.shape)}")
    b, cn, d = c.shape
    _check_l(l, cn, "flash_probe_grouped", "C")
    _check_float("flash_probe_grouped", q, c)
    if _check_device("flash_probe_grouped", q, c).type == "cpu":
        return flash_probe_grouped_plain(q, c, l)
    if max(b, cn, d) >= 2**31:
        raise ValueError("flash_probe_grouped: dims must fit int32")
    if b == 0:
        return (torch.empty((0, l), dtype=torch.int32, device=q.device),
                torch.empty((0, l), dtype=torch.float32, device=q.device))
    q, c = q.contiguous(), c.contiguous()
    splits, chunk, lp = _launch_geometry(cn, l, splits)
    ptrs, keep = _buffers(b, l, splits, lp, q.device)
    code = _build.lib().fk_flash_probe_grouped(
        q.data_ptr(), c.data_ptr(), *ptrs, b, cn, d, l, splits, chunk, lp,
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(code, "flash_probe_grouped kernel launch")
    launches["flash_probe_grouped"] += 1
    return keep[1], keep[0]


# ---------------------------------------------------------------------------
# kernel 6: int8 residual codes
# ---------------------------------------------------------------------------

def flash_probe_grouped_q8_plain(qp: torch.Tensor, codes: torch.Tensor,
                                 scales: torch.Tensor, l: int
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``||q'||^2 - 2 q'.r + ||r||^2`` with ``r =
    float(code) * s``, +inf where ``s`` is not positive, over the flattened
    (nprobe, W) axis; then a stable sort."""
    b, p, w, d = codes.shape
    r = codes.float() * scales.unsqueeze(-1)
    cross = torch.matmul(r, qp.unsqueeze(-1)).squeeze(-1)      # (B, P, W)
    qsq = (qp * qp).sum(-1, keepdim=True)
    score = qsq - 2.0 * cross + (r * r).sum(-1)
    score = torch.where(scales > 0.0, score,
                        torch.full_like(score, float("inf")))
    return _topl(score.reshape(b, p * w), l)


def flash_probe_grouped_q8_raw(qp: torch.Tensor, codes: torch.Tensor,
                               scales: torch.Tensor, l: int, *,
                               splits: int = 1
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized scan: qp (B, nprobe, d) f32 shifted queries, codes (B,
    nprobe, W, d) int8, scales (B, nprobe, W) f32 (0 on empty slots).
    Returns ``(indices int32 (B, l) over the flattened nprobe*W axis,
    distances f32 (B, l))``; empty slots score +inf and sort last, by
    index."""
    if (codes.ndim != 4 or qp.shape != (codes.shape[0], codes.shape[1],
                                        codes.shape[3])
            or scales.shape != codes.shape[:3]):
        raise ValueError(f"flash_probe_grouped_q8: qp (B, P, d), codes "
                         f"(B, P, W, d), scales (B, P, W) expected, got "
                         f"{tuple(qp.shape)}, {tuple(codes.shape)}, "
                         f"{tuple(scales.shape)}")
    b, p, w, d = codes.shape
    _check_l(l, p * w, "flash_probe_grouped_q8", "nprobe*W")
    if (qp.dtype != torch.float32 or codes.dtype != torch.int8
            or scales.dtype != torch.float32):
        raise TypeError(f"flash_probe_grouped_q8: qp f32, codes int8, scales "
                        f"f32 expected, got {qp.dtype}, {codes.dtype}, "
                        f"{scales.dtype}")
    if _check_device("flash_probe_grouped_q8", qp, codes,
                     scales).type == "cpu":
        return flash_probe_grouped_q8_plain(qp, codes, scales, l)
    if max(b, p * w, d) >= 2**31:
        raise ValueError("flash_probe_grouped_q8: dims must fit int32")
    if b == 0:
        return (torch.empty((0, l), dtype=torch.int32, device=qp.device),
                torch.empty((0, l), dtype=torch.float32, device=qp.device))
    qp, codes, scales = qp.contiguous(), codes.contiguous(), \
        scales.contiguous()
    splits, chunk, lp = _launch_geometry(p * w, l, splits)
    ptrs, keep = _buffers(b, l, splits, lp, qp.device)
    qsq = torch.empty((b, p), dtype=torch.float32, device=qp.device)
    code = _build.lib().fk_flash_probe_grouped_q8(
        qp.data_ptr(), codes.data_ptr(), scales.data_ptr(), qsq.data_ptr(),
        *ptrs, b, p, w, d, l, splits, chunk, lp,
        _build.stream_ptr(qp.device))
    _build.check(code, "flash_probe_grouped_q8 kernel launch")
    launches["flash_probe_grouped_q8"] += 1
    return keep[1], keep[0]


def kernel_attrs() -> dict[str, tuple[int, int]]:
    """``(registers per thread, local bytes)`` of each compiled kernel, as
    the card reports them (for the planner's register model)."""
    import ctypes
    out = {}
    for which, name in enumerate(("flash_probe", "flash_probe_grouped",
                                  "flash_probe_grouped_q8", "topl_merge")):
        regs, local = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(_build.lib().fk_flash_probe_attrs(
            which, ctypes.byref(regs), ctypes.byref(local)),
            "cudaFuncGetAttributes")
        out[name] = (int(regs.value), int(local.value))
    return out
