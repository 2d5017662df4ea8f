"""Sort-inverse update — contention-free centroid statistics.

The kernel is ``csrc/sort_inverse_update.cu`` (CUDA C++ for sm_90a); it
replaces the Pallas TPU kernel
``repro/kernels/sort_inverse_update.py:sort_inverse_update_raw`` and its
tile-pair list, which is a TPU artefact and is not ported. The prologue
(a stable sort of the assignment vector) stays in PyTorch, in
``ops.sort_inverse_update``, as the JAX prologue stays in XLA.

``sort_inverse_update_raw(x, sorted_idx, ids_sorted, num_segments)``
takes the flattened points ``x (R, d)``, the sorted cluster ids and the
point each came from, and returns ``(sums f32 (S, d), counts f32 (S,))``
with ``S = num_segments``; ids never seen stay exactly 0. CPU tensors go
to ``sort_inverse_update_plain``, CUDA tensors launch the kernel or raise.
Precondition (not checked, it would cost a device sync): ids are sorted
ascending and lie in ``[0, S)``, and ``sorted_idx`` lies in ``[0, R)``.
The kernel folds the partial sums of a cluster that crosses chunks in chunk
order (no atomics), so its result is the same bit for bit from run to run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_assign import DTYPES

launches = 0  # kernel launches (CUDA only); reset by callers that count
THREADS = 256  # threads per CTA (the kernels' __launch_bounds__)


def _check(x, sorted_idx, ids_sorted, num_segments, who):
    if x.ndim != 2 or x.dtype not in DTYPES:
        raise TypeError(f"{who}: x must be (R, d) float32/bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    r = x.shape[0]
    for name, t in (("sorted_idx", sorted_idx), ("ids_sorted", ids_sorted)):
        if t.dtype != torch.int32 or t.shape != (r,):
            raise TypeError(f"{who}: {name} must be int32 ({r},), got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{who}: {name} on {t.device}, x on {x.device}")
    if num_segments < 1 or r >= 2**31 or x.shape[1] >= 2**31:
        raise ValueError(f"{who}: bad sizes R={r}, S={num_segments}")


def sort_inverse_update_plain(x: torch.Tensor, sorted_idx: torch.Tensor,
                              ids_sorted: torch.Tensor, num_segments: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: gather the sorted rows, add them per id."""
    rows = x.index_select(0, sorted_idx.long()).float()
    ids = ids_sorted.long()
    sums = torch.zeros((num_segments, x.shape[1]), dtype=torch.float32,
                       device=x.device).index_add_(0, ids, rows)
    counts = torch.bincount(ids, minlength=num_segments).float()
    return sums, counts


def sort_inverse_update_raw(x: torch.Tensor, sorted_idx: torch.Tensor,
                            ids_sorted: torch.Tensor, num_segments: int, *,
                            chunk: int = 512, threads: int = THREADS
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Segment sums over the sorted order. ``chunk``: sorted rows per CTA;
    ``threads``: threads per CTA (a multiple of 32, at most 256), split
    into workers of whole rows (``layout``)."""
    global launches
    _check(x, sorted_idx, ids_sorted, num_segments, "sort_inverse_update")
    if x.device.type == "cpu":
        return sort_inverse_update_plain(x, sorted_idx, ids_sorted,
                                         num_segments)
    if x.device.type != "cuda":
        raise ValueError(f"sort_inverse_update: unsupported device {x.device}")
    if chunk < 1 or threads < 32 or threads > THREADS or threads % 32:
        raise ValueError(f"sort_inverse_update: chunk={chunk} must be >= 1 "
                         f"and threads={threads} a multiple of 32 <= "
                         f"{THREADS}")
    x = x.contiguous()
    r, d = x.shape
    # sums then counts in one allocation, zeroed by the launch's memset, then
    # each chunk's two edge slots for the ordered fold (not zeroed)
    edge = -(-r // chunk) * 2 * (d + 1)
    out = torch.empty(num_segments * (d + 1) + edge, dtype=torch.float32,
                      device=x.device)
    code = _build.lib().fk_sort_inverse_update(
        x.data_ptr(), sorted_idx.contiguous().data_ptr(),
        ids_sorted.contiguous().data_ptr(), out.data_ptr(), r, d,
        num_segments, chunk, threads, int(x.dtype == torch.bfloat16),
        _build.stream_ptr(x.device))
    _build.check(code, "sort_inverse_update kernel launch")
    launches += 1
    return (out[:num_segments * d].view(num_segments, d),
            out[num_segments * d:num_segments * (d + 1)])


def layout(d: int, itemsize: int, aligned: bool = True
           ) -> tuple[int, int, int]:
    """``(V, G, VPL)`` of a launch at width ``d``: elements per load (16
    bytes, or 1 on the scalar path for a ``d`` off the vector width or an
    unaligned ``x``), lanes per worker (the power of two covering the row's
    loads, at most 32) and loads per lane per slab of the feature axis
    (``csrc/sort_inverse_update.cu`` ``layout_for``)."""
    vw = 16 // itemsize
    v = vw if d % vw == 0 and aligned else 1
    nvec = d // v
    g = 1
    while g < nvec and g < 32:
        g <<= 1
    vpl = 1 if nvec <= 32 else (2 if nvec <= 64 else 4)
    return v, g, vpl


def smem_bytes(d: int, itemsize: int, chunk: int, threads: int = THREADS,
               aligned: bool = True) -> int:
    """Dynamic shared memory of one CTA: two boundary slots per worker of
    one slab's partial sums, the chunk's sorted ids and point indices, the
    slots' ids and row counts, and two flags."""
    v, g, vpl = layout(d, itemsize, aligned)
    e = 2 * (threads // g)
    return e * g * vpl * v * 4 + (2 * chunk + 2 * e + 2) * 4


def kernel_layout(d: int, chunk: int, threads: int, is_bf16: bool,
                  aligned: bool = True) -> tuple[int, int, int, int]:
    """``(smem bytes, V, G, VPL)`` as the compiled launcher computes them."""
    import ctypes
    out = (ctypes.c_int * 4)()
    _build.check(_build.lib().fk_sort_inverse_layout(
        d, chunk, threads, int(is_bf16), int(aligned), out),
        "fk_sort_inverse_layout")
    return tuple(int(v) for v in out)
