"""Exhaustive tile tuner — the baseline the closed-form planner is held to
(paper Fig. 5), and the backend of ``KernelPlanner``'s
``refine="measure"`` (``fold_measured`` folds a ``TuneReport`` into the
plan cache, so the oracle tiles are paid for once).

Port of ``repro/core/autotune.py``'s contract, not of its TPU candidate
grid. On this card FlashAssign and FlashLloyd are compiled for one tile
(``BlockConfig``'s defaults, ``kernels/ops.py``), so the assignment is
timed once, at that tile. The pair that is free is the sort-inverse
update's (sorted rows per CTA, threads per CTA): ``update_block_n`` in
powers of two from ``heuristics.UPDATE_MIN_CHUNK`` to ``UPDATE_MAX_CHUNK``
times ``update_block_k`` in multiples of 32 up to
``sort_inverse_update.THREADS``, each kept only if ``ops._audit_blocks``
accepts it. The update is timed as its kernel, on ids sorted once (the
sort prologue is the same for every candidate).

On the card candidates are timed by CUDA events after a warm-up launch; on
the CPU the plain versions run at the reference's capped size, timed by
the host clock (their time does not depend on the tiles).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import heuristics
from repro_torch.kernels import ops
from repro_torch.kernels import sort_inverse_update as _siu
from repro_torch.kernels.ops import BlockConfig


@dataclasses.dataclass
class TuneReport:
    """``best``: the oracle tiles; ``num_compiles``: the candidates timed
    (the library is built once, so none is compiled: the name is the
    reference's); ``table``: ``(kind, block_n, block_k) -> microseconds``."""
    best: BlockConfig
    num_compiles: int
    tune_seconds: float
    best_assign_us: float
    best_update_us: float
    table: dict


def update_candidates(d: int, itemsize: int, device) -> list[tuple[int, int]]:
    """The sort-inverse tile pairs the kernel takes at width ``d``."""
    out = []
    bn = heuristics.UPDATE_MIN_CHUNK
    while bn <= heuristics.UPDATE_MAX_CHUNK:
        for bk in range(32, _siu.THREADS + 1, 32):
            try:
                ops._audit_blocks("update", bn, bk, d, itemsize, device)
            except ValueError:
                continue
            out.append((bn, bk))
        bn *= 2
    return out


REPS = 5


def _time_us(fn, device) -> float:
    fn()                                          # warm-up
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        return (time.perf_counter() - t0) / REPS * 1e6
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(REPS):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / REPS * 1e3


def exhaustive_tune(n: int, k: int, d: int, *, dtype=torch.float32,
                    device=None, cpu_time_cap: int = 4096) -> TuneReport:
    """Time every candidate on random data of this shape (seed 0), each
    ``REPS`` times after a warm-up; ``device=None`` means ``"cuda"``."""
    from repro_torch.core.kmeans import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        n = min(n, cpu_time_cap)
        k = min(k, cpu_time_cap // 8)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    c = torch.randn((k, d), generator=gen, device=dev).to(dtype)
    itemsize = x.element_size()
    table: dict = {}
    t0 = time.perf_counter()

    bn_a, bk_a = BlockConfig().assign_block_n, BlockConfig().assign_block_k
    us_a = _time_us(lambda: ops.flash_assign(x, c, block_n=bn_a,
                                             block_k=bk_a), dev)
    table[("assign", bn_a, bk_a)] = us_a
    a, _ = ops.flash_assign(x, c, block_n=bn_a, block_k=bk_a)
    ids_sorted, order = torch.sort(a, stable=True)
    order = order.to(torch.int32)
    best_u, best_u_us = None, float("inf")
    for bn, bk in update_candidates(d, itemsize, dev):
        us = _time_us(lambda bn=bn, bk=bk: _siu.sort_inverse_update_raw(
            x, order, ids_sorted, k, chunk=bn, threads=bk), dev)
        table[("update", bn, bk)] = us
        if us < best_u_us:
            best_u, best_u_us = (bn, bk), us
    return TuneReport(
        best=BlockConfig(assign_block_n=bn_a, assign_block_k=bk_a,
                         update_block_n=best_u[0], update_block_k=best_u[1]),
        num_compiles=len(table), tune_seconds=time.perf_counter() - t0,
        best_assign_us=us_a, best_update_us=best_u_us, table=table)


def heuristic_tune(n: int, k: int, d: int, *, dtype=torch.float32,
                   hw: heuristics.Hardware | None = None) -> TuneReport:
    """The paper's path: the closed-form tiles through a fresh memory-only
    ``KernelPlanner`` (the timed quantity is the production planning
    path), one build of each kernel (``num_compiles`` 2, as the
    reference counts). ``hw=None``: the card's row."""
    from repro_torch.core import plan as _plan
    t0 = time.perf_counter()
    planner = _plan.KernelPlanner(hw, persist=False)
    blk = planner.block_config(n, k, d, dtype.itemsize)
    return TuneReport(best=blk, num_compiles=2,
                      tune_seconds=time.perf_counter() - t0,
                      best_assign_us=float("nan"),
                      best_update_us=float("nan"), table={})
