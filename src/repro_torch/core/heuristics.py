"""Cache-aware kernel heuristics (paper §4.3), re-derived for Hopper.

The paper picks GPU kernel configurations analytically from the cache and
shared-memory sizes and the problem shape instead of exhaustive autotuning.
This module is the port's closed-form chooser: the shared-memory
footprint of each CUDA kernel, the per-iteration HBM byte models, the
block choice, and the fused-vs-two-pass crossover. It is also the single
source of the hardware constants the roofline uses.

Footprints are bytes of shared memory one CTA needs. The assign and fused
kernels stream the feature axis through ``16``-column stages, so their
tile cost does not grow with ``d``; only the fused kernel's resident
``(K, d)`` f32 accumulator does, and it must fit the block's opt-in limit
(232,448 bytes on sm_90) — a much narrower window than the TPU's VMEM.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.kernels.ops import BlockConfig

_STAGE_D = 16        # feature columns per shared stage (csrc/common.cuh)
_STAGE_PAD = 4       # row padding of the stages
_FUSED_THREADS = 256


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    smem_block_bytes: int    # shared memory one block may opt in to
    num_sms: int
    l2_bytes: int
    flops_f32: float         # fp32 FMA peak on CUDA cores, FLOP/s
    flops_bf16: float        # dense bf16 tensor-core peak, FLOP/s
    hbm_bw: float            # device memory bytes/s
    hbm_bytes: int


def hopper_row(name: str = "h100_sxm", *, num_sms: int = 132,
               l2_bytes: int = 50 * 2**20, smem_block_bytes: int = 232_448,
               flops_f32: float = 67e12, flops_bf16: float = 989e12,
               hbm_bw: float = 3.35e12, hbm_bytes: int = 80 * 10**9
               ) -> Hardware:
    """A Hopper row; defaults are the H100 SXM data sheet. ``detect_hardware``
    fills the SM count, L2 and shared-memory limit from the card itself;
    tests build rows with explicit values."""
    return Hardware(name=name, smem_block_bytes=smem_block_bytes,
                    num_sms=num_sms, l2_bytes=l2_bytes, flops_f32=flops_f32,
                    flops_bf16=flops_bf16, hbm_bw=hbm_bw, hbm_bytes=hbm_bytes)


H100 = hopper_row()
# device="cpu": the kernels run as their plain versions there, which have
# no tile limits. The row plans as the H100 does, so a CPU run takes the
# same dispatch (fused or two-pass, same tiles) as the card would.
CPU = dataclasses.replace(H100, name="cpu")


def _pow2_floor(v: int) -> int:
    return 1 << (max(1, int(v)).bit_length() - 1)


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def assign_footprint(bn: int, bk: int, d: int, bytes_in: int) -> int:
    """Shared bytes of one FlashAssign CTA: the two f32 feature stages plus
    the tile's (min, argmin) pair. Independent of ``d`` and the input
    type (stages hold f32)."""
    return 4 * _STAGE_D * (bn + _STAGE_PAD + bk + _STAGE_PAD) + bn * 8


def update_footprint(bn: int, bk: int, d: int, bytes_in: int) -> int:
    """Shared bytes of one sort-inverse CTA: its chunk of sorted ids and
    point indices (``bn`` rows); the segment sums live in registers."""
    return 2 * bn * 4


def fused_footprint(bn: int, bk: int, d: int, bytes_in: int,
                    k_pad: int) -> int:
    """Shared bytes of one FlashLloyd CTA: the resident f32 ``(K, d)`` sums
    and ``(K,)`` counts (``k_pad = K``: the port does not pad K), the
    assign stages, and the per-warp inertia slots. The ``4·K·d`` term is
    the constraint the two-pass path does not have."""
    return (4 * (k_pad * d + k_pad) + assign_footprint(bn, bk, d, bytes_in)
            + 4 * (_FUSED_THREADS // 32))


# --- per-iteration HBM traffic models -------------------------------------

def assign_bytes_flash(n: int, k: int, d: int, b: int = 4) -> float:
    """FlashAssign: read X and C once, write ||c||^2, assignments and
    min-scores."""
    return (n * d + k * d) * b + k * 4 + 2 * n * 4


def update_bytes_sort_inverse(n: int, k: int, d: int, b: int = 4,
                              chunk: int = 512) -> float:
    """Sort of the 4-byte ids (keys and indices in and out), one gathered
    read of X, the sorted ids/indices read by the kernel, and one atomic
    per (segment, column): at most ``n / chunk + k`` segments."""
    sort_io = 4 * n * 4
    gather = n * d * b + 2 * n * 4
    atomics = (n / max(1, chunk) + k) * (d + 1) * 4
    return sort_io + gather + atomics


def lloyd_bytes_fused(n: int, k: int, d: int, b: int = 4,
                      grid: int = 1) -> float:
    """FlashLloyd: read X and C once, write assignments, and flush each of
    the ``grid`` CTAs' (K, d) + (K,) accumulators once."""
    return (n * d + k * d) * b + n * 4 + grid * (k * d + k) * 4


def fused_grid(n: int, hw: Hardware) -> int:
    return max(1, min(hw.num_sms, -(-n // 64)))


def choose_step_impl(n: int, k: int, d: int, *, dtype_bytes: int = 4,
                     hw: Hardware = H100,
                     blk: BlockConfig | None = None) -> str:
    """Fused-vs-two-pass crossover rule.

    ``"fused"`` requires both legs:

    1. *feasibility* — the FlashLloyd CTA's shared memory (``4·(K·d+K)``
       plus the stages) fits the block limit; the two-pass kernels hold
       no ``K``-sized state and scale to any ``K·d``;
    2. *roofline win* — one kernel's time (the argmin flops or its bytes,
       plus every CTA's accumulator flush) beats the summed two-pass
       stages (the same argmin, then the sort and the gathered read).

    Both paths do their flops as fp32 FMAs on the CUDA cores, whatever the
    input type, so the compute leg uses ``hw.flops_f32``.
    """
    if blk is None:
        blk = choose_blocks(n, k, d, dtype_bytes=dtype_bytes, hw=hw)
    if fused_footprint(blk.fused_block_n, blk.fused_block_k, d,
                       dtype_bytes, k) > hw.smem_block_bytes:
        return "two_pass"
    peak, bw = hw.flops_f32, hw.hbm_bw
    flops = 2.0 * n * k * d
    t_fused = max(flops / peak, lloyd_bytes_fused(
        n, k, d, dtype_bytes, fused_grid(n, hw)) / bw)
    t_assign = max(flops / peak, assign_bytes_flash(n, k, d, dtype_bytes) / bw)
    t_update = update_bytes_sort_inverse(n, k, d, dtype_bytes,
                                         blk.update_block_n) / bw
    return "fused" if t_fused <= t_assign + t_update else "two_pass"


def choose_blocks(n: int, k: int, d: int, *, dtype_bytes: int = 4,
                  hw: Hardware = H100) -> BlockConfig:
    """Closed-form block selection — zero search.

    The assign and fused tiles are the kernels' compiled 64 x 64. The
    sort-inverse CTA takes as many sorted rows as keeps about four CTAs per
    SM busy (fewer segment atomics per row the longer the chunk), between
    128 and 1024, and one thread per feature column up to 256.
    """
    chunk = _pow2_floor(max(1, n) // (4 * hw.num_sms))
    chunk = min(1024, max(128, chunk))
    threads = min(256, max(32, _pow2_ceil(d)))
    return BlockConfig(update_block_n=chunk, update_block_k=threads)


def max_fused_k(d: int, hw: Hardware = H100) -> int:
    """Largest K whose FlashLloyd accumulator fits one CTA at width d."""
    fixed = fused_footprint(64, 64, d, 4, 0)
    return max(0, math.floor((hw.smem_block_bytes - fixed) / (4 * (d + 1))))
