"""Cache-aware kernel heuristics (paper §4.3), re-derived for Hopper.

The paper picks GPU kernel configurations analytically from the cache and
shared-memory sizes and the problem shape instead of exhaustive autotuning.
This module is the port's closed-form chooser: the shared-memory
footprint of each CUDA kernel, the per-iteration HBM byte models, the
block choice, and the fused-vs-two-pass crossover. It is also the single
source of the hardware constants the roofline uses.

Footprints are bytes of shared memory one CTA needs. FlashAssign and
FlashLloyd share one tensor-core argmin (``csrc/tc_argmin.cuh``) that
streams the feature axis through a ring of ``128``-byte stages (TMA);
FlashAssign's footprint depends on the input type and on whether its point
tile stays resident (``d <= 128`` in f32, ``<= 256`` in bf16). FlashLloyd
streams x with the centroids through a 128 KiB ring and keeps its f32
``(K, d)`` sums beside it, spread over a thread-block cluster of ``C``
CTAs (``choose_lloyd_cluster``): a slice of ``ceil(K / C)`` rows must fit
each CTA's opt-in limit (232,448 bytes on sm_90) with the ring.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.kernels import flash_assign as _fa
from repro_torch.kernels import flash_lloyd as _fl
from repro_torch.kernels import flash_probe as _fp
from repro_torch.kernels import sort_inverse_update as _siu
from repro_torch.kernels.ops import BlockConfig

_THREADS_PER_SM = 2048
# sort-inverse update (csrc/sort_inverse_update.cu): threads per CTA, the
# resident CTAs per SM that each layout's __launch_bounds__ guarantees (by
# 16-byte loads per lane: 1 -> 3, 2 -> 2, 4 -> 1), and the chunk range
UPDATE_THREADS = _siu.THREADS
UPDATE_MIN_BLOCKS = {1: 3, 2: 2, 4: 1}
UPDATE_MIN_CHUNK = 64
UPDATE_MAX_CHUNK = 2048
# FlashLloyd beyond FlashAssign's argmin, measured on the card by
# chip_smoke.py (lloyd_times: device times, NVIDIA H100 80GB HBM3 at 700 W):
# its row additions in values (rows x d) a second, by input itemsize, at
# K = 16 (one centroid tile, where the argmin hides little of them); and for
# f32 the re-split of its streamed x, in values a second for each centroid
# tile after the first (FlashAssign keeps x resident), at B 32 x N 65,536 x
# K 1,024. PERF.md names the run that measured them.
LLOYD_ADD_RATE = {4: 3.18e11, 2: 2.53e11}
LLOYD_SPLIT_RATE = 3.02e11
# The two-pass step's stable sort of its ids (``ops._sort_inverse``,
# ``torch.sort``: a radix sort of several launches), as device time
# ``SORT_FLOOR_S + n / SORT_RATE``: fitted to chip_smoke.py's
# ``sort_device_ms`` at n = 65,536 and 8,388,608 (0.0398 and 0.4372 ms; it
# predicts n = 262,144 and 2,097,152 within 2%), NVIDIA H100 80GB HBM3 at
# 700 W; PERF.md names the run.
SORT_RATE = 2.09e10
SORT_FLOOR_S = 3.67e-5


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    smem_block_bytes: int    # shared memory one block may opt in to
    num_sms: int
    l2_bytes: int
    flops_f32: float         # fp32 FMA peak on CUDA cores, FLOP/s
    flops_tf32: float        # dense TF32 tensor-core peak, FLOP/s
    flops_bf16: float        # dense bf16 tensor-core peak, FLOP/s
    hbm_bw: float            # device memory bytes/s
    hbm_bytes: int


def hopper_row(name: str = "h100_sxm", *, num_sms: int = 132,
               l2_bytes: int = 50 * 2**20, smem_block_bytes: int = 232_448,
               flops_f32: float = 67e12, flops_tf32: float = 495e12,
               flops_bf16: float = 989e12,
               hbm_bw: float = 3.35e12, hbm_bytes: int = 80 * 10**9
               ) -> Hardware:
    """A Hopper row; defaults are the H100 SXM data sheet. ``detect_hardware``
    fills the SM count, L2 and shared-memory limit from the card itself;
    tests build rows with explicit values."""
    return Hardware(name=name, smem_block_bytes=smem_block_bytes,
                    num_sms=num_sms, l2_bytes=l2_bytes, flops_f32=flops_f32,
                    flops_tf32=flops_tf32, flops_bf16=flops_bf16,
                    hbm_bw=hbm_bw, hbm_bytes=hbm_bytes)


H100 = hopper_row()
# device="cpu": the kernels run as their plain versions there, which have
# no tile limits. The row plans as the H100 does, so a CPU run takes the
# same dispatch (fused or two-pass, same tiles) as the card would.
CPU = dataclasses.replace(H100, name="cpu")


def _pow2_floor(v: int) -> int:
    return 1 << (max(1, int(v)).bit_length() - 1)


def _pow2_ceil(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def assign_footprint(bn: int, bk: int, d: int, bytes_in: int,
                     dists: bool = False) -> int:
    """Dynamic shared bytes of one FlashAssign CTA (the attribute its launch
    sets; ``csrc/flash_assign.cu`` ``Cfg``). Tiles are rows of 128 bytes of
    features: x in ``bn`` rows (for f32 also its tf32 low part, split in
    place), the centroids in ``bk`` rows (``c_hi`` and ``c_lo`` for f32,
    ``c`` for bf16). While ``d`` (padded to 16 bytes) fits ``RES_CHUNKS``
    rows, the x tile stays resident and each ring stage holds centroids
    only; otherwise each stage holds both. Plus two mbarriers per stage,
    1,024 bytes to align to the swizzle's period and, for the launch that
    returns distances (``dists``), the ``bn`` rows' f32 ``||x||^2``."""
    split = 2 if bytes_in == 4 else 1
    stages = _fa.STAGES[bytes_in]
    d_pad = d + (-d % (16 // bytes_in))
    resident = d_pad * bytes_in <= _fa.RES_CHUNKS * _fa.ROW_BYTES
    x_res = split * _fa.RES_CHUNKS * _fa.ROW_BYTES * bn if resident else 0
    x_stage = 0 if resident else split * _fa.ROW_BYTES * bn
    stage = x_stage + split * _fa.ROW_BYTES * bk
    return x_res + stages * (stage + 2 * 8) + 1024 + (4 * bn if dists else 0)


def update_footprint(bn: int, bk: int, d: int, bytes_in: int) -> int:
    """Dynamic shared bytes of one sort-inverse CTA of ``bk`` threads over
    ``bn`` sorted rows (``csrc/sort_inverse_update.cu``): the chunk's ids
    and point indices, and two boundary slots per worker holding one slab
    of partial sums; the running sums live in registers."""
    return _siu.smem_bytes(d, bytes_in, bn, bk)


def update_ctas_per_sm(d: int, bytes_in: int, chunk: int,
                       hw: Hardware) -> int:
    """Resident sort-inverse CTAs per SM: the least of the thread limit, the
    register cap of the layout's ``__launch_bounds__`` (``UPDATE_MIN_BLOCKS``
    by loads per lane) and shared memory."""
    vpl = _siu.layout(d, bytes_in)[2]
    by_threads = _THREADS_PER_SM // UPDATE_THREADS
    by_smem = hw.smem_block_bytes // update_footprint(
        chunk, UPDATE_THREADS, d, bytes_in)
    return max(1, min(by_threads, UPDATE_MIN_BLOCKS[vpl], by_smem))


def fused_footprint(k: int, d: int, bytes_in: int, cluster: int) -> int:
    """Dynamic shared bytes of one FlashLloyd CTA in a cluster of
    ``cluster`` CTAs (``flash_lloyd.smem_bytes``): the 128 KiB argmin ring,
    its alignment, the published ids and the adders' lists, and a slice of
    ``ceil(K / C)`` rows of the f32 sums and counts at the padded width.
    The slice is the term the two-pass path does not have."""
    return _fl.smem_bytes(k, d, bytes_in, cluster)


def choose_lloyd_cluster(k: int, d: int, bytes_in: int = 4,
                         hw: Hardware = H100) -> int | None:
    """The smallest cluster size C in ``flash_lloyd.CLUSTERS`` whose slice
    fits beside the ring (``fused_footprint <= hw.smem_block_bytes``), or
    None past ``C = 8``'s window: with fewer CTAs a cluster each round's
    adders read fewer published tiles and keep shorter lists (C = 2 beat
    C = 4 at smallN_smallK f32 on the H100, ``PERF.md``)."""
    for cluster in _fl.CLUSTERS:
        if fused_footprint(k, d, bytes_in, cluster) <= hw.smem_block_bytes:
            return cluster
    return None


def max_fused_k(d: int, bytes_in: int = 4, cluster: int = 8,
                hw: Hardware = H100) -> int:
    """Largest K whose FlashLloyd slice fits one CTA of a cluster of
    ``cluster`` at width d."""
    dp = _fl.padded_d(d, bytes_in)
    room = hw.smem_block_bytes - fused_footprint(0, d, bytes_in, cluster)
    return max(0, room // (4 * (dp + 1))) * cluster


# --- per-iteration HBM traffic models -------------------------------------

def assign_bytes_flash(n: int, k: int, d: int, b: int = 4) -> float:
    """FlashAssign: read X and C once, write ||c||^2, assignments and
    min-scores."""
    return (n * d + k * d) * b + k * 4 + 2 * n * 4


def update_bytes_sort_inverse(n: int, k: int, d: int, b: int = 4,
                              chunk: int = 512) -> float:
    """Sort of the 4-byte ids (keys and indices in and out), one gathered
    read of X, the sorted ids/indices read by the kernel, the memset and the
    one write of the ``(K, d + 1)`` outputs, and at most two atomics per CTA
    per column (a chunk's first and last segment)."""
    sort_io = 4 * n * 4
    gather = n * d * b + 2 * n * 4
    out = 2 * k * (d + 1) * 4
    atomics = 2 * -(-n // max(1, chunk)) * (d + 1) * 4
    return sort_io + gather + out + atomics


def sort_seconds(n: int) -> float:
    """Device time of the two-pass step's stable sort of ``n`` ids
    (``SORT_FLOOR_S``, ``SORT_RATE``)."""
    return SORT_FLOOR_S + n / SORT_RATE


def lloyd_bytes_fused(n: int, k: int, d: int, b: int = 4,
                      clusters: int = 1) -> float:
    """FlashLloyd: read X and C once, write assignments, and flush each of
    the problem's ``clusters`` slices of the (K, d) + (K,) statistics
    once."""
    return (n * d + k * d) * b + n * 4 + clusters * (k * d + k) * 4


def fused_clusters(n: int, cluster: int, hw: Hardware) -> int:
    """Clusters a problem's persistent grid holds (one CTA an SM): as many
    as the SMs take, no more than its point tiles need."""
    tiles = -(-max(1, n) // _fl.TILE_N)
    return max(1, min(hw.num_sms // cluster, -(-tiles // cluster)))


def assign_flops_rate(dtype_bytes: int, hw: Hardware) -> float:
    """FlashAssign's peak rate in FLOP/s of ``2 N K d``: float32 runs
    3xTF32 (three tensor-core products per term), bfloat16 one bf16
    product."""
    return hw.flops_tf32 / 3.0 if dtype_bytes == 4 else hw.flops_bf16


def choose_step_impl(n: int, k: int, d: int, *, dtype_bytes: int = 4,
                     hw: Hardware = H100,
                     blk: BlockConfig | None = None) -> str:
    """Fused-vs-two-pass crossover rule.

    ``"fused"`` requires both legs:

    1. *feasibility* — a FlashLloyd cluster size fits
       (``choose_lloyd_cluster``); the two-pass kernels hold no
       ``K``-sized state and scale to any ``K·d``;
    2. *roofline win* — the fused step's time beats the two-pass one's.

    Both paths run the same tensor-core argmin (``assign_flops_rate``:
    3xTF32 for f32, bf16 for bf16), bound by its flops or its bytes. The
    fused step streams x with the centroids, so in f32 it splits each x
    chunk again for every centroid tile after the first
    (``LLOYD_SPLIT_RATE``); its adder warps add the rows beside the argmin
    (``LLOYD_ADD_RATE``), and it flushes its clusters' slices. The
    two-pass step adds the stable sort of its ids (``sort_seconds``) and
    the sort-inverse update's bytes; FlashAssign's consumers sum
    ``||x||^2`` beside the argmin, so it has no pass of its own.
    """
    if blk is None:
        blk = choose_blocks(n, k, d, dtype_bytes=dtype_bytes, hw=hw)
    cluster = choose_lloyd_cluster(k, d, dtype_bytes, hw)
    if cluster is None:
        return "two_pass"
    bw = hw.hbm_bw
    t_argmin = max(2.0 * n * k * d / assign_flops_rate(dtype_bytes, hw),
                   assign_bytes_flash(n, k, d, dtype_bytes) / bw)
    flush = fused_clusters(n, cluster, hw) * (k * d + k) * 4
    nk = -(-k // _fl.TILE_K)
    split = (nk - 1) * n * d / LLOYD_SPLIT_RATE if dtype_bytes == 4 else 0.0
    t_fused = max(t_argmin + split,
                  n * d / LLOYD_ADD_RATE[dtype_bytes]) + flush / bw
    t_two = t_argmin + sort_seconds(n) + update_bytes_sort_inverse(
        n, k, d, dtype_bytes, blk.update_block_n) / bw
    return "fused" if t_fused <= t_two else "two_pass"


def choose_blocks(n: int, k: int, d: int, *, dtype_bytes: int = 4,
                  hw: Hardware = H100) -> BlockConfig:
    """Closed-form block selection — zero search.

    The assign and fused tiles are the kernels' compiled ones (128 x 128,
    the shared argmin's). The sort-inverse CTA has ``UPDATE_THREADS``
    threads and takes the fewest sorted rows (a power of two) that keep
    every CTA resident in one wave (``update_ctas_per_sm`` on each SM): at small N
    the kernel is bound by the latency of its gathers, so all of them
    should be in flight at once. Between ``UPDATE_MIN_CHUNK`` (eight rows
    per warp) and ``UPDATE_MAX_CHUNK`` (fewer boundary atomics no longer
    matter there, and shared memory stays near 48 KB).
    """
    per_sm = update_ctas_per_sm(d, dtype_bytes, UPDATE_MAX_CHUNK, hw)
    chunk = _pow2_ceil(-(-max(1, n) // (hw.num_sms * per_sm)))
    chunk = min(UPDATE_MAX_CHUNK, max(UPDATE_MIN_CHUNK, chunk))
    return BlockConfig(update_block_n=chunk, update_block_k=UPDATE_THREADS)


# --- FlashProbe (csrc/flash_probe.cu) --------------------------------------
# One CTA of PROBE_THREADS scans one query's chunk of candidates; a query's
# candidate axis is shared by ``splits`` CTAs, whose sorted partial lists a
# second kernel merges. The tiles are compiled constants: PROBE_TILE rows per
# selection round (the shared survivor buffer), running lists in shared
# memory up to PROBE_LIST_SMEM_MAX entries and in global scratch beyond.

PROBE_THREADS = 256
PROBE_TILE = _fp.TILE
PROBE_LIST_SMEM_MAX = _fp.LIST_SMEM_MAX
PROBE_REGS = 64            # __launch_bounds__(256, 4): the register cap
PROBE_MIN_CHUNK = 2048     # fewest candidate rows worth a CTA of their own


def probe_footprint(lp: int) -> int:
    """Shared bytes of one scan CTA: the survivor counter and buffer
    (``(score, index)`` per row of a round), plus the double-buffered
    running list of ``lp`` entries when it is kept in shared memory.
    Independent of ``d`` and the input type: rows stream through
    registers."""
    lst = 16 * lp if lp <= PROBE_LIST_SMEM_MAX else 0
    return 16 + 8 * PROBE_TILE + lst


def probe_merge_footprint(l: int) -> int:
    """Shared bytes of one merge CTA: its double-buffered list of ``l``
    entries, or none when the list is in global scratch."""
    return 16 * l if l <= PROBE_LIST_SMEM_MAX else 0


def probe_ctas_per_sm(lp: int, hw: Hardware = H100) -> int:
    """Resident scan CTAs per SM: the least of the thread limit, the
    register file at the ``PROBE_REGS`` cap, and shared memory (taken as
    the block limit, which is within 1 KB of the SM's)."""
    by_threads = _THREADS_PER_SM // PROBE_THREADS
    by_regs = 65536 // (PROBE_THREADS * PROBE_REGS)
    by_smem = max(1, hw.smem_block_bytes // probe_footprint(lp))
    return max(1, min(by_threads, by_regs, by_smem))


def choose_probe_splits(b: int, c: int, l: int, hw: Hardware = H100) -> int:
    """CTAs per query along the candidate axis: enough CTAs to fill every
    SM once (``b * splits >= num_sms * ctas_per_sm``), but no CTA with
    fewer than ``PROBE_MIN_CHUNK`` rows, where the partial lists' merge
    would cost more than the scan it spreads. The result does not depend
    on the split; only the time does."""
    want = hw.num_sms * probe_ctas_per_sm(min(l, PROBE_MIN_CHUNK), hw)
    by_fill = -(-want // max(1, b))
    by_rows = -(-max(1, c) // PROBE_MIN_CHUNK)
    return max(1, min(by_fill, by_rows))


PROBE_TILE_REGS = 128      # tile mode: __launch_bounds__(256, 2)
PROBE_TILE_MIN_SLICE = 64  # tile mode: fewest centroids worth a CTA of a cluster
PROBE_TILE_SLICE_PER_ENTRY = 4  # tile mode: fewest centroids a CTA per list entry
GROUPED_WARP_REGS = 255    # the warp mode's __launch_bounds__(128): no cap


def choose_probe_cluster(b: int, k: int, l: int, hw: Hardware = H100
                         ) -> int:
    """The tile mode's cluster size: enough CTAs to fill every SM once
    (``ceil(b / 16)`` query tiles times the cluster), none with a slice
    under ``PROBE_TILE_MIN_SLICE`` centroids or under
    ``PROBE_TILE_SLICE_PER_ENTRY`` per entry of the ``l``-entry list (the
    in-launch merge reads ``cluster * l`` entries a query); one of 1, 2, 4,
    8 (``flash_probe.probe_cluster``). At B = 256, K = 1,024 that is 8 for
    L <= 32 and 4 for L = 48 and 64, the fastest of the four in
    ``chip_smoke.py``'s sweep on the H100, or within 2% of it; at B = 1,024
    it is 2; at B >= 2,112 it is 1."""
    tiles = -(-max(1, b) // _fp.PROBE_TILE_QUERIES)
    slice_ = max(PROBE_TILE_MIN_SLICE, PROBE_TILE_SLICE_PER_ENTRY * l)
    want = min(-(-hw.num_sms // tiles), -(-max(1, k) // slice_))
    return _fp.probe_cluster(want)


STORE_REGS = 64            # the cell kernel's __launch_bounds__(256, 4) cap
STORE_CELL_PAIRS = PROBE_THREADS // 32  # pairs of one cell a unit scores
STORE_WAVES = 1            # cell mode: work items per resident CTA, fewest units
STORE_MIN_ROWS = 256       # cell mode: fewest slots of a cell worth an item


def store_ctas_per_sm(d: int, itemsize: int, hw: Hardware = H100) -> int:
    """Resident cell-mode CTAs per SM: threads, the kernel's register cap
    and its ring of row tiles (``flash_probe.store_cell_smem``)."""
    by_threads = _THREADS_PER_SM // PROBE_THREADS
    by_regs = 65536 // (PROBE_THREADS * STORE_REGS)
    by_smem = hw.smem_block_bytes // _fp.store_cell_smem(d, itemsize)
    return max(1, min(by_threads, by_regs, by_smem))


def choose_store_splits(b: int, nprobe: int, width: int, d: int, l: int,
                        itemsize: int = 4, hw: Hardware = H100) -> int:
    """Splits of the store scan (``flash_probe.store_geometry``). Cell mode:
    a work item is a unit of at most ``STORE_CELL_PAIRS`` pairs of one cell
    and one split of its ``width`` slots; the units are at least ``b *
    nprobe / STORE_CELL_PAIRS`` (each cell probed that often), so take
    enough splits for ``STORE_WAVES`` items per resident CTA, none under
    ``STORE_MIN_ROWS`` slots. List mode: the block scan's rule over each
    query's ``nprobe * width`` slots."""
    if not _fp.store_cell_mode(l, d, itemsize):
        return choose_probe_splits(b, nprobe * width, l, hw)
    units = max(1, -(-b * nprobe // STORE_CELL_PAIRS))
    ctas = hw.num_sms * store_ctas_per_sm(d, itemsize, hw)
    by_fill = -(-STORE_WAVES * ctas // units)
    by_rows = max(1, width // STORE_MIN_ROWS)
    return max(1, min(by_fill, by_rows))


STORE_Q8_REGS = 128        # the q8 cell kernel's __launch_bounds__(256, 2) cap
# (lists of 33-64 entries at d <= 32 take 1 CTA an SM; splits do not see it)


def q8_store_ctas_per_sm(d: int, hw: Hardware = H100) -> int:
    """Resident q8 cell-mode CTAs per SM: threads, the register cap, and its
    ring of code-and-scale tiles with one tile's dequantized rows
    (``flash_probe.store_q8_cell_smem``)."""
    by_threads = _THREADS_PER_SM // PROBE_THREADS
    by_regs = 65536 // (PROBE_THREADS * STORE_Q8_REGS)
    by_smem = hw.smem_block_bytes // _fp.store_q8_cell_smem(d)
    return max(1, min(by_threads, by_regs, by_smem))


def choose_store_q8_splits(b: int, nprobe: int, width: int, d: int, l: int,
                           hw: Hardware = H100) -> int:
    """Splits of the q8 store scan (``flash_probe.store_q8_geometry``), by
    ``choose_store_splits``'s rule: in the cell mode enough splits of each
    unit for ``STORE_WAVES`` items per resident CTA, none under
    ``STORE_MIN_ROWS`` slots; in the list mode the block scan's rule."""
    if not _fp.store_q8_cell_mode(l, d):
        return choose_probe_splits(b, nprobe * width, l, hw)
    units = max(1, -(-b * nprobe // STORE_CELL_PAIRS))
    ctas = hw.num_sms * q8_store_ctas_per_sm(d, hw)
    by_fill = -(-STORE_WAVES * ctas // units)
    by_rows = max(1, width // STORE_MIN_ROWS)
    return max(1, min(by_fill, by_rows))


def scan_q8_store_bytes(bq: int, nprobe: int, width: int, d: int, l: int,
                        rows_read: int | None = None) -> float:
    """q8 store scan: the f32 shifted queries (one row a pair), the probe
    list, one count per pair, ``rows_read`` slots' codes and scales (``d +
    4`` bytes; every slot of every pair when not given), the (B, L) pair
    out."""
    rows = bq * nprobe * width if rows_read is None else rows_read
    return (bq * nprobe * d * 4 + rows * (d + 4) + 2 * bq * nprobe * 4
            + 2 * bq * l * 4)


def scan_store_bytes(bq: int, nprobe: int, width: int, d: int, l: int,
                     b: int = 4, rows_read: int | None = None) -> float:
    """Store scan: the queries once, the probe list, one count per pair,
    ``rows_read`` store rows (each probed cell's live rows once for the
    least the data needs, or each pair's; every slot of every pair when
    not given, the most it can read), and the (B, L) pair out."""
    rows = bq * nprobe * width if rows_read is None else rows_read
    return (bq * d + rows * d) * b + 2 * bq * nprobe * 4 + 2 * bq * l * 4


def probe_bytes(n: int, k: int, d: int, l: int, b: int = 4) -> float:
    """FlashProbe: read Q, C and ``||c||^2`` once, write the (N, L)
    index/score pair."""
    return (n * d + k * d) * b + k * 4 + 2 * n * l * 4


def scan_bytes(bq: int, c: int, d: int, l: int, b: int = 4) -> float:
    """Grouped scan: the queries and each query's own candidate block once,
    the (B, L) pair out."""
    return (bq * d + bq * c * d) * b + 2 * bq * l * 4


def scan_q8_bytes(bq: int, c: int, d: int, l: int) -> float:
    """Quantized scan: f32 shifted queries, int8 codes plus one f32 scale
    per candidate row, the (B, L) pair out. The shifted queries are one
    row per probe slot; they are counted as ``bq * d`` as in the
    reference's model, a small term next to the codes."""
    return bq * d * 4.0 + bq * c * (d + 4) + 2 * bq * l * 4


def rescore_bytes(bq: int, c: int, d: int, l: int) -> float:
    """The q8 rescore fed by the device rescore cache (ref.
    ``repro/core/plan.py:408-421``): the grouped scan's f32 traffic plus
    the cache gather, an int32 key lane and a found mask per proposed
    row."""
    return scan_bytes(bq, c, d, l) + bq * c * 8.0


def choose_rescore_mult(topk: int, d: int, cand: int, *,
                        hit_rate: float | None = None) -> int:
    """The q8 rescore multiplier for ``rescore_mult="auto"`` (port of
    ``choose_rescore_mult``, ``repro/core/heuristics.py:407-441``, at its
    recall target and row sizes): ``R/topk = ceil(-2 ln(1 - 0.95)) = 6``
    (the exponential coverage model at recall 0.95), capped so that
    rescoring ``R`` rows per query does not spend more bytes than the int8
    codes (``d + 4`` bytes a row) saved on the ``cand``-row scan. A row
    costs ``4 d`` bytes, or with the device cache's expected ``hit_rate``
    ``max(hit_rate * 4 d, d + 4)``: only hits read fresh fp32 rows, misses
    rescore the decoded rows the proposal already holds."""
    code_bytes, full_bytes = d + 4.0, 4.0 * d
    base = int(math.ceil(-2.0 * math.log(1.0 - 0.95)))
    row_bytes = full_bytes
    if hit_rate is not None:
        row_bytes = max(code_bytes,
                        full_bytes * min(1.0, max(0.0, float(hit_rate))))
    saved = max(0.0, float(cand) * (full_bytes - code_bytes))
    cap = max(1, int(saved // max(1.0, float(topk) * row_bytes)))
    return max(1, min(base, cap))


# ---------------------------------------------------------------------------
# the two-level router (the planner's "route" op)
# ---------------------------------------------------------------------------

# Smallest coarse level the route chooser returns, and the floor of a
# group's capacity: the reference's sublane (8 rows of f32), kept so that
# (K_c, nprobe_c) and the group capacity equal the reference's at every
# shape.
ROUTE_MIN_GROUPS = 8


def route_group_cap(k: int, kc: int) -> int:
    """Modeled fine centroids a coarse group holds (ref.
    ``repro/core/heuristics.py:353``): the mean group size ``ceil(K /
    K_c)`` with 2x slack for imbalance, rounded up to a power of two, at
    least ``ROUTE_MIN_GROUPS``."""
    mean = (k + kc - 1) // max(1, kc)
    return max(ROUTE_MIN_GROUPS, _pow2_ceil(max(1, 2 * mean)))


def probe_bytes_routed(n: int, k: int, kc: int, nprobe_c: int, gcap: int,
                       d: int, l: int, b: int = 4) -> float:
    """The routed probe: FlashProbe over the ``K_c`` coarse centroids (top
    ``nprobe_c``), then the store scan over each query's ``nprobe_c``
    groups of the router's ``(K_c, gcap, d)`` table, at most every slot of
    every (query, group) pair (``scan_store_bytes``); the flat probe's
    ``K d`` stream becomes ``K_c d`` plus the groups' rows. ``k`` is
    unused and kept for the reference's signature."""
    return (probe_bytes(n, kc, d, nprobe_c, b)
            + scan_store_bytes(n, nprobe_c, gcap, d, l, b))


def choose_coarse_nprobe(recall_target: float = 0.95) -> int:
    """Coarse probe width for a recall target (ref. l.377), from the
    exponential coverage model: the chance that a query's nearest fine
    centroid lies outside its ``c`` nearest groups decays like ``exp(-c /
    2)``, so ``c = ceil(-2 ln(1 - r))`` (0.95 -> 6, 0.99 -> 10)."""
    r = min(max(float(recall_target), 0.0), 1.0 - 1e-9)
    return max(1, int(math.ceil(-2.0 * math.log(1.0 - r))))


def choose_route_params(k: int, nprobe: int, *,
                        recall_target: float = 0.95) -> tuple[int, int]:
    """Closed-form ``(K_c, nprobe_c)`` of the two-level router (ref.
    l.387-405). A query scans ``K_c d`` coarse and ``nprobe_c (K / K_c) d``
    fine values, least at ``K_c = sqrt(nprobe_c K)``, rounded to the
    nearest power of two and clamped to ``[ROUTE_MIN_GROUPS, K // 2]``;
    below ``2 ROUTE_MIN_GROUPS`` cells there is nothing to route and the
    chooser answers ``(K, nprobe_c)``."""
    npc = choose_coarse_nprobe(recall_target)
    if k < 2 * ROUTE_MIN_GROUPS:
        return max(1, k), min(npc, max(1, k))
    ideal = (npc * k) ** 0.5
    kc = 1 << max(0, int(round(math.log2(max(1.0, ideal)))))
    kc = max(ROUTE_MIN_GROUPS, min(kc, k // 2))
    return kc, min(npc, kc, max(1, nprobe))
