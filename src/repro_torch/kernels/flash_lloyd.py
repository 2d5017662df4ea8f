"""FlashLloyd — fused assignment + centroid statistics in one pass.

The kernel is ``csrc/flash_lloyd.cu`` (CUDA C++ for sm_90a); it replaces
the Pallas TPU kernel ``repro/kernels/flash_lloyd.py:flash_lloyd_raw``.
Like FlashAssign it is bound by its argmin's tensor-core operations
(3xTF32 for float32, bf16 for bfloat16), and it runs FlashAssign's
``wgmma`` mainloop (``csrc/tc_argmin.cuh``), so its ids equal FlashAssign's
bit for bit. What the two-pass path does not have is its ``(K, d)`` f32
sums in shared memory beside that mainloop's ring: they are spread over
the distributed shared memory of a thread-block cluster of ``C`` in
``CLUSTERS`` CTAs, a slice of ``ceil(K / C)`` rows each, so one CTA needs
``smem_bytes(K, d, itemsize, C)``. Each CTA's adder warps add the rows
whose ids it owns, read from every CTA's published tile, with plain shared
loads and stores: no atomic on the add path. The order of every addition
is fixed by the inputs (the adders' lists by listing warp, the clusters'
slices folded in cluster order from a scratch buffer by a second kernel),
so the statistics are the same bits from run to run. The planner
(``core.heuristics.choose_lloyd_cluster``) takes the smallest ``C`` that
fits; past ``C = 8``'s window this wrapper raises ("use the two-pass
path").

``flash_lloyd_raw(x (B, N, d), c (B, K, d))`` returns ``(a int32 (B, N),
sums f32 (B, K, d), counts f32 (B, K), inertia f32 (B,))``. CPU tensors go
to ``flash_lloyd_plain``, CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_assign as _fa
from repro_torch.kernels.flash_assign import check_xc, flash_assign_plain

TILE_N = _fa.TILE_N   # points per CTA tile (csrc/tc_argmin.cuh kBM)
TILE_K = _fa.TILE_K   # centroids per tile, the wgmma N (kBN)
CLUSTERS = (1, 2, 4, 8)   # CTAs of a cluster; 8 is the portable limit
STAGES = {4: 2, 2: 4}     # ring stages by input itemsize (csrc Ring)
SLOTS = 2                 # published tiles in flight (csrc kSlots)
ADDER_WARPS = 3           # warps that add the owned rows into the slice

launches = 0  # kernel launches (CUDA only); reset by callers that count

# (device, bf16, dp, K, C) -> resident clusters
_active: dict[tuple, int] = {}


def padded_d(d: int, itemsize: int) -> int:
    """The feature width the kernel runs at: rows of a multiple of 16
    bytes (``flash_assign.pad_features``)."""
    return d + (-d % (16 // itemsize))


def ring_bytes(itemsize: int) -> int:
    """The argmin's ring: each stage holds a 128-row tile of x and one of
    the centroids, 128 bytes of features a row (for f32 each with its tf32
    low part), plus two mbarriers."""
    split = 2 if itemsize == 4 else 1
    stage = 2 * split * _fa.ROW_BYTES * TILE_N
    return STAGES[itemsize] * (stage + 16)


def smem_bytes(k: int, d: int, itemsize: int, cluster: int) -> int:
    """Dynamic shared bytes of one CTA (``csrc/flash_lloyd.cu`` smem_bytes):
    the ring and 1,024 bytes to align it to the swizzle's period; the
    published tiles' mbarriers and id slots, the tile's row norms and 64
    bytes of counters; one owned-row list per adder warp (4 bytes for each
    of the cluster's ``C * TILE_N`` rows a round); and the CTA's slice of
    ``ceil(K / C)`` rows of f32 sums and counts at the padded width."""
    ks = -(-k // cluster)
    dp = padded_d(d, itemsize)
    tail = 2 * SLOTS * 8 + SLOTS * TILE_N * 4 + TILE_N * 4 + 64
    lists = ADDER_WARPS * cluster * TILE_N * 4
    return ring_bytes(itemsize) + 1024 + tail + lists + 4 * (ks * dp + ks)


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


def active_clusters(device: torch.device, is_bf16: bool, dp: int, k: int,
                    cluster: int) -> int:
    """Clusters the card keeps resident at once for this launch
    (``cudaOccupancyMaxActiveClusters``), memoized."""
    key = (device.index, is_bf16, dp, k, cluster)
    got = _active.get(key)
    if got is None:
        import ctypes
        out = ctypes.c_int(0)
        _build.check(_build.lib().fk_flash_lloyd_clusters(
            int(is_bf16), dp, k, cluster, ctypes.byref(out)),
            "cudaOccupancyMaxActiveClusters")
        got = _active[key] = int(out.value)
    return got


def grid_width(active: int, b: int, n: int, cluster: int) -> int:
    """The persistent grid along x: the resident clusters shared by the B
    problems (at least one cluster a problem), no more than the problem's
    point tiles need, times C."""
    tiles = -(-n // TILE_N)
    per_problem = max(1, -(-active // b))
    return cluster * max(1, min(per_problem, -(-tiles // cluster)))


def flash_lloyd_raw(x: torch.Tensor, c: torch.Tensor, *,
                    cluster: int | None = None):
    """Fused Lloyd statistics over a batch: x (B, N, d), c (B, K, d).
    ``cluster`` is C (the planner's smallest that fits when None)."""
    global launches
    check_xc(x, c, "flash_lloyd")
    if x.device.type == "cpu":
        return flash_lloyd_plain(x, c)
    if x.device.type != "cuda":
        raise ValueError(f"flash_lloyd: unsupported device {x.device}")
    from repro_torch.core import heuristics as H
    from repro_torch.core import plan as P
    b, n, d = x.shape
    k = c.shape[1]
    isz = x.element_size()
    hw = P.default_planner(x.device).hw
    if cluster is None:
        cluster = H.choose_lloyd_cluster(k, d, isz, hw)
        if cluster is None:
            raise ValueError(
                f"flash_lloyd: the (K={k}, d={d}) sums need "
                f"{smem_bytes(k, d, isz, CLUSTERS[-1])} bytes of shared "
                f"memory a CTA even in a cluster of {CLUSTERS[-1]}, over "
                f"the block limit of {hw.smem_block_bytes}; use the two-pass "
                "path (step_impl='two_pass')")
    elif cluster not in CLUSTERS or smem_bytes(
            k, d, isz, cluster) > hw.smem_block_bytes:
        raise ValueError(f"flash_lloyd: cluster={cluster} is not one of "
                         f"{CLUSTERS} whose slice of K={k}, d={d} fits")
    x, c = _fa.pad_features(x, c)
    dp = x.shape[-1]
    is_bf16 = x.dtype == torch.bfloat16
    dev = x.device
    a = torch.empty((b, n), dtype=torch.int32, device=dev)
    if n == 0:
        return (a, torch.zeros((b, k, d), device=dev),
                torch.zeros((b, k), device=dev), torch.zeros(b, device=dev))
    # the sums and counts in one buffer, written whole by plain stores
    stats = torch.empty(b * k * (dp + 1), dtype=torch.float32, device=dev)
    sums = stats[:b * k * dp].view(b, k, dp)
    counts = stats[b * k * dp:].view(b, k)
    grid_x = grid_width(active_clusters(dev, is_bf16, dp, k, cluster), b, n,
                        cluster)
    part = torch.empty((b, grid_x), dtype=torch.float32, device=dev)
    # each cluster's slices, folded in cluster order (none with one cluster)
    ncl = grid_x // cluster
    fold = torch.empty((b * ncl * k * (dp + 1) if ncl > 1 else 0,),
                       dtype=torch.float32, device=dev)
    # ||c||^2 padded with +inf to a multiple of the centroid tile, and for
    # f32 the centroids' tf32 split, written by the prologue
    csq = torch.empty((b, -(-k // TILE_K) * TILE_K), dtype=torch.float32,
                      device=dev)
    split = torch.empty((0 if is_bf16 else 2, b, k, dp), dtype=torch.float32,
                        device=dev)
    code = _build.lib().fk_flash_lloyd(
        x.data_ptr(), c.data_ptr(), csq.data_ptr(), split.data_ptr(),
        a.data_ptr(), sums.data_ptr(), counts.data_ptr(), fold.data_ptr(),
        part.data_ptr(), b, n, k, dp, cluster, grid_x, int(is_bf16),
        _build.stream_ptr(dev))
    _build.check(code, "flash_lloyd kernel launch")
    launches += 1
    if dp != d:
        sums = sums[..., :d].contiguous()
    return a, sums, counts, part.sum(-1)
