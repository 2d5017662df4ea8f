"""Public wrappers around the port's flash-kmeans kernels.

Ports of ``repro/kernels/ops.py`` with the same signatures and return
contracts: FlashAssign's distances are ``score + ||x||^2`` clamped at 0
(the kernel sums ``||x||^2`` itself; the reference adds it outside),
clusters without points get exactly-zero sums and counts, and
``finalize_centroids`` divides by any ``cnt > 0``. Each wrapper dispatches
by the tensors' device: the kernel modules run their plain PyTorch version
for CPU tensors and launch the CUDA kernel for CUDA tensors.

The FlashProbe wrappers (``flash_probe``, ``flash_probe_grouped``,
``flash_probe_store``, ``flash_probe_grouped_q8``, ``flash_probe_store_q8``)
keep the reference's
contracts: ``want_dists`` adds ``||q||^2`` back and clamps at 0, ``c_sq``
may be passed in, and ``l > K`` (or ``> C``) or ``l < 1`` raises
``ValueError``. Their launch geometry comes from a ``plan=`` or the
default planner; ``splits=`` overrides a list mode's CTAs that share one
query's candidate axis (for the store scans, one (query, probe) pair's
slots). The probe's tile mode takes the plan's ``cluster``.

Block resolution: every wrapper accepts an optional ``plan=``
(``core.plan.KernelPlan``) and/or explicit ``block_*`` overrides; with
neither, the device's default ``KernelPlanner`` plans the dispatch. The
resolved tiles are audited against the block's shared-memory limit
(``core.heuristics`` footprints). The assign and fused kernels are compiled
for one tile shape (``BlockConfig`` defaults); the sort-inverse kernel's
two tile dims (sorted rows per CTA, threads per CTA) are free.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import flash_assign as _fa
from repro_torch.kernels import flash_lloyd as _fl
from repro_torch.kernels import flash_probe as _fp
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sort_inverse_update as _siu


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Tile shapes for the kernels (see core.heuristics for selection).

    ``assign_*``/``fused_*``: points and centroids per CTA tile (fixed by
    the CUDA sources). ``update_block_n``: sorted rows per sort-inverse
    CTA; ``update_block_k``: that CTA's threads.
    """
    assign_block_n: int = _fa.TILE_N
    assign_block_k: int = _fa.TILE_K
    update_block_n: int = 512
    update_block_k: int = _siu.THREADS
    fused_block_n: int = _fl.TILE_N
    fused_block_k: int = _fl.TILE_K

    def validate(self) -> "BlockConfig":
        """Tiles are positive powers of two or multiples of 128;
        ``update_block_k`` (threads) a multiple of 32 up to the kernel's
        ``THREADS``."""
        if self.update_block_k % 32 or \
                not 32 <= self.update_block_k <= _siu.THREADS:
            raise ValueError(f"update_block_k={self.update_block_k} must be "
                             f"a multiple of 32 in [32, {_siu.THREADS}]")
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name == "update_block_k":
                continue
            if v <= 0 or (v & (v - 1)) != 0 and v % 128 != 0:
                raise ValueError(f"{f.name}={v} must be a positive power of "
                                 "two or a multiple of 128")
        return self


def _plan_leg(plan, leg: str) -> tuple[int, int]:
    """Extract the tile dims a wrapper needs from a ``KernelPlan``."""
    if plan.op == leg:
        return plan.blocks
    if plan.block is not None and leg in ("assign", "update", "fused"):
        b = plan.block
        return {"assign": (b.assign_block_n, b.assign_block_k),
                "update": (b.update_block_n, b.update_block_k),
                "fused": (b.fused_block_n, b.fused_block_k)}[leg]
    raise ValueError(
        f"a plan for op {plan.op!r} cannot drive the {leg!r} kernel")


def _resolve_blocks(op: str, shape: tuple, dtype, block_n, block_k, plan,
                    device, leg: str | None = None) -> tuple[int, int]:
    """Explicit ``block_*`` win; a ``plan`` covers the rest; with neither,
    the device's default ``KernelPlanner`` plans the dispatch."""
    if block_n is not None and block_k is not None:
        return block_n, block_k
    if plan is None:
        from repro_torch.core.plan import default_planner
        plan = default_planner(device).plan(op, shape, dtype)
    pn, pk = _plan_leg(plan, leg or op)
    return (pn if block_n is None else block_n,
            pk if block_k is None else block_k)


def _audit_blocks(op: str, bn: int, bk: int, d: int, itemsize: int, device,
                  *, k: int | None = None, plan=None) -> int | None:
    """The resolved tiles must be ones the kernel was built for, and their
    shared-memory footprint must fit the block limit of the hardware the
    plan was made for (the device's detected hardware without a plan).
    Raises ``ValueError`` otherwise: FlashLloyd's ``(K, d)`` sums that fit
    no cluster size cannot be tiled down, the caller must go two-pass.
    Returns the fused step's cluster size (the planner's
    ``choose_lloyd_cluster``)."""
    from repro_torch.core import heuristics as H
    from repro_torch.core import plan as _planmod
    hw = _planmod.hardware_for(plan.hw if plan is not None else None, device)
    compiled = {"assign": (_fa.TILE_N, _fa.TILE_K),
                "fused": (_fl.TILE_N, _fl.TILE_K)}.get(op)
    if compiled is not None and (bn, bk) != compiled:
        raise ValueError(
            f"{op} tiles ({bn}, {bk}) differ from the kernel's compiled "
            f"tiles {compiled}")
    if op == "fused":
        cluster = H.choose_lloyd_cluster(k, d, itemsize, hw)
        if cluster is None:
            big = _fl.CLUSTERS[-1]
            raise ValueError(
                f"fused kernel working set "
                f"({H.fused_footprint(k, d, itemsize, big)} bytes a CTA in a "
                f"cluster of {big}) exceeds the {hw.name} block "
                f"shared-memory limit ({hw.smem_block_bytes} bytes) for "
                f"d={d}, K={k}; use the two-pass path")
        return cluster
    if op == "assign":   # the larger launch, which returns distances
        need = H.assign_footprint(bn, bk, d, itemsize, dists=True)
    else:
        if bk % 32 or not 32 <= bk <= _siu.THREADS:
            raise ValueError(f"update_block_k={bk} must be a multiple of 32 "
                             f"in [32, {_siu.THREADS}] (threads per CTA)")
        need = H.update_footprint(bn, bk, d, itemsize)
    if need > hw.smem_block_bytes:
        raise ValueError(
            f"{op} kernel working set ({need} bytes) exceeds the {hw.name} "
            f"block shared-memory limit ({hw.smem_block_bytes} bytes) for "
            f"d={d}")
    return None


# ---------------------------------------------------------------------------
# FlashAssign
# ---------------------------------------------------------------------------

def flash_assign(x: torch.Tensor, c: torch.Tensor, *,
                 block_n: int | None = None, block_k: int | None = None,
                 plan=None, want_dists: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused assignment. x: (N, d), c: (K, d).

    Returns ``(assignments int32 (N,), min_sq_dists f32 (N,))``; distances
    are true squared distances unless ``want_dists=False`` (then the
    ``||x||^2``-free score).
    """
    n, d = x.shape
    k = c.shape[0]
    bn, bk = _resolve_blocks("assign", (n, k, d), x.dtype, block_n, block_k,
                             plan, x.device)
    _audit_blocks("assign", bn, bk, d, x.element_size(), x.device, plan=plan)
    a, m = _fa.flash_assign_raw(x.unsqueeze(0), c.unsqueeze(0),
                                want_dists=want_dists)
    return a[0], m[0]


def flash_assign_batched(x: torch.Tensor, c: torch.Tensor, *,
                         block_n: int | None = None,
                         block_k: int | None = None, plan=None,
                         want_dists: bool = True
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, N, d), c: (B, K, d) — per-problem centroids, one launch."""
    b, n, d = x.shape
    bn, bk = _resolve_blocks("assign", (n, c.shape[1], d), x.dtype,
                             block_n, block_k, plan, x.device)
    _audit_blocks("assign", bn, bk, d, x.element_size(), x.device, plan=plan)
    return _fa.flash_assign_raw(x, c, want_dists=want_dists)


# ---------------------------------------------------------------------------
# Sort-Inverse Update
# ---------------------------------------------------------------------------

def _sort_inverse(x2: torch.Tensor, ids: torch.Tensor, segments: int,
                  bn: int, bk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Prologue (stable sort of the 4-byte ids) + the segment-sum kernel."""
    ids_sorted, order = torch.sort(ids.to(torch.int32), stable=True)
    return _siu.sort_inverse_update_raw(
        x2, order.to(torch.int32), ids_sorted, segments, chunk=bn,
        threads=bk)


def sort_inverse_update(x: torch.Tensor, a: torch.Tensor, *, k: int,
                        block_n: int | None = None,
                        block_k: int | None = None, plan=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Contention-free centroid statistics. x: (N, d), a: (N,) int32.

    Returns ``(sums f32 (K, d), counts f32 (K,))``.
    """
    n, d = x.shape
    bn, bk = _resolve_blocks("update", (n, k, d), x.dtype, block_n, block_k,
                             plan, x.device)
    _audit_blocks("update", bn, bk, d, x.element_size(), x.device, plan=plan)
    return _sort_inverse(x, a, k, bn, bk)


def sort_inverse_update_batched(x: torch.Tensor, a: torch.Tensor, *, k: int,
                                block_n: int | None = None,
                                block_k: int | None = None, plan=None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, N, d), a: (B, N). Ids are offset by ``b * k`` so one sort
    and one kernel launch cover all B problems."""
    b, n, d = x.shape
    bn, bk = _resolve_blocks("update", (n, k, d), x.dtype, block_n, block_k,
                             plan, x.device)
    _audit_blocks("update", bn, bk, d, x.element_size(), x.device, plan=plan)
    ids = a.to(torch.int32) + k * torch.arange(
        b, dtype=torch.int32, device=a.device).unsqueeze(1)
    s, cnt = _sort_inverse(x.reshape(b * n, d), ids.reshape(-1), b * k,
                           bn, bk)
    return s.reshape(b, k, d), cnt.reshape(b, k)


# ---------------------------------------------------------------------------
# FlashLloyd — fused assignment + statistics in one pass
# ---------------------------------------------------------------------------

def flash_lloyd_step_batched(x: torch.Tensor, c: torch.Tensor, *,
                             block_n: int | None = None,
                             block_k: int | None = None, plan=None):
    """x: (B, N, d), c: (B, K, d). Returns ``(a int32 (B, N), sums f32
    (B, K, d), counts f32 (B, K), inertia f32 (B,))`` in one launch."""
    b, n, d = x.shape
    k = c.shape[1]
    bn, bk = _resolve_blocks("step", (n, k, d), x.dtype, block_n, block_k,
                             plan, x.device, leg="fused")
    cluster = _audit_blocks("fused", bn, bk, d, x.element_size(), x.device,
                            k=k, plan=plan)
    return _fl.flash_lloyd_raw(x, c, cluster=cluster)


def flash_lloyd_step(x: torch.Tensor, c: torch.Tensor, *,
                     block_n: int | None = None, block_k: int | None = None,
                     plan=None):
    """Fused Lloyd statistics. x: (N, d), c: (K, d).

    Returns ``(assignments int32 (N,), sums f32 (K, d), counts f32 (K,),
    inertia f32 ())`` in a single pass over ``x``. The ``(K, d)`` f32
    sums must fit the shared memory of a cluster of at most 8 CTAs; the
    planner's step plan sends larger shapes to the two-pass pipeline.
    """
    a, s, cnt, j = flash_lloyd_step_batched(
        x.unsqueeze(0), c.unsqueeze(0), block_n=block_n, block_k=block_k,
        plan=plan)
    return a[0], s[0], cnt[0], j[0]


# ---------------------------------------------------------------------------
# FlashProbe — fused distance + online top-L (IVF search primitive)
# ---------------------------------------------------------------------------

def _probe_splits(op: str, shape: tuple, dtype, splits, plan, device) -> int:
    """CTAs per query along the candidate axis: explicit ``splits`` win,
    then a plan's, then the device's default planner's."""
    if splits is not None:
        return int(splits)
    return _probe_plan(op, shape, dtype, plan, device).blocks[0]


def _probe_plan(op: str, shape: tuple, dtype, plan, device):
    """``plan``, or the device's default planner's for ``(op, shape)``.
    The plan's shared memory must fit the block limit of its hardware
    row."""
    if plan is None:
        from repro_torch.core.plan import default_planner
        plan = default_planner(device).plan(op, shape, dtype)
    elif plan.op != op:
        raise ValueError(
            f"a plan for op {plan.op!r} cannot drive the {op!r} kernel")
    if plan.smem_bytes > plan.smem_limit:
        raise ValueError(f"{op} kernel working set ({plan.smem_bytes} bytes) "
                         f"exceeds the {plan.hw} block shared-memory limit "
                         f"({plan.smem_limit} bytes)")
    return plan


def _add_qsq(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``||q||^2`` added back to each row of scores, clamped at 0."""
    q32 = q.float()
    return torch.clamp(v + (q32 * q32).sum(-1, keepdim=True), min=0.0)


def flash_probe(q: torch.Tensor, c: torch.Tensor, *, l: int,
                splits: int | None = None, plan=None,
                want_dists: bool = True,
                c_sq: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused L-nearest-centroid probe. q: (N, d), c: (K, d), ``1 <= l <=
    K``.

    Returns ``(indices int32 (N, l), dists f32 (N, l))`` ascending, ties to
    the lower index. Distances are true squared distances unless
    ``want_dists=False`` (then the ``||q||^2``-free score). ``c_sq``: the
    centroids' ``||c||^2`` (K,) f32, e.g. ``IVFIndex``'s cached strip;
    derived here when absent. ``splits`` sets the list mode's CTAs a
    query; the tile mode's cluster is the plan's.
    """
    n, d = q.shape
    k = c.shape[0]
    p = _probe_plan("probe", (n, k, d, l), q.dtype, plan, q.device)
    splits = int(splits) if splits is not None else p.blocks[0]
    if c_sq is None:
        c32 = c.float()
        c_sq = (c32 * c32).sum(-1)
    idx, v = _fp.flash_probe_raw(q, c, c_sq.float(), l, splits=splits,
                                 cluster=p.cluster or 1)
    return idx, (_add_qsq(q, v) if want_dists else v)


def flash_probe_grouped(q: torch.Tensor, c: torch.Tensor, *, l: int,
                        splits: int | None = None, plan=None,
                        want_dists: bool = True
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query-candidate top-L scan. q: (B, d), c: (B, C, d), ``1 <= l
    <= C``: query ``i`` against its own block ``c[i]``, one launch for the
    batch. Returns ``(indices int32 (B, l) into each query's candidate
    axis, dists f32 (B, l))`` ascending. ``plan`` may be a ``scan`` plan
    or the q8 search's ``rescore`` plan (the same kernel)."""
    b, d = q.shape
    c_n = c.shape[1]
    op = "rescore" if plan is not None and plan.op == "rescore" else "scan"
    splits = _probe_splits(op, (b, c_n, d, l), q.dtype, splits, plan,
                           q.device)
    idx, v = _fp.flash_probe_grouped_raw(q, c, l, splits=splits)
    return idx, (_add_qsq(q, v) if want_dists else v)


def flash_probe_store(q: torch.Tensor, rows: torch.Tensor,
                      counts: torch.Tensor, probe: torch.Tensor, *,
                      width: int, l: int, pad: float,
                      table: torch.Tensor | None = None,
                      splits: int | None = None, plan=None,
                      want_dists: bool = True
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The posting-list scan over a store, read in place. q (B, d), rows
    (pages, page_size, d), table (cells, maxp) int32 (slot w of cell c is
    row ``w % page_size`` of page ``table[c, w // page_size]``; None: the
    padded layout, rows (K, cap, d) with cell c on page c), counts (cells,)
    int32, probe (B, nprobe) int32 cells, ``pad`` the store's padding
    coordinate (held by every slot at or past its cell's count), ``1 <= l
    <= nprobe * width``. With counts of K + 1 entries, the last 0, and a
    table row for each, ``probe`` may hold the sentinel cell K, whose
    slots all score as padding. Computes what
    ``flash_probe_grouped`` computes on the store's gathered ``(B, nprobe
    * width, d)`` block, without writing it: ``(indices int32 (B, l) into
    the probe-rank-major ``p * width + w`` axis, dists f32 (B, l))``
    ascending."""
    b, d = q.shape
    nprobe = probe.shape[1]
    splits = _probe_splits("scan_store", (b, nprobe, width, d, l), q.dtype,
                           splits, plan, q.device)
    idx, v = _fp.flash_probe_store_raw(q, rows, counts, probe, width, l,
                                       pad, table=table, splits=splits)
    return idx, (_add_qsq(q, v) if want_dists else v)


def flash_probe_grouped_q8(qp: torch.Tensor, codes: torch.Tensor,
                           scales: torch.Tensor, *, l: int,
                           splits: int | None = None, plan=None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized per-query-candidate top-L scan (dequantized in registers).

    qp: (B, nprobe, d) f32 shifted queries ``q - anchor[cell]``, codes:
    (B, nprobe, W, d) int8, scales: (B, nprobe, W) f32, exactly 0.0 on
    empty slots. Returns ``(indices int32 (B, l), dists f32 (B, l))``
    ascending: indices address the flattened ``nprobe*W`` axis in
    probe-rank-major order, dists are the true quantized squared
    distances. Rows with fewer than ``l`` live candidates end in ``+inf``.

    The reference pads W to its tile and remaps the kernel's indices back
    to the unpadded axis (``repro/kernels/ops.py:460``); this kernel never
    pads W, so its indices already are the unpadded ones and the remap is
    the identity.
    """
    b, nprobe, d = qp.shape
    w = codes.shape[2]
    c_n = nprobe * w
    splits = _probe_splits("scan_q8", (b, c_n, d, l), torch.int8, splits,
                           plan, qp.device)
    return _fp.flash_probe_grouped_q8_raw(qp, codes, scales, l,
                                          splits=splits)


def flash_probe_store_q8(q: torch.Tensor, codes: torch.Tensor,
                         scales: torch.Tensor, counts: torch.Tensor,
                         probe: torch.Tensor, anchors: torch.Tensor, *,
                         width: int, l: int,
                         table: torch.Tensor | None = None,
                         splits: int | None = None,
                         plan=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The quantized posting-list scan over a store, read in place. q (B,
    d), codes (pages, page_size, d) int8, scales (pages, page_size) f32 (0
    on every dead slot), table as in ``flash_probe_store`` (None: the
    padded layout, codes (K, cap, d)), counts (cells,) int32, probe (B,
    nprobe) int32 cells, anchors (cells, d) f32 (the codes' encode-time
    centroids), ``1 <= l <= nprobe * width``. The shifted queries ``q' = q
    - anchors[probe]`` are the block path's own. With counts of K + 1
    entries, the last 0, and anchors and table rows for each, ``probe`` may
    hold the sentinel cell K, whose slots all score ``+inf``.
    Computes what ``flash_probe_grouped_q8`` computes on the store's
    gathered block, without writing it: ``(indices int32 (B, l) into the
    probe-rank-major ``p * width + w`` axis, dists f32 (B, l))`` ascending,
    the true quantized distances, ``+inf`` where fewer than ``l`` live
    slots exist."""
    b, d = q.shape
    nprobe = probe.shape[1]
    splits = _probe_splits("scan_q8_store", (b, nprobe, width, d, l),
                           torch.int8, splits, plan, q.device)
    qp = q.float().unsqueeze(1) - anchors[probe.long()]
    return _fp.flash_probe_store_q8_raw(qp, codes, scales, counts, probe,
                                        width, l, table=table, splits=splits)


# ---------------------------------------------------------------------------
# Statistics by any two-pass dataflow + centroid update
# ---------------------------------------------------------------------------

def centroid_stats(x: torch.Tensor, a: torch.Tensor, *, k: int,
                   impl: str = "sort_inverse", block_n: int | None = None,
                   block_k: int | None = None, plan=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Centroid sufficient statistics ``(sums f32 (K, d), counts f32
    (K,))`` by any of the two-pass update dataflows."""
    if impl == "sort_inverse":
        return sort_inverse_update(x, a, k=k, block_n=block_n,
                                   block_k=block_k, plan=plan)
    if impl == "scatter":
        return _ref.update_scatter_ref(x, a, k)
    if impl == "dense_onehot":
        return _ref.update_dense_onehot_ref(x, a, k)
    raise ValueError(f"unknown update impl {impl!r}")


def centroid_stats_batched(x: torch.Tensor, a: torch.Tensor, *, k: int,
                           impl: str = "sort_inverse", **kw
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ``centroid_stats``: x (B, N, d), a (B, N)."""
    if impl == "sort_inverse":
        return sort_inverse_update_batched(x, a, k=k, **kw)
    if impl not in ("scatter", "dense_onehot"):
        raise ValueError(f"unknown update impl {impl!r}")
    outs = [centroid_stats(x[i], a[i], k=k, impl=impl)
            for i in range(x.shape[0])]  # reference dataflows, not kernels
    return (torch.stack([s for s, _ in outs]),
            torch.stack([cnt for _, cnt in outs]))


def finalize_centroids(s: torch.Tensor, cnt: torch.Tensor,
                       c_prev: torch.Tensor) -> torch.Tensor:
    """sums/counts -> centroids with empty-cluster fallback (keep old).

    Counts may be fractional, so any ``cnt > 0`` is a valid divisor;
    clamping to 1 would shrink low-weight centroids toward the origin.
    Works on ``(K, d)`` and batched ``(B, K, d)`` statistics.
    """
    live = (cnt > 0).unsqueeze(-1)
    new_c = s / torch.where(cnt > 0, cnt, torch.ones_like(cnt)).unsqueeze(-1)
    return torch.where(live, new_c, c_prev.float()).to(c_prev.dtype)


def centroid_update(x: torch.Tensor, a: torch.Tensor, c_prev: torch.Tensor,
                    *, impl: str = "sort_inverse", block_n: int | None = None,
                    block_k: int | None = None, plan=None) -> torch.Tensor:
    """Full update stage with empty-cluster fallback (keeps old centroid)."""
    s, cnt = centroid_stats(x, a, k=c_prev.shape[0], impl=impl,
                            block_n=block_n, block_k=block_k, plan=plan)
    return finalize_centroids(s, cnt, c_prev)
