"""FlashProbe — fused distance + online top-L (the IVF search primitive).

The kernels are ``csrc/flash_probe.cu`` (CUDA C++ for sm_90a); they
replace the Pallas TPU kernels of ``repro/kernels/flash_probe.py``:

- ``flash_probe_raw`` (``flash_probe_tile_kernel`` for lists of at most
  64 over rows of whole 16-byte vectors, ``flash_probe_kernel``
  otherwise): queries against one shared centroid set — the ``nprobe``
  cell selection;
- ``flash_probe_grouped_raw`` (``flash_probe_grouped_warp_kernel`` for
  lists of at most 64 over blocks of at most 1,024 such rows of at most
  2 KiB, ``flash_probe_grouped_kernel`` otherwise): each query against its
  own gathered candidate block — the exact rescore of the q8 path;
- ``flash_probe_store_raw`` (``flash_probe_store_kernel``, and
  ``flash_probe_store_list_kernel`` for lists longer than 32): the same
  function over the probed cells of a store, read in place through
  ``probe``, ``counts`` and the store's page table (no candidate block is
  gathered, and no padding row is read) — the posting-list scan of an fp32
  or bf16 store, padded (K pages of ``cap`` rows) or paged;
- ``flash_probe_grouped_q8_raw`` (``flash_probe_grouped_q8_kernel``): the
  same scan over int8 residual codes with per-slot scales, dequantized in
  registers, on a gathered block;
- ``flash_probe_store_q8_raw`` (``flash_probe_store_q8_kernel``, and
  ``flash_probe_store_q8_list_kernel`` for lists longer than 64): that
  scan over the probed cells of the quantized store, read in place through
  its page table — the q8 proposal.

Each returns ``(indices int32 (B, l), scores f32 (B, l))``, ascending by
(score, index): equal scores go to the lower index, as ``lax.top_k``.
The port returns exactly ``l`` columns (the reference pads ``l`` to a
multiple of 8 and slices). Where a kernel has two modes, the mode follows
from the shape alone (``probe_mode``, ``grouped_mode``: the planner reports
the same rule); inputs off 16 bytes are copied before a mode that stages
whole 16-byte vectors. ``splits`` is the number of CTAs that share one
query's candidate axis in a list mode
(``core.heuristics.choose_probe_splits``); the probe's tile mode takes
``cluster``, the CTAs of a thread-block cluster that split the centroids
(``choose_probe_cluster``), and the block scan's warp mode gives each
query one warp. The result depends on neither.

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
launches = {"flash_probe_tile": 0, "flash_probe": 0,
            "flash_probe_grouped_warp": 0, "flash_probe_grouped": 0,
            "flash_probe_store": 0, "flash_probe_grouped_q8": 0,
            "flash_probe_store_q8": 0}


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


def _ptr(t: torch.Tensor | None):
    """A tensor's data pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def _aligned_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its data starts on 16 bytes, else a fresh copy (the
    allocator's blocks are aligned far beyond 16 bytes)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---------------------------------------------------------------------------
# kernel 4: shared centroids
# ---------------------------------------------------------------------------

PROBE_TILE_QUERIES = 16    # queries a tile-mode CTA (csrc kTileQ)
PROBE_TILE_ROWS = 64       # centroid rows a ring tile (csrc kTileK)
PROBE_TILE_STAGES = 2      # ring tiles (csrc kTileStages)
PROBE_TILE_LIST = 64       # longest list the tile mode keeps (csrc kTileList)
PROBE_TILE_ROW_BYTES = 1024  # longest row the tile mode stages
PROBE_CLUSTERS = (1, 2, 4, 8)  # cluster sizes of the tile mode


def probe_mode(l: int, d: int, itemsize: int) -> str:
    """``"tile"`` for lists of at most ``PROBE_TILE_LIST`` over rows of
    whole 16-byte vectors of at most ``PROBE_TILE_ROW_BYTES``; ``"list"``
    otherwise."""
    row = d * itemsize
    return ("tile" if l <= PROBE_TILE_LIST and row % 16 == 0
            and row <= PROBE_TILE_ROW_BYTES else "list")


def probe_cluster(want: int) -> int:
    """The tile mode's cluster size for ``want`` CTAs a query tile: the
    largest of ``PROBE_CLUSTERS`` not above it."""
    return max(s for s in PROBE_CLUSTERS if s <= max(1, int(want)))


def probe_tile_geometry(n: int, k: int, cluster: int
                        ) -> tuple[int, int, int]:
    """``(cluster, chunk, tiles)`` of the tile mode: query tile ``t`` of
    ``PROBE_TILE_QUERIES`` rows and the ``cluster`` CTAs of its cluster
    (``probe_cluster`` of the one asked for), CTA ``s`` taking centroids
    ``[s * chunk, min(k, (s + 1) * chunk))``; the grid is ``tiles *
    cluster`` CTAs."""
    s = probe_cluster(cluster)
    return s, -(-k // s), -(-n // PROBE_TILE_QUERIES)


def probe_tile_smem(d: int, itemsize: int, l: int, cluster: int) -> int:
    """Dynamic shared bytes of a tile-mode CTA (csrc ``tile_smem``): the
    query tile and the ring, rows padded to an odd number of 16-byte
    units; with a cluster also the partial lists and the staged lists of
    the queries the CTA merges."""
    stride = 16 * ((d * itemsize // 16) | 1)
    b = (PROBE_TILE_QUERIES + PROBE_TILE_STAGES * PROBE_TILE_ROWS) * stride
    if cluster > 1:
        merged = -(-PROBE_TILE_QUERIES // cluster) * cluster
        b += 8 * l * (PROBE_TILE_QUERIES + merged)
    return b


def flash_probe_plain(q: torch.Tensor, c: torch.Tensor, c_sq: torch.Tensor,
                      l: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the ``(N, K)`` score ``c_sq - 2 q.c``, then a
    stable sort."""
    score = c_sq.float().unsqueeze(0) - 2.0 * torch.matmul(
        q.float(), c.float().t())
    return _topl(score, l)


def flash_probe_raw(q: torch.Tensor, c: torch.Tensor, c_sq: torch.Tensor,
                    l: int, *, splits: int = 1, cluster: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-l centroids per query: q (N, d), c (K, d), c_sq (K,) f32 (the
    centroids' ``||c||^2``). Returns ``(indices int32 (N, l), scores f32
    (N, l))``, score ``||c||^2 - 2 q.c``. The mode is ``probe_mode``'s:
    the tile mode (one launch, ``cluster`` CTAs a query tile) or the list
    mode (``splits`` CTAs a query, then a merge launch if above 1)."""
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
    bf16 = int(q.dtype == torch.bfloat16)
    if probe_mode(l, d, q.element_size()) == "tile":
        q, c = _aligned_copy(q), _aligned_copy(c)
        cluster, chunk, _ = probe_tile_geometry(n, k, cluster)
        out_v = torch.empty((n, l), dtype=torch.float32, device=q.device)
        out_i = torch.empty((n, l), dtype=torch.int32, device=q.device)
        code = _build.lib().fk_flash_probe_tile(
            q.data_ptr(), c.data_ptr(), c_sq.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), n, k, d, l, cluster, chunk, bf16,
            _build.stream_ptr(q.device))
        _build.check(code, "flash_probe_tile kernel launch")
        launches["flash_probe_tile"] += 1
        return out_i, out_v
    splits, chunk, lp = _launch_geometry(k, l, splits)
    ptrs, keep = _buffers(n, l, splits, lp, q.device)
    code = _build.lib().fk_flash_probe(
        q.data_ptr(), c.data_ptr(), c_sq.data_ptr(), *ptrs, n, k, d, l,
        splits, chunk, lp, bf16, _build.stream_ptr(q.device))
    _build.check(code, "flash_probe kernel launch")
    launches["flash_probe"] += 1
    return keep[1], keep[0]


# ---------------------------------------------------------------------------
# kernel 5: per-query candidate blocks
# ---------------------------------------------------------------------------

GROUPED_WARP_LIST = 64      # longest list the warp mode keeps (csrc kTileList)
GROUPED_WARP_ROWS = 1024    # longest block a warp scans alone (kWarpScanRows)
GROUPED_WARP_ROW_BYTES = 2048  # longest row (kWarpRowBytes): 4 vectors a lane
GROUPED_WARP_QUERIES = 4    # warps, and queries, a warp-mode CTA


def grouped_mode(l: int, c: int, d: int, itemsize: int) -> str:
    """``"warp"`` (a warp per query) for lists of at most
    ``GROUPED_WARP_LIST`` over blocks of at most ``GROUPED_WARP_ROWS`` rows
    of whole 16-byte vectors, at most ``GROUPED_WARP_ROW_BYTES`` long;
    ``"list"`` otherwise. Both give the same scores bit for bit."""
    row = d * itemsize
    return ("warp" if l <= GROUPED_WARP_LIST and c <= GROUPED_WARP_ROWS
            and row % 16 == 0 and row <= GROUPED_WARP_ROW_BYTES else "list")


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
    (B, l))``, score ``||c||^2 - 2 q.c``. The mode is ``grouped_mode``'s:
    the warp mode (a warp a query) or the list mode (``splits`` CTAs a
    query, then a merge launch if above 1)."""
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
    bf16 = int(q.dtype == torch.bfloat16)
    if grouped_mode(l, cn, d, q.element_size()) == "warp":
        q, c = _aligned_copy(q), _aligned_copy(c)
        out_v = torch.empty((b, l), dtype=torch.float32, device=q.device)
        out_i = torch.empty((b, l), dtype=torch.int32, device=q.device)
        code = _build.lib().fk_flash_probe_grouped_warp(
            q.data_ptr(), c.data_ptr(), out_v.data_ptr(), out_i.data_ptr(),
            b, cn, d, l, bf16, _build.stream_ptr(q.device))
        _build.check(code, "flash_probe_grouped_warp kernel launch")
        launches["flash_probe_grouped_warp"] += 1
        return out_i, out_v
    splits, chunk, lp = _launch_geometry(cn, l, splits)
    ptrs, keep = _buffers(b, l, splits, lp, q.device)
    code = _build.lib().fk_flash_probe_grouped(
        q.data_ptr(), c.data_ptr(), *ptrs, b, cn, d, l, splits, chunk, lp,
        bf16, _build.stream_ptr(q.device))
    _build.check(code, "flash_probe_grouped kernel launch")
    launches["flash_probe_grouped"] += 1
    return keep[1], keep[0]


# ---------------------------------------------------------------------------
# kernel 5, store mode: the probed cells of the padded store, read in place
# ---------------------------------------------------------------------------

STORE_CELL_LIST = 32        # longest list the cell mode keeps (csrc kWarpList)
STORE_STAGES = 3            # tiles in the cell mode's ring (csrc kCellStages)
STORE_TILE_BYTES = 16384    # bytes of one tile of rows
STORE_HEAD = 128            # shared bytes before the ring (csrc kCellHead)


def _row_lanes(d: int, itemsize: int) -> int:
    """Lanes that score one row of kernel 5 (csrc ``scan_lanes``): the power
    of two covering a quarter of its 16-byte vectors (of its scalars if
    ``d`` is not a multiple of the vector width), at most 32."""
    per_vec = 16 // itemsize
    units = d // per_vec if d % per_vec == 0 else d
    g = 1
    while g < -(-units // 4) and g < 32:
        g <<= 1
    return g


def store_tile_rows(d: int, itemsize: int) -> int:
    """Rows of one tile of the cell mode's ring: ``STORE_TILE_BYTES`` of
    whole rows, a multiple of a warp's step (8 rows a group of lanes), so
    that every group reads 8 rows of the tile."""
    step = 8 * (32 // _row_lanes(d, itemsize))
    return max(step, STORE_TILE_BYTES // (d * itemsize) // step * step)


def store_cell_smem(d: int, itemsize: int) -> int:
    """Dynamic shared bytes of a cell-mode CTA: the ring and its head."""
    return STORE_HEAD + STORE_STAGES * store_tile_rows(d, itemsize) * d \
        * itemsize


def store_cell_mode(l: int, d: int, itemsize: int) -> bool:
    """The cell mode takes lists of at most ``STORE_CELL_LIST`` entries and
    rows of which a tile holds 8; the list mode takes the rest."""
    return l <= STORE_CELL_LIST and d * itemsize <= STORE_TILE_BYTES // 8


def store_geometry(nprobe: int, width: int, d: int, itemsize: int, l: int,
                   splits: int) -> tuple[int, int, int, int]:
    """``(splits, chunk, lp, lists)``: the cell mode splits each (query,
    probe) pair's ``width`` slots, and a query has ``nprobe * splits``
    partial lists; the list mode splits a query's ``nprobe * width`` slots,
    ``splits`` lists."""
    if store_cell_mode(l, d, itemsize):
        splits, chunk, lp = _launch_geometry(width, l, splits)
        return splits, chunk, lp, nprobe * splits
    splits, chunk, lp = _launch_geometry(nprobe * width, l, splits)
    return splits, chunk, lp, splits


def _counts_ok(counts: torch.Tensor, k: int) -> bool:
    """``counts`` of a store of K cells: (K,), or (K + 1,) whose last entry
    is 0, so that ``probe`` may name the sentinel cell K, which holds no
    rows (the two-level router's padding; not checked, it would cost a
    device sync)."""
    return counts.shape in ((k,), (k + 1,))


def _check_table(who: str, rows: torch.Tensor, counts: torch.Tensor,
                 table: torch.Tensor | None, width: int) -> int:
    """Checks the scan's page table against ``rows (pages, page_size,
    ...)`` and ``counts``, and ``width`` against its capacity; returns its
    ``maxp``. ``table``: one row a cell of ``counts``, int32 page ids; or
    ``None``, the padded layout, cell ``c`` on page ``c`` (``rows`` then
    holds K pages and ``counts`` K or K + 1 entries)."""
    if table is None:
        if not _counts_ok(counts, rows.shape[0]):
            raise ValueError(f"{who}: counts must be (K,) or (K+1,) for a "
                             f"store of K cells, got {tuple(counts.shape)} "
                             f"and {tuple(rows.shape)}")
        maxp = 1
    elif (table.ndim != 2 or table.shape[0] != counts.shape[0]
            or table.shape[1] < 1 or table.dtype != torch.int32):
        raise ValueError(f"{who}: table must be int32 (cells, maxp) with a "
                         f"row for every count, got {table.dtype} "
                         f"{tuple(table.shape)} for counts "
                         f"{tuple(counts.shape)}")
    else:
        maxp = table.shape[1]
    if not 1 <= width <= maxp * rows.shape[1]:
        raise ValueError(f"{who} needs 1 <= width <= maxp * page_size, got "
                         f"width={width}, maxp * page_size="
                         f"{maxp * rows.shape[1]}")
    return maxp


def _check_index(who: str, *, b, nprobe, cells, maxp, pages, ps, width,
                 d) -> None:
    """The kernels' int32 index arithmetic (rows are addressed in size_t)."""
    if max(b * nprobe, cells * maxp, pages * ps, nprobe * width, d) >= 2**31:
        raise ValueError(f"{who}: dims must fit int32")


def _slot_pages(rows: torch.Tensor, table: torch.Tensor | None,
                probe: torch.Tensor, width: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(page, row)`` (B, nprobe, width) of the probed cells' first
    ``width`` slots, gathered through the table as the reference's
    ``gather_global`` does (``table=None``: page = cell, the sentinel cell
    K on the last page, its slots dead by count)."""
    ps = rows.shape[1]
    w = torch.arange(width, device=probe.device)
    p = probe.long().unsqueeze(-1)
    if table is None:
        return p.clamp(max=rows.shape[0] - 1).expand(-1, -1, width), w
    return table[p.squeeze(-1)][:, :, torch.div(w, ps, rounding_mode="floor")
                                ].long(), w % ps


def flash_probe_store_plain(q: torch.Tensor, rows: torch.Tensor,
                            counts: torch.Tensor, probe: torch.Tensor,
                            width: int, l: int, pad: float,
                            table: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the ``(B, nprobe * width, d)`` block of the
    probed cells' slots, gathered through the page table, ``pad`` in every
    coordinate of a slot at or past its cell's count, then
    ``flash_probe_grouped_plain``."""
    b, nprobe = probe.shape
    page, row = _slot_pages(rows, table, probe, width)
    cand = rows[page, row]                           # (B, nprobe, width, d)
    dead = (torch.arange(width, device=q.device)
            >= counts[probe.long()].unsqueeze(-1)).unsqueeze(-1)
    cand = torch.where(dead, torch.tensor(pad, dtype=cand.dtype), cand)
    return flash_probe_grouped_plain(
        q, cand.reshape(b, nprobe * width, cand.shape[-1]), l)


def flash_probe_store_raw(q: torch.Tensor, rows: torch.Tensor,
                          counts: torch.Tensor, probe: torch.Tensor,
                          width: int, l: int, pad: float, *,
                          table: torch.Tensor | None = None, splits: int = 1
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-l of each query's probed cells, read in place from a store of
    pages: q (B, d), rows (pages, page_size, d) of q's dtype, table (cells,
    maxp) int32 (slot w of cell c is row ``w % page_size`` of page
    ``table[c, w // page_size]``; None: the padded layout, ``rows`` (K, cap,
    d) with cell c on page c), counts (cells,) int32 (live slots per cell;
    with ``table=None`` (K,) or (K + 1,), see ``_counts_ok``), probe (B,
    nprobe) int32 cells, ``pad`` the store's padding coordinate (the value
    of every coordinate of a slot at or past its cell's count, which the
    kernel scores without reading). Query b's candidate ``p * width + w``
    is slot w of cell ``probe[b, p]`` for ``w < width <= maxp *
    page_size``: the index of ``flash_probe_grouped_raw`` on the gathered
    block, which this computes. Returns ``(indices int32 (B, l), scores f32
    (B, l))``, score ``||c||^2 - 2 q.c``. ``splits``: see
    ``store_geometry``. Precondition (not checked, it would cost a device
    sync): probe names a cell of ``counts``, and the table's entries for a
    cell's live slots name pages of ``rows``."""
    who = "flash_probe_store"
    if (q.ndim != 2 or rows.ndim != 3 or probe.ndim != 2
            or rows.shape[2] != q.shape[1]
            or probe.shape[0] != q.shape[0] or counts.ndim != 1):
        raise ValueError(f"{who}: q (B, d), rows (pages, page_size, d), "
                         f"counts (cells,), probe (B, nprobe) expected, got "
                         f"{tuple(q.shape)}, {tuple(rows.shape)}, "
                         f"{tuple(counts.shape)}, {tuple(probe.shape)}")
    b, d = q.shape
    pages, ps, _ = rows.shape
    nprobe = probe.shape[1]
    if counts.dtype != torch.int32 or probe.dtype != torch.int32:
        raise TypeError(f"{who}: counts and probe must be int32, "
                        f"got {counts.dtype}, {probe.dtype}")
    dev = _check_device(who, q, rows, counts, probe,
                        *(() if table is None else (table,)))
    maxp = _check_table(who, rows, counts, table, width)
    _check_l(l, nprobe * width, who, "nprobe*width")
    _check_float(who, q, rows)
    if dev.type == "cpu":
        return flash_probe_store_plain(q, rows, counts, probe, width, l, pad,
                                       table)
    _check_index(who, b=b, nprobe=nprobe, cells=counts.shape[0], maxp=maxp,
                 pages=pages, ps=ps, width=width, d=d)
    if b == 0:
        return (torch.empty((0, l), dtype=torch.int32, device=q.device),
                torch.empty((0, l), dtype=torch.float32, device=q.device))
    q, rows = q.contiguous(), rows.contiguous()
    table = None if table is None else table.contiguous()
    counts, probe = counts.contiguous(), probe.contiguous()
    itemsize = q.element_size()
    splits, chunk, lp, lists = store_geometry(nprobe, width, d, itemsize, l,
                                              splits)
    if b * lists >= 2**31:
        raise ValueError(f"{who}: B * lists must fit int32")
    ptrs, keep = _buffers(b, l, lists, lp, q.device)
    cell = store_cell_mode(l, d, itemsize)
    if cell:
        tile_rows = store_tile_rows(d, itemsize)
        # cell-major: the pairs of one cell are adjacent
        sc, order = torch.sort(probe.reshape(-1), stable=True)
        order = order.to(torch.int32)
        units = torch.empty(b * nprobe + 2, dtype=torch.int32,
                            device=q.device)
        keep += [sc, order, units]
        cell_ptrs = (sc.data_ptr(), order.data_ptr(), units.data_ptr())
    else:
        tile_rows, cell_ptrs = 0, (None,) * 3
    code = _build.lib().fk_flash_probe_store(
        q.data_ptr(), rows.data_ptr(), _ptr(table), counts.data_ptr(),
        probe.data_ptr(), *cell_ptrs, *ptrs, b, nprobe, maxp, ps,
        width, d, l, splits, chunk, lp, tile_rows,
        float(torch.tensor(pad, dtype=q.dtype)), int(cell),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(code, f"{who} kernel launch")
    launches[who] += 1
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


# ---------------------------------------------------------------------------
# kernel 6, store mode: the probed cells of the quantized store, read in place
# ---------------------------------------------------------------------------

STORE_Q8_LIST = 64     # longest list the q8 cell mode keeps (csrc kQ8List)
STORE_Q8_ROWS = 32     # a q8 tile's rows are a multiple of a warp's (up to 32)
STORE_Q8_DEQ_BYTES = 36864  # the dequantized rows of one tile, at most


def _q8_lanes(d: int) -> int:
    """Lanes that score one row of the q8 scan (csrc ``group_lanes``) for
    ``d % 16 == 0``: the power of two covering the row's 16-byte vectors,
    at most 32."""
    g = 1
    while g < d // 16 and g < 32:
        g <<= 1
    return g


def store_q8_tile_rows(d: int) -> int:
    """Rows of one tile of the q8 cell mode: at most ``STORE_TILE_BYTES``
    of codes and scales (``d + 4`` bytes a row) and ``STORE_Q8_DEQ_BYTES``
    of their dequantized values (``16 G`` floats and ``||r||^2`` a row); a
    whole number of warp steps (8 rows a group of G lanes, ``256 / G``) and
    of 32 rows (whole 16-byte groups of scales)."""
    g = _q8_lanes(d)
    rows = min(STORE_TILE_BYTES // (d + 4),
               STORE_Q8_DEQ_BYTES // (4 * (16 * g + 1)))
    step = max(STORE_Q8_ROWS, 256 // g)
    return max(step, rows // step * step)


def store_q8_cell_smem(d: int) -> int:
    """Dynamic shared bytes of a q8 cell-mode CTA: the ring's tiles (codes
    rounded up to 16 bytes, then the scales), its head, and one tile's
    dequantized rows and their ``||r||^2``."""
    rows = store_q8_tile_rows(d)
    return (STORE_HEAD + STORE_STAGES * (-(-rows * d // 16) * 16 + 4 * rows)
            + rows * (16 * _q8_lanes(d) + 1) * 4)


def store_q8_cell_mode(l: int, d: int) -> bool:
    """The q8 cell mode takes lists of at most ``STORE_Q8_LIST`` entries (two
    a lane) and rows of whole 16-code vectors, one a lane (``d % 16 == 0``,
    ``d <= 512``); the list mode the rest, and stores whose page size is not
    a multiple of 4 or whose scales do not start on 16 bytes (both layouts
    round their pages, the padded store's cap too, to 8 rows)."""
    return l <= STORE_Q8_LIST and d % 16 == 0 and d <= 512


def store_q8_geometry(nprobe: int, width: int, d: int, l: int, splits: int,
                      cell: bool | None = None) -> tuple[int, int, int, int]:
    """``(splits, chunk, lp, lists)`` of the q8 store scan, as
    ``store_geometry``; the cell mode's chunk is a multiple of 4 slots, so
    that every tile's scales start on 16 bytes. ``cell``: the mode, by
    default ``store_q8_cell_mode(l, d)``."""
    if not (store_q8_cell_mode(l, d) if cell is None else cell):
        splits, chunk, lp = _launch_geometry(nprobe * width, l, splits)
        return splits, chunk, lp, splits
    splits = max(1, min(int(splits), width, 65535))
    chunk = -(-width // splits)
    chunk += -chunk % 4
    splits = -(-width // chunk)
    return splits, chunk, min(l, chunk), nprobe * splits


def _check_q8_store(who, qp, codes, scales, counts, probe, l):
    if (qp.ndim != 3 or codes.ndim != 3 or probe.ndim != 2
            or qp.shape[:2] != probe.shape or qp.shape[2] != codes.shape[2]
            or scales.shape != codes.shape[:2] or counts.ndim != 1):
        raise ValueError(f"{who}: qp (B, nprobe, d), codes (pages, "
                         f"page_size, d), scales (pages, page_size), counts "
                         f"(cells,), probe (B, nprobe) expected, got "
                         f"{tuple(qp.shape)}, {tuple(codes.shape)}, "
                         f"{tuple(scales.shape)}, {tuple(counts.shape)}, "
                         f"{tuple(probe.shape)}")
    if (qp.dtype != torch.float32 or codes.dtype != torch.int8
            or scales.dtype != torch.float32 or counts.dtype != torch.int32
            or probe.dtype != torch.int32):
        raise TypeError(f"{who}: qp f32, codes int8, scales f32, counts and "
                        f"probe int32 expected, got {qp.dtype}, "
                        f"{codes.dtype}, {scales.dtype}, {counts.dtype}, "
                        f"{probe.dtype}")


def flash_probe_store_q8_plain(qp: torch.Tensor, codes: torch.Tensor,
                               scales: torch.Tensor, counts: torch.Tensor,
                               probe: torch.Tensor, width: int, l: int,
                               table: torch.Tensor | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the ``(B, nprobe, width)`` block of the probed
    cells' codes and scales, gathered through the page table, scale 0 on
    every slot at or past its cell's count, then
    ``flash_probe_grouped_q8_plain``."""
    page, row = _slot_pages(codes, table, probe, width)
    blk_codes = codes[page, row]                     # (B, nprobe, width, d)
    blk_scales = scales[page, row]                   # (B, nprobe, width)
    dead = (torch.arange(width, device=qp.device)
            >= counts[probe.long()].unsqueeze(-1))
    blk_scales = torch.where(dead, torch.zeros_like(blk_scales), blk_scales)
    return flash_probe_grouped_q8_plain(qp, blk_codes, blk_scales, l)


def flash_probe_store_q8_raw(qp: torch.Tensor, codes: torch.Tensor,
                             scales: torch.Tensor, counts: torch.Tensor,
                             probe: torch.Tensor, width: int, l: int, *,
                             table: torch.Tensor | None = None,
                             splits: int = 1
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized scan of each query's probed cells, read in place from a
    quantized store of pages: qp (B, nprobe, d) f32 shifted queries ``q -
    anchor[probe]``, codes (pages, page_size, d) int8, scales (pages,
    page_size) f32 (0 on every dead slot), table, counts and probe as in
    ``flash_probe_store_raw`` (``table=None``: the padded layout, codes (K,
    cap, d)). Query b's candidate ``p * width + w`` is slot w of cell
    ``probe[b, p]``: the index of ``flash_probe_grouped_q8_raw`` on the
    gathered block, which this computes bit for bit, +inf entries
    included. Returns ``(indices int32 (B, l), distances f32 (B, l))``.
    ``splits``: see ``store_q8_geometry``. Precondition (not checked, it
    would cost a device sync): as ``flash_probe_store_raw``'s."""
    who = "flash_probe_store_q8"
    _check_q8_store(who, qp, codes, scales, counts, probe, l)
    b, nprobe, d = qp.shape
    pages, ps, _ = codes.shape
    dev = _check_device(who, qp, codes, scales, counts, probe,
                        *(() if table is None else (table,)))
    maxp = _check_table(who, codes, counts, table, width)
    _check_l(l, nprobe * width, who, "nprobe*width")
    if dev.type == "cpu":
        return flash_probe_store_q8_plain(qp, codes, scales, counts, probe,
                                          width, l, table)
    _check_index(who, b=b, nprobe=nprobe, cells=counts.shape[0], maxp=maxp,
                 pages=pages, ps=ps, width=width, d=d)
    if b == 0:
        return (torch.empty((0, l), dtype=torch.int32, device=qp.device),
                torch.empty((0, l), dtype=torch.float32, device=qp.device))
    qp, codes, scales = qp.contiguous(), codes.contiguous(), \
        scales.contiguous()
    table = None if table is None else table.contiguous()
    counts, probe = counts.contiguous(), probe.contiguous()
    # the cell mode copies a tile's scales in whole 16-byte groups, which
    # pages of a multiple of 4 rows keep whole
    cell = (store_q8_cell_mode(l, d) and ps % 4 == 0
            and scales.data_ptr() % 16 == 0)
    splits, chunk, lp, lists = store_q8_geometry(nprobe, width, d, l, splits,
                                                 cell)
    if b * lists >= 2**31:
        raise ValueError(f"{who}: B * lists must fit int32")
    ptrs, keep = _buffers(b, l, lists, lp, qp.device)
    qsq = torch.empty((b, nprobe), dtype=torch.float32, device=qp.device)
    if cell:
        tile_rows = store_q8_tile_rows(d)
        # cell-major: the pairs of one cell are adjacent
        sc, order = torch.sort(probe.reshape(-1), stable=True)
        order = order.to(torch.int32)
        units = torch.empty(b * nprobe + 2, dtype=torch.int32,
                            device=qp.device)
        keep += [sc, order, units]
        cell_ptrs = (sc.data_ptr(), order.data_ptr(), units.data_ptr())
    else:
        tile_rows, cell_ptrs = 0, (None,) * 3
    code = _build.lib().fk_flash_probe_store_q8(
        qp.data_ptr(), qsq.data_ptr(), codes.data_ptr(), scales.data_ptr(),
        _ptr(table), counts.data_ptr(), probe.data_ptr(), *cell_ptrs,
        *ptrs, b, nprobe, maxp, ps, width, d, l, splits, chunk, lp,
        tile_rows, int(cell), _build.stream_ptr(qp.device))
    _build.check(code, f"{who} kernel launch")
    launches[who] += 1
    return keep[1], keep[0]


def kernel_attrs() -> dict[str, tuple[int, int]]:
    """``(registers per thread, local bytes)`` of each compiled kernel, as
    the card reports them (for the planner's register model)."""
    import ctypes
    out = {}
    for which, name in enumerate(("flash_probe", "flash_probe_grouped",
                                  "flash_probe_grouped_q8", "topl_merge",
                                  "flash_probe_store",
                                  "flash_probe_store<bf16>",
                                  "flash_probe_store_list",
                                  "flash_probe_store_q8",
                                  "flash_probe_store_q8<64 entries>",
                                  "flash_probe_store_q8_list",
                                  "flash_probe_tile",
                                  "flash_probe_tile<64 entries>",
                                  "flash_probe_tile<bf16>",
                                  "flash_probe_grouped_warp",
                                  "flash_probe_grouped_warp<64 entries>")):
        regs, local = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(_build.lib().fk_flash_probe_attrs(
            which, ctypes.byref(regs), ctypes.byref(local)),
            "cudaFuncGetAttributes")
        out[name] = (int(regs.value), int(local.value))
    return out
