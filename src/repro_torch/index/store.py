"""BucketStore — the storage layer under FlashIVF posting lists.

Port of ``repro/index/store.py`` for one device. Two layouts share one
contract:

- ``PaddedBucketStore``: one capacity-padded ``(K, cap, d)`` tensor plus
  ``(K, cap)`` int32 ids, amortized-doubling growth and a ``max_cap`` spill
  budget. One hot cell sets ``cap`` for all K cells.
- ``PagedBucketStore``: all cells share one pool of ``(page_size, d)``
  pages; each cell maps its slots through a row of an int32 page table;
  pages come from a free list, lowest id first, as the reference hands them
  out. Resident memory follows the occupied pages. Under ``max_bytes`` an
  LRU evictor frees the coldest cells' pages (write-recency clock, bumped
  per append batch), and evicted rows are counted per cell
  (``evict_counts``, ``evicted``) as ``max_cap`` spills are. Page 0 is the
  reserved padding page (``_PAD_COORD`` coordinates, id ``-1``), which every
  unmapped table entry points at.

Padded slots hold the finite sentinel ``_PAD_COORD`` (their scores are huge
but never inf or NaN inside a kernel) and id ``-1``. ``QuantizedBucketStore``
wraps either layout holding int8 codes with a per-slot f32 scale sidecar
(``0.0`` on empty slots), the frozen encode-time anchors, the host
``RescoreReservoir`` of original rows (the durable tier) and, with
``rescore="device"`` (the default), the ``DeviceRescoreCache``.

The search reads both layouts through one form, the store's ``ScanView``:
slot ``w`` of cell ``c`` is row ``w % page_size`` of pool page ``table[c, w
// page_size]``. A padded store is K pages of ``cap`` rows, cell ``c`` on
page ``c``, and gives no table (the kernels then look no page up); the
paged table's last row, the sentinel cell K, is all page 0. Outside this
module nothing reads a raw store tensor.

``kind=None`` takes ``default_store_kind()`` (``REPRO_BUCKET_STORE``, else
``"padded"``), as in the reference. ``restore_store`` and
``infer_store_meta`` rebuild a store from a snapshot's arrays and meta.

Over a mesh (``place(pctx)``, a ``core.parallel.ParallelContext`` with a
``k_axis``) a store keeps on this rank's device only the cells it owns, a
contiguous ``K / P_k`` of them: the padded store its ``(K/P_k, cap, d)``
payload, ids and sidecar; the paged store (built with ``n_shards = P_k``)
its shard's slice of the pool, ``pps`` pages whose page 0 is the shard's
padding page. The host bookkeeping (counts, capacity growth, page tables,
the per-shard free lists, LRU ticks, spills and evictions, ``max_cap``)
stays global and the same on every rank, so every rank grows and evicts at
once; ``append`` takes the whole batch and writes the owned rows. The
quantized store places its anchors and its ``DeviceRescoreCache`` (sharded
over the same cells) beside the codes. ``scan_view`` is the owned shard's,
with its own sentinel cell ``K/P_k``; ``dense``, ``dense_ids``, ``flat``
and ``state_arrays`` gather the whole store over the cells axis (a
collective: every rank calls them together). ``gather_cells`` and
``gather_cells_q8`` are the shard-local candidate gathers the sharded
search is held to. Not ported yet (ROADMAP.md, queue A item 6b): restoring
a store over several shards.
Unlike the JAX package the port updates its
tensors in place, and ``dense``/``flat`` return tensors on the store's
device; ``state_arrays`` and ``meta`` give the snapshot format's numpy
arrays and keys.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.kmeans import resolve_device
from repro_torch.index.rescore_cache import (RESCORE_KINDS,
                                             DeviceRescoreCache,
                                             default_rescore_kind)

# Padded-slot coordinate: large enough that a padded candidate can never
# beat a real one, small enough that d * _PAD^2 stays finite in f32.
# Invariant: every slot at or past counts[cell] holds it in every
# coordinate, and id -1; the fp32 search's store scan scores it without
# reading those slots (``ops.flash_probe_store``'s ``pad``).
_PAD_COORD = 1e15

STORE_KINDS = ("padded", "paged")


def _sharded(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"queue A item 6b: the sharded index's "
                               f"other axes)")


def _round_up(v: int, mult: int) -> int:
    return ((v + mult - 1) // mult) * mult


def _pow2ceil(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def _ceil_div(a: int, b: int) -> int:
    return -(-int(a) // int(b))


def _pad_value(dtype: torch.dtype):
    """The far-away sentinel for float payloads; 0 for int8 code pools
    (quantized stores mask padding through the zero scale)."""
    return _PAD_COORD if dtype.is_floating_point else 0


def _sublane_min(dtype: torch.dtype) -> int:
    """Floor of the gather width: the reference's minimum tile for the
    dtype (8 rows of f32, 16 of bf16, 32 of int8). Kept so that gather
    widths, and with them the q8 proposal depth and the plan keys, equal
    the reference's."""
    return max(8, 32 // max(1, dtype.itemsize))


def default_store_kind() -> str:
    """The process-wide default backend (``REPRO_BUCKET_STORE``, else
    ``"padded"``), read as the reference reads it."""
    kind = os.environ.get("REPRO_BUCKET_STORE", "padded").strip().lower()
    if kind not in STORE_KINDS:
        raise ValueError(f"REPRO_BUCKET_STORE={kind!r}: "
                         f"expected one of {STORE_KINDS}")
    return kind


def _resolve_kind(kind: str | None) -> str:
    kind = kind or default_store_kind()
    if kind not in STORE_KINDS:
        raise ValueError(f"unknown bucket store kind {kind!r}")
    return kind


def make_store(kind: str | None, k: int, d: int, dtype, *, capacity: int = 8,
               max_cap: int | None = None, page_size: int | None = None,
               max_bytes: int | None = None, n_shards: int = 1,
               device=None) -> "BucketStore":
    """A posting-list store (``kind=None``: ``default_store_kind()``);
    ``page_size`` (default 64) and ``max_bytes`` apply to the paged
    layout, as in the reference."""
    if _resolve_kind(kind) == "padded":
        return PaddedBucketStore(k, d, dtype, capacity=capacity,
                                 max_cap=max_cap, device=device)
    return PagedBucketStore(k, d, dtype, capacity=capacity, max_cap=max_cap,
                            page_size=page_size or 64, max_bytes=max_bytes,
                            n_shards=n_shards, device=device)


# ---------------------------------------------------------------------------
# the scan view: one addressing rule for both layouts
# ---------------------------------------------------------------------------

class ScanView(NamedTuple):
    """What the store scans read: ``rows (pages, page_size, d)`` (the int8
    codes of a quantized store), ``ids (pages, page_size)`` int32,
    ``table (K + 1, maxp)`` int32 page ids, ``counts (K + 1,)`` int32 (the
    last, the sentinel cell K's, 0) and on a quantized store ``scales
    (pages, page_size)`` f32 and ``anchors (K + 1, d)`` f32. Slot ``w`` of
    cell ``c`` is row ``w % page_size`` of page ``table[c, w //
    page_size]``; ``table=None`` is the padded layout, K pages of ``cap``
    rows, cell ``c`` on page ``c`` (the kernels then look no page up)."""
    rows: torch.Tensor
    ids: torch.Tensor
    table: torch.Tensor | None
    counts: torch.Tensor
    page_size: int
    scales: torch.Tensor | None = None
    anchors: torch.Tensor | None = None

    def locate(self, cell: torch.Tensor, w: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(page, row)`` of slot ``w`` of ``cell`` (int tensors of any
        shape, cells in ``[0, K]``). The sentinel cell K lands on a page of
        other rows (the paged table's page 0, the padded layout's last
        cell): mask what is read there."""
        if self.table is None:
            return cell.clamp(max=self.rows.shape[0] - 1), w
        page = self.table[cell, torch.div(w, self.page_size,
                                          rounding_mode="floor")]
        return page, w % self.page_size

    def ids_at(self, cell: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The ids at slot ``w`` of ``cell``; -1 for the sentinel cell."""
        page, row = self.locate(cell, w)
        return torch.where(cell < self.counts.shape[0] - 1,
                           self.ids[page, row], -1)

    def q8_at(self, cell: torch.Tensor, w: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """A quantized store's ``(ids, rows)`` at slot ``w`` of ``cell``:
        the ids (the sentinel cell's unmasked: its slots score ``+inf``,
        which the caller masks) and the dequantized rows ``anchor[cell] +
        code * scale``."""
        page, row = self.locate(cell, w)
        return self.ids[page, row], (self.anchors[cell] + self.rows[
            page, row].float() * self.scales[page, row].unsqueeze(-1))


# ---------------------------------------------------------------------------
# candidate gathers (the block path the store scans are held to)
# ---------------------------------------------------------------------------

def candidate_slots(t: torch.Tensor, probe: torch.Tensor,
                    width: int) -> torch.Tensor:
    """``width`` slots of each probed cell of a per-slot store array ``t
    (K, cap, ...)``, probe-rank major: ``(B, nprobe * width, ...)``."""
    b, nprobe = probe.shape
    return t[:, :width][probe.long()].reshape(b, nprobe * width,
                                              *t.shape[2:])


def _page_ids(tables: torch.Tensor, probe: torch.Tensor, width: int,
              page_size: int, n_shards: int, pool_pages: int) -> torch.Tensor:
    """``(B, nprobe * width / page_size)`` pool pages of the probed cells'
    first ``width`` slots (unmapped entries are page 0 of the cell's shard,
    its padding page). Over ``n_shards`` shards the tables hold shard-local
    page ids and shard ``s`` owns pool pages ``[s pps, (s + 1) pps)``."""
    b, nprobe = probe.shape
    wp = width // page_size
    p = probe.long()
    pid = tables[:, :wp][p].long()
    if n_shards != 1:
        cps = tables.shape[0] // n_shards
        pid = pid + (torch.div(p, cps, rounding_mode="floor")
                     * (pool_pages // n_shards)).unsqueeze(-1)
    return pid.reshape(b, nprobe * wp)


def _local_pages(tables: torch.Tensor, cell: torch.Tensor, width: int,
                 page_size: int) -> torch.Tensor:
    """``(bl, ll * width / page_size)`` pages of a shard's pool under local
    ``cell (bl, ll)``, ``k_local`` being the padding cell, all of whose
    slots map to the shard's padding page 0 (ref. l.205-211)."""
    wp = width // page_size
    tpad = torch.cat([tables[:, :wp], tables.new_zeros((1, wp))])
    bl, ll = cell.shape
    return tpad[cell.long()].reshape(bl, ll * wp).long()


def gather_global(kind: str, arrays, probe: torch.Tensor, width: int,
                  page_size: int = 0, n_shards: int = 1
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``probe (B, nprobe)`` cells -> ``(cand_x (B, nprobe*width, d),
    cand_ids (B, nprobe*width))``: ``width`` slots of each probed cell,
    probe-rank major (ref. l.161-186). ``arrays``: the store's
    ``device_arrays()``; on a paged store ``width`` is a multiple of
    ``page_size``. The block is materialized in device memory, as in the
    reference (``B * nprobe * width * d`` elements). The port's fp32
    search does not gather (``ops.flash_probe_store`` reads the store in
    place); this is the block path it is held to."""
    if _resolve_kind(kind) == "padded":
        return tuple(candidate_slots(t, probe, width) for t in arrays)
    pool, pool_ids, tables = arrays
    pid = _page_ids(tables, probe, width, page_size, n_shards, pool.shape[0])
    b, w = pid.shape[0], pid.shape[1] * page_size
    return pool[pid].reshape(b, w, pool.shape[-1]), pool_ids[pid].reshape(b, w)


def gather_cells(kind: str, arrays, cell: torch.Tensor, width: int,
                 page_size: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The shard-local candidate gather (ref. l.189-215): ``cell (bl, ll)``
    holds local cell indices, ``k_local`` (the owned cell count) being the
    not-owned padding cell, whose slots are ``_PAD_COORD`` rows with id -1
    (the paged store's padding page); ``arrays`` are the owned shard's
    ``device_arrays()``. Returns ``(cand_x (bl, ll * width, d), cand_ids
    (bl, ll * width))``. The sharded search does not gather (the store scan
    reads the owned cells in place through ``scan_view``); this is the block
    path it is held to."""
    bl, ll = cell.shape
    if _resolve_kind(kind) != "padded":
        pool, pool_ids, tables = arrays[:3]
        pid = _local_pages(tables, cell, width, page_size)
        w = pid.shape[1] * page_size
        return (pool[pid].reshape(bl, w, pool.shape[-1]),
                pool_ids[pid].reshape(bl, w))
    buckets, bucket_ids = arrays[:2]
    d = buckets.shape[-1]
    bpad = torch.cat([buckets[:, :width], torch.full(
        (1, width, d), _PAD_COORD, dtype=buckets.dtype,
        device=buckets.device)])
    ipad = torch.cat([bucket_ids[:, :width], torch.full(
        (1, width), -1, dtype=torch.int32, device=bucket_ids.device)])
    c = cell.long()
    return (bpad[c].reshape(bl, ll * width, d),
            ipad[c].reshape(bl, ll * width))


def gather_cells_q8(kind: str, arrays, cell: torch.Tensor, width: int,
                    page_size: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantized shard-local gather (ref. l.244-277): ``(codes (bl, ll *
    width, d) int8, scales (bl, ll * width) f32, ids)``. The padding cell
    ``k_local`` lands on zero-scale slots (zero codes, id -1 on the padded
    layout; the padding page on the paged one), so its rows mask out of the
    scan as unmapped pages do. ``arrays``: the owned shard's inner
    ``device_arrays()`` (anchors that follow are ignored)."""
    bl, ll = cell.shape
    if _resolve_kind(kind) != "padded":
        pool, pool_ids, tables, pool_aux = arrays[:4]
        pid = _local_pages(tables, cell, width, page_size)
        w = pid.shape[1] * page_size
        return (pool[pid].reshape(bl, w, pool.shape[-1]),
                pool_aux[pid].reshape(bl, w), pool_ids[pid].reshape(bl, w))
    buckets, bucket_ids, bucket_aux = arrays[:3]
    d = buckets.shape[-1]
    c = cell.long()
    bpad = torch.cat([buckets[:, :width], buckets.new_zeros((1, width, d))])
    apad = torch.cat([bucket_aux[:, :width],
                      bucket_aux.new_zeros((1, width))])
    ipad = torch.cat([bucket_ids[:, :width], torch.full(
        (1, width), -1, dtype=torch.int32, device=bucket_ids.device)])
    return (bpad[c].reshape(bl, ll * width, d),
            apad[c].reshape(bl, ll * width), ipad[c].reshape(bl, ll * width))


def gather_global_q8(kind: str, arrays, probe: torch.Tensor, width: int,
                     page_size: int = 0, n_shards: int = 1
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantized variant (ref. l.218-241): ``(codes (B, nprobe*width, d)
    int8, scales (B, nprobe*width) f32, ids)``; padding slots carry scale
    0.0. ``arrays``: the inner store's ``device_arrays()`` (the anchors
    that follow them are ignored). The port's q8 search does not gather
    either (``ops.flash_probe_store_q8`` reads the quantized store in
    place); this is the block path it is held to."""
    if _resolve_kind(kind) == "padded":
        buckets, bucket_ids, bucket_aux = arrays[:3]
        return tuple(candidate_slots(t, probe, width)
                     for t in (buckets, bucket_aux, bucket_ids))
    pool, pool_ids, tables, pool_aux = arrays[:4]
    pid = _page_ids(tables, probe, width, page_size, n_shards, pool.shape[0])
    b, w = pid.shape[0], pid.shape[1] * page_size
    return (pool[pid].reshape(b, w, pool.shape[-1]),
            pool_aux[pid].reshape(b, w), pool_ids[pid].reshape(b, w))


# ---------------------------------------------------------------------------
# the store contract
# ---------------------------------------------------------------------------

class BucketStore:
    """Shared bookkeeping: counts (device tensor and host mirror) and
    spill accounting."""

    kind = "abstract"
    codec_kind = "fp32"

    def __init__(self, k: int, d: int, dtype, *, max_cap: int | None = None,
                 device=None):
        self.k, self.d = int(k), int(d)
        self.dtype = dtype
        self.device = torch.device("cpu" if device is None else device)
        # posting lists never grow past max_cap slots per cell: overflow
        # rows spill (counted, not stored)
        self.max_cap = None if max_cap is None \
            else max(8, _round_up(max_cap, 8))
        self._counts_np = np.zeros(self.k, np.int64)
        # the owned cells [lo, lo + k_owned): all of them until ``place``
        self.lo, self.k_owned = 0, self.k
        self._pctx = None
        self._upload_counts()
        self.spilled = 0
        self.evicted = 0
        self.spill_counts = np.zeros(self.k, np.int64)
        self.evict_counts = np.zeros(self.k, np.int64)

    def _account_spill(self, cells: np.ndarray) -> None:
        self.spill_counts += np.bincount(
            cells, minlength=self.k).astype(np.int64)
        self.spilled += int(cells.size)

    def _upload_counts(self) -> None:
        """Mirror the host counts on the device as ``counts_sentinel`` (K +
        1,) int32, whose last entry, the sentinel cell ``K``, is always 0;
        ``counts`` is the view of its first K. The routed search's probe
        lists hold ``K`` where a query has fewer candidate cells than
        ``nprobe``, and the store scans read that cell as one without
        rows. On a store placed over a mesh ``counts`` stays global and
        ``counts_sentinel`` is the owned cells' (K/P_k + 1,), the last the
        shard's own sentinel cell ``K/P_k``."""
        full = torch.as_tensor(np.append(self._counts_np, 0),
                               dtype=torch.int32, device=self.device)
        self.counts = full[:self.k]
        if self.k_owned == self.k:
            self.counts_sentinel = full
        else:
            self.counts_sentinel = torch.as_tensor(
                np.append(self._counts_np[self.lo:self.lo + self.k_owned],
                          0), dtype=torch.int32, device=self.device)

    def set_counts(self, v) -> None:
        """Test/repair seam: overwrite the logical list lengths."""
        self._counts_np = np.asarray(v).astype(np.int64)
        self._upload_counts()

    @property
    def max_count(self) -> int:
        return int(self._counts_np.max()) if self.k else 0

    @property
    def capacity(self) -> int:
        raise NotImplementedError

    def append(self, cells: np.ndarray, x_sorted: torch.Tensor,
               ids: np.ndarray) -> None:
        """Store a CSR-ordered batch: ``cells`` ascending (host), the
        matching rows ``x_sorted`` (device) and their int32 ids (host)."""
        raise NotImplementedError

    def gather_width(self, min_slots: int = 1) -> int:
        raise NotImplementedError

    def device_arrays(self) -> tuple:
        raise NotImplementedError

    def scan_view(self) -> ScanView:
        """The search's view of the store (``ScanView``)."""
        raise NotImplementedError

    def dense(self) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def dense_aux(self) -> torch.Tensor:
        """``(K, W)`` per-slot sidecar (a quantized store's scales) in slot
        order, as ``dense``."""
        raise NotImplementedError

    def dense_ids(self) -> torch.Tensor:
        raise NotImplementedError

    def flat(self) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def state_arrays(self) -> dict:
        raise NotImplementedError

    def meta(self) -> dict:
        raise NotImplementedError

    def resident_bytes(self) -> int:
        raise NotImplementedError

    @property
    def n_shards(self) -> int:
        return 1

    def place(self, pctx) -> None:
        """Keep on this rank's device only the cells it owns under
        ``pctx``'s ``k_axis`` (see the module docstring)."""
        raise NotImplementedError

    def shard_specs(self, ka) -> tuple:
        """The split of ``device_arrays()`` over the cells axis ``ka``."""
        raise NotImplementedError

    def _whole(self, t: torch.Tensor) -> torch.Tensor:
        """The whole store's ``t`` from the owned cells' (gathered over the
        cells axis on a placed store)."""
        if self._pctx is None:
            return t
        return self._pctx.gather(t, (self._pctx.k_axis,))

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class PaddedBucketStore(BucketStore):
    """One ``(K, cap, d)`` tensor; amortized-doubling growth; ``max_cap``
    spill budget; optional per-slot f32 sidecar (codec scales)."""

    kind = "padded"

    def __init__(self, k: int, d: int, dtype, *, capacity: int = 8,
                 max_cap: int | None = None, aux: bool = False, device=None):
        super().__init__(k, d, dtype, max_cap=max_cap, device=device)
        self.cap = max(8, _round_up(int(capacity), 8))
        if self.max_cap is not None:
            self.cap = min(self.cap, self.max_cap)
        self.has_aux = bool(aux)
        self._alloc()

    def _alloc(self) -> None:
        """Empty tensors of the owned cells at the current capacity."""
        kw = {"device": self.device}
        self.buckets = torch.full((self.k_owned, self.cap, self.d),
                                  _pad_value(self.dtype), dtype=self.dtype,
                                  **kw)
        self.bucket_ids = torch.full((self.k_owned, self.cap), -1,
                                     dtype=torch.int32, **kw)
        self.bucket_aux = torch.zeros((self.k_owned, self.cap),
                                      dtype=torch.float32, **kw) \
            if self.has_aux else None

    def place(self, pctx) -> None:
        """Keep only the cells this rank owns under ``pctx``'s ``k_axis``
        (ref. l.519-525): a contiguous ``K / P_k`` of them, their rows cut
        from the whole store's tensors without communication. Idempotent;
        a context without a ``k_axis`` leaves the store whole."""
        if pctx.k_axis is None:
            return
        kl = pctx.k_local(self.k)
        lo = pctx.k_rank * kl
        if self._pctx is not None:
            if (lo, kl) != (self.lo, self.k_owned):
                raise ValueError("the store is already placed on another "
                                 "shard")
            return
        own = slice(lo, lo + kl)
        self.buckets = self.buckets[own].contiguous()
        self.bucket_ids = self.bucket_ids[own].contiguous()
        if self.has_aux:
            self.bucket_aux = self.bucket_aux[own].contiguous()
        self.lo, self.k_owned, self._pctx = lo, kl, pctx
        self._upload_counts()

    def shard_specs(self, ka) -> tuple:
        """The split of ``device_arrays()`` over the cells axis ``ka``."""
        if self.has_aux:
            return ((ka, None, None), (ka, None), (ka, None))
        return ((ka, None, None), (ka, None))

    @property
    def capacity(self) -> int:
        return self.cap

    def append(self, cells, x_sorted, ids, aux=None):
        n = int(cells.shape[0])
        if n == 0:
            return
        cells = np.asarray(cells, np.int64)
        ids = np.asarray(ids, np.int32)
        rank = np.arange(n) - np.searchsorted(cells, cells)
        slots = self._counts_np[cells] + rank
        needed = int(slots.max()) + 1
        if needed > self.cap:
            self._grow(needed)
        if needed > self.cap:   # max_cap reached: spill the overflow
            keep = slots < self.cap
            self._account_spill(cells[~keep])
            kj = np.flatnonzero(keep)
            cells, slots, ids = cells[kj], slots[kj], ids[kj]
            kt = torch.as_tensor(kj, device=x_sorted.device)
            x_sorted = x_sorted[kt]
            if aux is not None:
                aux = aux[kt]
        if cells.size:
            own = (cells >= self.lo) & (cells < self.lo + self.k_owned)
            if not own.all():   # a placed store writes its own cells only
                oj = np.flatnonzero(own)
                ot = torch.as_tensor(oj, device=x_sorted.device)
                x_own = x_sorted[ot]
                aux_own = aux[ot] if aux is not None else None
                c_own, s_own, i_own = cells[oj], slots[oj], ids[oj]
            else:
                x_own, aux_own, c_own, s_own, i_own = (x_sorted, aux, cells,
                                                       slots, ids)
            if c_own.size:
                cj = torch.as_tensor(c_own - self.lo, device=self.device)
                sj = torch.as_tensor(s_own, device=self.device)
                self.buckets[cj, sj] = x_own.to(self.dtype)
                self.bucket_ids[cj, sj] = torch.as_tensor(i_own,
                                                          device=self.device)
                if self.has_aux and aux_own is not None:
                    self.bucket_aux[cj, sj] = aux_own.float()
            self._counts_np += np.bincount(
                cells, minlength=self.k).astype(np.int64)
            self._upload_counts()

    def _grow(self, needed: int) -> None:
        """Amortized doubling, clamped to the ``max_cap`` budget."""
        new_cap = max(_round_up(needed, 8), 2 * self.cap)
        if self.max_cap is not None:
            new_cap = min(new_cap, self.max_cap)
        if new_cap <= self.cap:
            return
        pad, ko = new_cap - self.cap, self.k_owned
        self.buckets = torch.cat([self.buckets, torch.full(
            (ko, pad, self.d), _pad_value(self.dtype), dtype=self.dtype,
            device=self.device)], dim=1)
        self.bucket_ids = torch.cat([self.bucket_ids, torch.full(
            (ko, pad), -1, dtype=torch.int32, device=self.device)], dim=1)
        if self.has_aux:
            self.bucket_aux = torch.cat([self.bucket_aux, torch.zeros(
                (ko, pad), dtype=torch.float32, device=self.device)], dim=1)
        self.cap = new_cap

    def gather_width(self, min_slots: int = 1) -> int:
        sl = _sublane_min(self.dtype)
        w = _pow2ceil(max(sl, self.max_count))
        w = max(w, _round_up(max(1, min_slots), sl))
        return min(self.cap, w)

    def device_arrays(self):
        if self.has_aux:
            return (self.buckets, self.bucket_ids, self.bucket_aux)
        return (self.buckets, self.bucket_ids)

    def scan_view(self) -> ScanView:
        return ScanView(self.buckets, self.bucket_ids, None,
                        self.counts_sentinel, self.cap, self.bucket_aux)

    def dense(self):
        return self._whole(self.buckets), self._whole(self.bucket_ids)

    def dense_aux(self):
        return None if self.bucket_aux is None \
            else self._whole(self.bucket_aux)

    def dense_ids(self):
        return self._whole(self.bucket_ids)

    def flat(self):
        x, ids = self.dense()
        return (x.reshape(self.k * self.cap, self.d),
                ids.reshape(self.k * self.cap))

    def state_arrays(self):
        x, ids = self.dense()
        out = {"buckets": x.cpu().numpy(),
               "bucket_ids": ids.cpu().numpy(),
               "counts": self.counts.cpu().numpy(),
               "spill_counts": self.spill_counts.copy()}
        if self.has_aux:
            out["bucket_aux"] = self.dense_aux().cpu().numpy()
        return out

    def meta(self):
        return {"kind": self.kind, "cap": self.cap, "max_cap": self.max_cap,
                "spilled": int(self.spilled)}

    @classmethod
    def restore(cls, host, meta, *, k, d, dtype, device=None):
        st = cls(k, d, dtype, capacity=meta["cap"],
                 max_cap=meta.get("max_cap"), aux="bucket_aux" in host,
                 device=device)
        if st.cap != meta["cap"]:
            raise ValueError(f"capacity {meta['cap']} does not survive the "
                             f"store's rounding (got {st.cap})")
        st.buckets = torch.tensor(np.asarray(host["buckets"]),
                                  device=st.device).to(dtype)
        st.bucket_ids = torch.tensor(np.asarray(host["bucket_ids"]),
                                     device=st.device).to(torch.int32)
        if st.has_aux:
            st.bucket_aux = torch.tensor(np.asarray(host["bucket_aux"]),
                                         device=st.device).float()
        st.set_counts(host["counts"])
        st.spill_counts = np.asarray(host["spill_counts"]).astype(
            np.int64).copy()
        st.spilled = int(meta.get("spilled", st.spill_counts.sum()))
        return st

    def resident_bytes(self) -> int:
        """Bytes this rank's device holds (the owned cells on a placed
        store)."""
        aux = 4 if self.has_aux else 0
        return self.k_owned * self.cap * (self.d * self.dtype.itemsize + 4
                                          + aux)

    def __repr__(self):
        own = (f", cells {self.lo}-{self.lo + self.k_owned - 1}"
               if self.k_owned != self.k else "")
        return (f"PaddedBucketStore(k={self.k}, d={self.d}, "
                f"cap={self.cap}{own})")


# ---------------------------------------------------------------------------
# paged layout (one pool of pages, page tables, free list, LRU eviction)
# ---------------------------------------------------------------------------

class PagedBucketStore(BucketStore):
    """Fixed-size pages in one pool, a page table per cell, a free list per
    shard handing out the lowest id first, LRU eviction under ``max_bytes``
    (ref. ``repro/index/store.py:543-906``). Shard ``s`` owns cells ``[s
    cps, (s + 1) cps)`` (``cps = K / n_shards``) and pool pages ``[s pps,
    (s + 1) pps)``, its local page 0 being its padding page; the tables hold
    shard-local page ids. The host keeps the allocator's state
    (``tables_np``, ``pages_np``, ``last_touch``, ``_tick``, ``_frees``);
    the device holds the pool of the shards it holds (all of them until
    ``place``, then its own) and ``tables``, the owned cells' rows."""

    kind = "paged"

    def __init__(self, k: int, d: int, dtype, *, capacity: int = 8,
                 max_cap: int | None = None, page_size: int = 64,
                 max_bytes: int | None = None, n_shards: int = 1,
                 aux: bool = False, device=None):
        super().__init__(k, d, dtype, max_cap=max_cap, device=device)
        if self.k % int(n_shards):
            raise ValueError(f"k={k} not divisible by n_shards={n_shards}")
        self.has_aux = bool(aux)
        self.page_size = max(8, _round_up(int(page_size), 8))
        self._n_shards = int(n_shards)
        self.cells_per_shard = self.k // self._n_shards
        self.max_bytes = max_bytes
        # table width (pages per cell) sized for the capacity hint; the
        # pool starts one doubling above the single-hot-cell need
        self.maxp = max(1, _ceil_div(int(capacity), self.page_size))
        if self.max_cap is not None:
            self.maxp = min(self.maxp,
                            max(1, _ceil_div(self.max_cap, self.page_size)))
        pps = max(2, _pow2ceil(1 + self.maxp))
        if self.max_bytes is not None:
            pps = min(pps, max(2, self._budget_pps()))
        self.pps = pps                      # pages a shard (incl. pad)
        self.tables_np = np.zeros((self.k, self.maxp), np.int32)
        self.pages_np = np.zeros(self.k, np.int32)
        self.last_touch = np.zeros(self.k, np.int64)
        self._tick = 0
        # each shard's free list, ascending (its page 0 is the reserved
        # padding page): the reference's lists, which also stay sorted
        self._frees: list[list[int]] = [list(range(1, self.pps))
                                        for _ in range(self._n_shards)]
        rows = self._n_shards * self.pps
        self.pool = torch.full((rows, self.page_size, self.d),
                               _pad_value(self.dtype), dtype=self.dtype,
                               device=self.device)
        self.pool_ids = torch.full((rows, self.page_size), -1,
                                   dtype=torch.int32, device=self.device)
        self.pool_aux = torch.zeros((rows, self.page_size),
                                    dtype=torch.float32, device=self.device) \
            if self.has_aux else None
        self._upload_tables()

    # -- geometry ------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.maxp * self.page_size

    @property
    def n_shards(self) -> int:
        return self._n_shards

    @property
    def _held(self) -> tuple[int, int]:
        """The shards whose pages this device holds: ``(first, count)``,
        all of them until ``place``."""
        cps = self.cells_per_shard
        return self.lo // cps, self.k_owned // cps

    def _page_bytes(self) -> int:
        aux = 4 if self.has_aux else 0
        return self.page_size * (self.d * self.dtype.itemsize + 4 + aux)

    def _budget_pps(self) -> int:
        return int(self.max_bytes // (self._n_shards * self._page_bytes()))

    def _pool_rows(self, cells: np.ndarray, pages: np.ndarray) -> np.ndarray:
        """Rows of this device's pool of the shard-local ``pages`` of
        ``cells`` (broadcast against each other; cells of held shards)."""
        return (cells // self.cells_per_shard - self._held[0]) * self.pps \
            + pages

    def _holds(self, cells: np.ndarray) -> np.ndarray:
        sh = cells // self.cells_per_shard
        return (sh >= self._held[0]) & (sh < self._held[0] + self._held[1])

    def _upload_tables(self) -> None:
        """The owned cells' tables on the device (``tables``, shard-local
        ids, as ``device_arrays`` gives them) and the scan's table: rows of
        this device's pool, with the sentinel cell's row of page 0 (the
        padding page; the reference's ``gather_cells`` pads the same
        way)."""
        lo, kl = self.lo, self.k_owned
        t = self.tables_np[lo:lo + kl]
        self.tables = torch.as_tensor(t, device=self.device)
        if self._held[1] > 1:
            t = self._pool_rows(np.arange(lo, lo + kl)[:, None], t)
        self._scan_table = torch.as_tensor(
            np.concatenate([t, np.zeros((1, self.maxp), t.dtype)]).astype(
                np.int32), device=self.device)

    def place(self, pctx) -> None:
        """Keep only this rank's shard under ``pctx``'s ``k_axis`` (ref.
        l.880-887): its ``pps`` pages of the pool, ids and sidecar, cut
        without communication, and its cells' tables. The store must have
        been built with ``n_shards`` equal to the axis's size. Idempotent;
        a context without a ``k_axis`` leaves the store whole."""
        if pctx.k_axis is None:
            return
        if pctx.n_k_shards != self._n_shards:
            raise ValueError(f"a paged store of {self._n_shards} shards on a "
                             f"{pctx.n_k_shards}-way cells axis")
        kl = pctx.k_local(self.k)
        s = pctx.k_rank
        if self._pctx is not None:
            if (s * kl, kl) != (self.lo, self.k_owned):
                raise ValueError("the store is already placed on another "
                                 "shard")
            return
        own = slice(s * self.pps, (s + 1) * self.pps)
        self.pool = self.pool[own].contiguous()
        self.pool_ids = self.pool_ids[own].contiguous()
        if self.has_aux:
            self.pool_aux = self.pool_aux[own].contiguous()
        self.lo, self.k_owned, self._pctx = s * kl, kl, pctx
        self._upload_counts()
        self._upload_tables()

    def shard_specs(self, ka) -> tuple:
        """The split of ``device_arrays()`` over the cells axis ``ka``."""
        specs = ((ka, None, None), (ka, None), (ka, None))
        return specs + ((ka, None),) if self.has_aux else specs

    # -- allocator -----------------------------------------------------

    def _grow_pool(self, new_pps: int) -> None:
        """Each held shard's slice grown to ``new_pps`` pages, the old pages
        copied in and the new ones padding; their ids join every shard's
        free list."""
        h = self._held[1]

        def grown(t, fill):
            out = torch.full((h, new_pps, *t.shape[1:]), fill, dtype=t.dtype,
                             device=self.device)
            out[:, :self.pps] = t.view(h, self.pps, *t.shape[1:])
            return out.view(h * new_pps, *t.shape[1:])
        self.pool = grown(self.pool, _pad_value(self.dtype))
        self.pool_ids = grown(self.pool_ids, -1)
        if self.has_aux:
            self.pool_aux = grown(self.pool_aux, 0.0)
        for free in self._frees:
            free.extend(range(self.pps, new_pps))
        self.pps = new_pps

    def _grow_tables(self, need: int) -> None:
        new_maxp = _pow2ceil(max(need, self.maxp + 1))
        if self.max_cap is not None:
            new_maxp = min(new_maxp,
                           max(need, _ceil_div(self.max_cap,
                                               self.page_size)))
        self.tables_np = np.pad(self.tables_np,
                                ((0, 0), (0, new_maxp - self.maxp)))
        self.maxp = new_maxp

    def _evict(self, cell: int) -> None:
        """Free a cold cell's pages back to its shard's allocator: its rows
        are dropped (counted, like spills), its pages reset to padding
        where this device holds them, so the flat/brute views never see
        stale vectors."""
        npg = int(self.pages_np[cell])
        pids = self.tables_np[cell, :npg].tolist()
        sh = cell // self.cells_per_shard
        if self._holds(np.int64(cell)):
            gp = torch.as_tensor(self._pool_rows(
                np.int64(cell), np.asarray(pids, np.int64)),
                dtype=torch.long, device=self.device)
            self.pool[gp] = _pad_value(self.dtype)
            self.pool_ids[gp] = -1
            if self.has_aux:
                self.pool_aux[gp] = 0.0
        lost = int(self._counts_np[cell])
        self.evict_counts[cell] += lost
        self.evicted += lost
        self._counts_np[cell] = 0
        self.pages_np[cell] = 0
        self.tables_np[cell, :] = 0
        self._frees[sh] = sorted(self._frees[sh] + pids)

    def _next_pps(self, pps: int) -> int:
        """A shard of ``pps`` pages after one growth step (doubling, within
        the byte budget); no larger when the budget is spent."""
        new_pps = 2 * pps
        if self.max_bytes is not None:
            new_pps = min(new_pps, self._budget_pps())
        return new_pps

    def _reach(self, need: int, shard: int) -> tuple[int, int]:
        """``(pages, pps)``: the pages ``shard``'s free list and pool growth
        can hand out before an eviction, growing (as the reference's
        allocator does whenever a free list runs dry) no further than
        ``need`` asks, and the pool size that takes."""
        avail, pps = len(self._frees[shard]), self.pps
        while avail < need and (nxt := self._next_pps(pps)) > pps:
            avail += nxt - pps
            pps = nxt
        return avail, pps

    def _take(self, n: int, shard: int) -> list[int]:
        """``shard``'s ``n`` lowest free ids at once (``n`` within
        ``_reach``), the pool grown first as the reference's allocator
        would."""
        _, pps = self._reach(n, shard)
        if pps > self.pps:
            self._grow_pool(pps)
        free = self._frees[shard]
        taken, self._frees[shard] = free[:n], free[n:]
        return taken

    def _alloc(self, shard: int, protect: np.ndarray) -> int | None:
        """One free page of ``shard`` (lowest id), via its free list, then
        pool growth within the byte budget, then eviction (ref. l.667-689,
        the fallback of ``_map_pages``); ``None`` = refused. The reference's
        eviction loop waits on the free list it started with, which
        ``_evict`` replaces, so once the budget is spent it evicts every
        cell of the shard not in ``protect`` (bool (K,)) that holds pages,
        coldest first, and then refuses the page: the caller drops the
        cell's remaining rows, and the next cell takes the freed pages. The
        port keeps that, so that both stores hold the same pages (ROADMAP.md,
        queue C)."""
        if self._frees[shard]:
            return self._frees[shard].pop(0)
        new_pps = self._next_pps(self.pps)
        if new_pps > self.pps:
            self._grow_pool(new_pps)
            return self._frees[shard].pop(0)
        lo = shard * self.cells_per_shard
        span = slice(lo, lo + self.cells_per_shard)
        cand = lo + np.flatnonzero((self.pages_np[span] > 0) & ~protect[span])
        for c in cand[np.argsort(self.last_touch[cand], kind="stable")]:
            self._evict(int(c))
        return None

    def _map_pages(self, ucells: np.ndarray, need: np.ndarray) -> dict:
        """Give each cell of ``ucells`` (ascending) ``need`` pages of its
        shard, cell by cell and page by page lowest id first, as the
        reference does. A shard's cells come one after another, so shard by
        shard: the longest prefix of its cells whose new pages fit without
        an eviction takes its ids at once; from the first cell that needs
        an eviction on, one page at a time through ``_alloc``. Returns
        ``{cell: first unstorable slot}`` for cells the budget cannot
        hold."""
        ps = self.page_size
        for n in need[need > self.maxp]:       # tables widen in cell order
            if n > self.maxp:
                self._grow_tables(int(n))
        shard = ucells // self.cells_per_shard
        drop_from, protect = {}, None
        for sh in np.unique(shard):
            sel = shard == sh
            uc, nd = ucells[sel], need[sel]
            have = self.pages_np[uc].astype(np.int64)
            new = np.maximum(nd - have, 0)
            total = np.cumsum(new)
            # the longest prefix the free list and pool growth can hold
            avail, _ = self._reach(int(total[-1]) if total.size else 0,
                                   int(sh))
            m = int(np.searchsorted(total, avail, side="right"))
            if m:
                ids = np.asarray(self._take(int(total[m - 1]), int(sh)),
                                 np.int32)
                nm = new[:m]
                # (cell, page) of each new page, cell-major: a cell's pages
                # from its count of pages on
                rank = np.arange(ids.size) - np.repeat(total[:m] - nm, nm)
                self.tables_np[np.repeat(uc[:m], nm),
                               np.repeat(have[:m], nm) + rank] = ids
                self.pages_np[uc[:m]] = np.maximum(have[:m], nd[:m])
            if m < uc.size:
                if protect is None:
                    protect = np.zeros(self.k, bool)
                    protect[ucells] = True
                for c, n in zip(uc[m:], nd[m:]):
                    c = int(c)
                    for p in range(int(self.pages_np[c]), int(n)):
                        pid = self._alloc(int(sh), protect)
                        if pid is None:           # budget truly exhausted
                            drop_from[c] = p * ps
                            break
                        self.tables_np[c, p] = pid
                        self.pages_np[c] = p + 1
        return drop_from

    # -- the contract --------------------------------------------------

    def _keep_rows(self, keep: np.ndarray, cells, slots, ids, x, aux):
        kj = np.flatnonzero(keep)
        kt = torch.as_tensor(kj, device=x.device)
        return (cells[kj], slots[kj], ids[kj], x[kt],
                None if aux is None else aux[kt])

    def append(self, cells, x_sorted, ids, aux=None):
        n = int(cells.shape[0])
        if n == 0:
            return
        ps = self.page_size
        cells = np.asarray(cells, np.int64)
        ids = np.asarray(ids, np.int32)
        rank = np.arange(n) - np.searchsorted(cells, cells)
        slots = self._counts_np[cells] + rank
        if self.max_cap is not None:     # same budget rule as padded
            over = slots >= self.max_cap
            if over.any():
                self._account_spill(cells[over])
                cells, slots, ids, x_sorted, aux = self._keep_rows(
                    ~over, cells, slots, ids, x_sorted, aux)
        ucells, ustart = np.unique(cells, return_index=True)
        uend = np.r_[ustart[1:], cells.size] - 1
        umax = slots[uend] if cells.size else np.zeros(0, np.int64)
        drop_from = self._map_pages(ucells, umax // ps + 1)
        if drop_from:
            thr = np.full(self.k, np.iinfo(np.int64).max)
            for c, t in drop_from.items():
                thr[c] = t
            over = slots >= thr[cells]
            self._account_spill(cells[over])
            cells, slots, ids, x_sorted, aux = self._keep_rows(
                ~over, cells, slots, ids, x_sorted, aux)
        if cells.size:
            self._counts_np += np.bincount(
                cells, minlength=self.k).astype(np.int64)
            held = self._holds(cells)
            if not held.all():   # a placed store writes its own cells only
                cells, slots, ids, x_sorted, aux = self._keep_rows(
                    held, cells, slots, ids, x_sorted, aux)
            if cells.size:
                gj = torch.as_tensor(
                    self._pool_rows(cells, self.tables_np[cells,
                                                          slots // ps]),
                    dtype=torch.long, device=self.device)
                sj = torch.as_tensor(slots % ps, device=self.device)
                self.pool[gj, sj] = x_sorted.to(self.dtype)
                self.pool_ids[gj, sj] = torch.as_tensor(ids,
                                                        device=self.device)
                if self.has_aux and aux is not None:
                    self.pool_aux[gj, sj] = aux.float()
        if ucells.size:                  # write-recency LRU clock
            self._tick += 1
            self.last_touch[ucells] = self._tick
        self._upload_counts()
        self._upload_tables()

    def gather_width(self, min_slots: int = 1) -> int:
        wp = _pow2ceil(max(1, int(self.pages_np.max()) if self.k else 1))
        wp = max(wp, _ceil_div(max(_sublane_min(self.dtype), min_slots),
                               self.page_size))
        return min(wp, self.maxp) * self.page_size

    def device_arrays(self):
        if self.has_aux:
            return (self.pool, self.pool_ids, self.tables, self.pool_aux)
        return (self.pool, self.pool_ids, self.tables)

    def scan_view(self) -> ScanView:
        return ScanView(self.pool, self.pool_ids, self._scan_table,
                        self.counts_sentinel, self.page_size, self.pool_aux)

    def _dense_of(self, t: torch.Tensor) -> torch.Tensor:
        """The whole store's ``(K, maxp * page_size, ...)`` slot view of a
        per-slot pool tensor (gathered over the cells axis when placed)."""
        lo, kl = self.lo, self.k_owned
        gp = torch.as_tensor(self._pool_rows(
            np.arange(lo, lo + kl)[:, None], self.tables_np[lo:lo + kl]
        ).reshape(-1), dtype=torch.long, device=self.device)
        return self._whole(t[gp].reshape(kl, self.maxp * self.page_size,
                                         *t.shape[2:]))

    def dense(self):
        return self._dense_of(self.pool), self._dense_of(self.pool_ids)

    def dense_aux(self):
        return self._dense_of(self.pool_aux)

    def dense_ids(self):
        return self._dense_of(self.pool_ids)

    def flat(self):
        # pad pages carry _PAD_COORD/-1: safe to scan wholesale; the shards'
        # slices gathered in shard order are the reference's pool
        return (self._whole(self.pool).reshape(-1, self.d),
                self._whole(self.pool_ids).reshape(-1))

    def _occupied(self) -> np.ndarray:
        """Occupied pages as rows of this device's pool, cell-major in page
        order (an unplaced store's)."""
        mask = np.arange(self.maxp)[None, :] < self.pages_np[:, None]
        rows = self._pool_rows(np.arange(self.k)[:, None], self.tables_np)
        return rows[mask].astype(np.int64)

    def _packed(self, t: torch.Tensor) -> np.ndarray:
        """``t``'s occupied pages in cell-major page order (on a placed
        store from the gathered slot view)."""
        if self._pctx is None:
            return t[torch.as_tensor(self._occupied(),
                                     device=self.device)].cpu().numpy()
        mask = np.arange(self.maxp)[None, :] < self.pages_np[:, None]
        dense = self._dense_of(t).reshape(self.k, self.maxp, *t.shape[1:])
        return dense[torch.as_tensor(mask, device=self.device)].cpu().numpy()

    def state_arrays(self):
        # canonical packed form: occupied pages in cell-major page order
        # (physical page ids / free-list fragmentation never serialize)
        out = {"pool_pages": self._packed(self.pool),
               "pool_page_ids": self._packed(self.pool_ids),
               "cell_pages": self.pages_np.astype(np.int32),
               "counts": self.counts.cpu().numpy(),
               "last_touch": self.last_touch.copy(),
               "spill_counts": self.spill_counts.copy(),
               "evict_counts": self.evict_counts.copy()}
        if self.has_aux:
            out["pool_page_aux"] = self._packed(self.pool_aux)
        return out

    def meta(self):
        return {"kind": self.kind, "page_size": self.page_size,
                "pps": self.pps, "maxp": self.maxp,
                "n_shards": self._n_shards, "max_cap": self.max_cap,
                "max_bytes": self.max_bytes, "spilled": int(self.spilled),
                "evicted": int(self.evicted), "tick": int(self._tick)}

    @classmethod
    def restore(cls, host, meta, *, k, d, dtype, device=None):
        """The store of a snapshot's packed pages (ref. l.825-878): pages
        re-allocated cell-major, lowest id first."""
        if int(meta.get("n_shards") or 1) != 1:
            raise _sharded("restoring a paged store of several shards")
        ps = int(meta["page_size"])
        st = cls(k, d, dtype, capacity=ps, page_size=ps,
                 max_cap=meta.get("max_cap"), max_bytes=meta.get("max_bytes"),
                 aux="pool_page_aux" in host, device=device)
        st.maxp = max(1, int(meta["maxp"]))
        cell_pages = np.asarray(host["cell_pages"], np.int64)
        used = int(cell_pages.sum()) + 1
        if meta.get("n_shards") == 1 and meta.get("pps"):
            pps = max(int(meta["pps"]), used)
        else:   # another mesh's snapshot: the canonical size
            pps = max(2, _pow2ceil(used))
        st.pps = pps
        n_occ = used - 1
        # occupied page u takes id u + 1: the lowest free ids, cell-major
        st.tables_np = np.zeros((k, st.maxp), np.int32)
        mask = np.arange(st.maxp)[None, :] < cell_pages[:, None]
        st.tables_np[mask] = np.arange(1, n_occ + 1, dtype=np.int32)
        st._frees = [list(range(n_occ + 1, pps))]

        def pool_of(shape, fill, dt, pages):
            t = torch.full((pps, *shape), fill, dtype=dt, device=st.device)
            if n_occ:
                t[1:n_occ + 1] = torch.as_tensor(np.asarray(pages)).to(
                    device=st.device, dtype=dt)
            return t
        st.pool = pool_of((ps, d), _pad_value(st.dtype), st.dtype,
                          host["pool_pages"])
        st.pool_ids = pool_of((ps,), -1, torch.int32, host["pool_page_ids"])
        if st.has_aux:
            st.pool_aux = pool_of((ps,), 0.0, torch.float32,
                                  host["pool_page_aux"])
        st.pages_np = cell_pages.astype(np.int32)
        st.set_counts(host["counts"])
        st._upload_tables()
        st.last_touch = np.asarray(host["last_touch"]).astype(np.int64)
        st._tick = int(meta.get("tick", st.last_touch.max(initial=0)))
        st.spilled = int(meta.get("spilled", host["spill_counts"].sum()))
        st.spill_counts = np.asarray(host["spill_counts"]).astype(
            np.int64).copy()
        st.evicted = int(meta.get("evicted", host["evict_counts"].sum()))
        st.evict_counts = np.asarray(host["evict_counts"]).astype(
            np.int64).copy()
        return st

    def resident_bytes(self) -> int:
        """Bytes this rank's device holds (its shard's pages and its cells'
        tables on a placed store)."""
        return (self._held[1] * self.pps * self._page_bytes()
                + self.k_owned * self.maxp * 4)

    def occupied_pages(self) -> int:
        return int(self.pages_np.sum())

    def __repr__(self):
        return (f"PagedBucketStore(k={self.k}, d={self.d}, "
                f"page_size={self.page_size}, pages={self.occupied_pages()}"
                f"/{self._n_shards * self.pps}, shards={self._n_shards}, "
                f"evicted={self.evicted})")


# ---------------------------------------------------------------------------
# quantized payloads: rescore reservoir + codec wrapper
# ---------------------------------------------------------------------------

class RescoreReservoir:
    """Host-side full-precision row pool keyed by global id — the exact
    half of two-phase search. The quantized scan proposes top-``R`` ids;
    the verify phase looks their original f32 rows up here. FIFO ring
    under an optional byte budget: evicted rows rescore from their
    decoded codes instead. Unbounded, the pool is a list of segments, each
    at least as large as all before it (the capacity grows geometrically)
    and never copied, so an add costs O(batch) where the reference copies
    the whole pool; global row ``r`` lies in the segment that starts at or
    before it (``_starts``)."""

    def __init__(self, d: int, *, max_bytes: int | None = None):
        self.d = int(d)
        self.max_bytes = max_bytes
        cap = self._cap_rows()
        n0 = 0 if cap is None else cap
        self._rows = np.zeros((n0, self.d), np.float32)   # the ring
        self._ids = np.full(n0, -1, np.int64)    # id held per row
        self._segs: list[tuple[np.ndarray, np.ndarray]] = []   # unbounded
        self._starts: list[int] = []             # each segment's first row
        self._n = 0                              # rows used (unbounded)
        self._id2row = np.full(1024, -1, np.int64)
        self._cursor = 0
        self.evicted = 0

    def _cap_rows(self) -> int | None:
        if self.max_bytes is None:
            return None
        return max(1, int(self.max_bytes) // (4 * self.d + 8))

    def _used(self) -> list[tuple[np.ndarray, np.ndarray]]:
        """(rows, ids) of the pool's occupied rows, in append order."""
        if self._cap_rows() is not None:
            return [(self._rows, self._ids)]
        return [(r[:self._n - lo], i[:self._n - lo])
                for (r, i), lo in zip(self._segs, self._starts)]

    def __len__(self) -> int:
        return sum(int((ids >= 0).sum()) for _, ids in self._used())

    def resident_bytes(self) -> int:
        cap = self._cap_rows()
        return (self._n if cap is None else cap) * (4 * self.d + 8)

    def _ensure_index(self, max_id: int) -> None:
        if max_id >= self._id2row.size:
            grown = np.full(_pow2ceil(max_id + 1), -1, np.int64)
            grown[:self._id2row.size] = self._id2row
            self._id2row = grown

    def _segment_of(self, row: np.ndarray):
        """(segment, offset) of global rows of the unbounded pool."""
        seg = np.searchsorted(np.asarray(self._starts), row,
                              side="right") - 1
        return seg, row - np.asarray(self._starts)[seg]

    def _write(self, row: np.ndarray, x: np.ndarray) -> None:
        if self._cap_rows() is not None:
            self._rows[row] = x
            return
        seg, off = self._segment_of(row)
        for s_ in np.unique(seg):
            sel = seg == s_
            self._segs[s_][0][off[sel]] = x[sel]

    def _read(self, row: np.ndarray) -> np.ndarray:
        if self._cap_rows() is not None:
            return self._rows[row]
        out = np.empty((row.size, self.d), np.float32)
        seg, off = self._segment_of(row)
        for s_ in np.unique(seg):
            sel = seg == s_
            out[sel] = self._segs[s_][0][off[sel]]
        return out

    def _append(self, new_ids: np.ndarray, new_x: np.ndarray) -> None:
        """Unbounded: fill the last segment, then open one as large as the
        pool so far (at least the rest of the batch)."""
        self._id2row[new_ids] = self._n + np.arange(new_ids.size)
        done = 0
        while done < new_ids.size:
            if not self._segs or \
                    self._n == self._starts[-1] + len(self._segs[-1][1]):
                size = max(new_ids.size - done, self._n)
                self._segs.append((np.empty((size, self.d), np.float32),
                                   np.full(size, -1, np.int64)))
                self._starts.append(self._n)
            rows, ids = self._segs[-1]
            lo = self._n - self._starts[-1]
            m = min(len(ids) - lo, new_ids.size - done)
            rows[lo:lo + m] = new_x[done:done + m]
            ids[lo:lo + m] = new_ids[done:done + m]
            done += m
            self._n += m

    def put(self, ids, x) -> None:
        ids = np.asarray(ids, np.int64).reshape(-1)
        x = np.asarray(x, np.float32).reshape(-1, self.d)
        if ids.size == 0:
            return
        self._ensure_index(int(ids.max()))
        row = self._id2row[ids]
        have = row >= 0
        if have.any():                      # refresh in place
            self._write(row[have], x[have])
        new_ids, new_x = ids[~have], x[~have]
        if new_ids.size == 0:
            return
        cap = self._cap_rows()
        if cap is None:                     # unbounded: O(batch) append
            self._append(new_ids, new_x)
            return
        if new_ids.size > cap:              # batch larger than the ring
            self.evicted += new_ids.size - cap
            new_ids, new_x = new_ids[-cap:], new_x[-cap:]
        pos = (self._cursor + np.arange(new_ids.size)) % cap
        old = self._ids[pos]
        dropped = old[old >= 0]
        self._id2row[dropped] = -1
        self.evicted += int(dropped.size)
        self._rows[pos] = new_x
        self._ids[pos] = new_ids
        self._id2row[new_ids] = pos
        self._cursor = int((self._cursor + new_ids.size) % cap)

    def lookup(self, ids) -> tuple[np.ndarray, np.ndarray]:
        """``ids`` any-shape int -> (rows ``ids.shape + (d,)`` f32,
        found bool). Missing / negative ids return zero rows."""
        ids = np.asarray(ids, np.int64)
        safe = np.clip(ids, 0, self._id2row.size - 1)
        row = np.where((ids >= 0) & (ids < self._id2row.size),
                       self._id2row[safe], -1)
        found = row >= 0
        out = np.zeros(ids.shape + (self.d,), np.float32)
        out[found] = self._read(row[found])
        return out, found

    def state_arrays(self) -> dict:
        """Occupied rows packed oldest-first (ring order)."""
        cap = self._cap_rows()
        if cap is None:
            used = self._used()
            rows = np.concatenate([r for r, _ in used]) if used else \
                self._rows
            ids = np.concatenate([i for _, i in used]) if used else self._ids
            keep = ids >= 0
            return {"rescore_rows": rows[keep], "rescore_ids": ids[keep]}
        order = (self._cursor + np.arange(cap)) % cap
        order = order[self._ids[order] >= 0]
        return {"rescore_rows": self._rows[order],
                "rescore_ids": self._ids[order]}

    @classmethod
    def restore(cls, host, d: int, *, max_bytes=None) -> "RescoreReservoir":
        res = cls(d, max_bytes=max_bytes)
        res.put(host["rescore_ids"], host["rescore_rows"])
        res.evicted = 0
        return res


class QuantizedBucketStore(BucketStore):
    """Codec wrapper over either layout: the inner store holds int8 codes
    plus the per-slot f32 scale sidecar (its ids, page tables, allocator,
    evictor and snapshot form untouched); the wrapper owns the anchors (the
    cell centroids frozen at encode time: ``refresh`` moves the routing
    centroids only, so stored codes stay decodable), the optional
    ``RescoreReservoir`` and the optional ``DeviceRescoreCache``
    (ref. ``repro/index/store.py:1025-1160``). ``kind`` stays the inner
    backend's name."""

    def __init__(self, inner: BucketStore, codec, anchors, *,
                 reservoir: RescoreReservoir | None = None,
                 cache=None, logical_dtype=torch.float32):
        # no super().__init__: the bookkeeping is the inner store's
        self._inner = inner
        self.codec = codec
        self.device = inner.device
        # anchors_sentinel (K + 1, d) ends in a zero row for the sentinel
        # cell K (see ``_upload_counts``); ``anchors`` is its first K
        a = torch.as_tensor(anchors).to(device=self.device,
                                        dtype=torch.float32)
        self._anchors_all = a           # all K (the owned rows: ``anchors``)
        self._set_anchors(a)
        self.reservoir = reservoir
        self.cache = cache              # DeviceRescoreCache | None
        self.dtype = logical_dtype      # what consumers feed us
        self.k, self.d = inner.k, inner.d

    def _set_anchors(self, a: torch.Tensor) -> None:
        self.anchors_sentinel = torch.cat([a, a.new_zeros((1, a.shape[1]))])
        self.anchors = self.anchors_sentinel[:a.shape[0]]

    kind = property(lambda self: self._inner.kind)
    n_shards = property(lambda self: self._inner.n_shards)
    codec_kind = property(lambda self: self.codec.kind)
    counts = property(lambda self: self._inner.counts)
    counts_sentinel = property(lambda self: self._inner.counts_sentinel)
    max_count = property(lambda self: self._inner.max_count)
    max_cap = property(lambda self: self._inner.max_cap)
    capacity = property(lambda self: self._inner.capacity)
    evicted = property(lambda self: self._inner.evicted)
    evict_counts = property(lambda self: self._inner.evict_counts)
    # the paged layout's (AttributeError on a padded inner store, as the
    # reference's delegation raises)
    page_size = property(lambda self: self._inner.page_size)

    def occupied_pages(self) -> int:
        return self._inner.occupied_pages()

    @property
    def spilled(self) -> int:
        return self._inner.spilled

    @spilled.setter
    def spilled(self, v) -> None:
        self._inner.spilled = v

    @property
    def spill_counts(self):
        return self._inner.spill_counts

    @spill_counts.setter
    def spill_counts(self, v) -> None:
        self._inner.spill_counts = v

    def set_counts(self, v) -> None:
        self._inner.set_counts(v)

    def gather_width(self, min_slots: int = 1) -> int:
        return self._inner.gather_width(min_slots)

    def append(self, cells, x_sorted, ids):
        if int(np.asarray(cells).shape[0]) == 0:
            return
        cj = torch.as_tensor(np.asarray(cells), device=self.device)
        x32 = x_sorted.float()
        codes, scales = self.codec.encode(x32, self._anchors_all[cj])
        if self.reservoir is not None:
            self.reservoir.put(np.asarray(ids), x32.cpu().numpy())
        if self.cache is not None:      # the device rows, no host copy
            self.cache.put(ids, x32, shard=self._cache_shard(cells))
        self._inner.append(cells, codes, ids, aux=scales)

    def _cache_shard(self, cells) -> np.ndarray | None:
        """Each row's home K-shard (``cell // (K / shards)``), as the
        reference's ``append`` passes it (l.1117-1121); None on one."""
        if self.cache.shards == 1:
            return None
        return np.asarray(cells) // (self.k // self.cache.shards)

    def device_arrays(self):
        return (*self._inner.device_arrays(), self.anchors)

    def shard_specs(self, ka) -> tuple:
        return (*self._inner.shard_specs(ka), (ka, None))

    def place(self, pctx) -> None:
        """The inner store's ``place``, the owned anchors (with the shard's
        sentinel row, zero) and the cache's owned slice (ref. l.1100-1106)."""
        self._inner.place(pctx)
        lo, kl = self._inner.lo, self._inner.k_owned
        self._set_anchors(self._anchors_all[lo:lo + kl])
        if self.cache is not None:
            self.cache.place(pctx)

    def scan_view(self) -> ScanView:
        """The inner store's view with its scales and ``anchors_sentinel``."""
        return self._inner.scan_view()._replace(anchors=self.anchors_sentinel)

    def cache_arrays(self):
        """The device rescore cache's ``(keys, rows)``: what the search's
        lookup reads (never part of ``device_arrays``: the fp32 and host
        paths do not read them)."""
        return self.cache.device_arrays()

    def _rewarm_cache(self) -> None:
        """Re-warm the device cache from the host reservoir after a restore
        (ref. l.1133-1151): every row the reservoir still holds, cell-major,
        so the resident set under a byte budget follows from the state."""
        if self.cache is None or self.reservoir is None:
            return
        ids = self._inner.dense_ids().cpu().numpy()
        cells = np.broadcast_to(np.arange(self.k)[:, None], ids.shape)
        live = ids >= 0
        ids_v, cells_v = ids[live], cells[live]
        rows, found = self.reservoir.lookup(ids_v)
        self.cache.put(ids_v[found], rows[found],
                       shard=self._cache_shard(cells_v[found]))

    def dense(self):
        """Decoded f32 view with the reservoir's original rows overlaid —
        the rows two-phase rescore scores, so brute force and two-phase
        search score identical rows. Padding slots hold ``_PAD_COORD``."""
        codes, ids = self._inner.dense()
        x = self._anchors_all.unsqueeze(1) + codes.float() * \
            self._inner.dense_aux().unsqueeze(-1)
        if self.reservoir is not None:
            rows, found = self.reservoir.lookup(ids.cpu().numpy())
            found_t = torch.as_tensor(found, device=self.device)
            x = torch.where(found_t.unsqueeze(-1),
                            torch.as_tensor(rows, device=self.device), x)
        x = torch.where((ids < 0).unsqueeze(-1),
                        torch.full_like(x, _PAD_COORD), x)
        return x, ids

    def dense_ids(self):
        return self._inner.dense_ids()

    def flat(self):
        x, ids = self.dense()
        return x.reshape(-1, self.d), ids.reshape(-1)

    def state_arrays(self):
        out = self._inner.state_arrays()
        out["anchors"] = self._anchors_all.cpu().numpy()
        if self.reservoir is not None:
            out.update(self.reservoir.state_arrays())
        return out

    def meta(self):
        return dict(self._inner.meta(), codec=self.codec.kind,
                    reservoir=self.reservoir is not None,
                    rescore_bytes=None if self.reservoir is None
                    else self.reservoir.max_bytes,
                    rescore_cache=None if self.cache is None
                    else self.cache.meta())

    @classmethod
    def restore(cls, host, meta, *, k, d, dtype, device=None):
        """The store of a snapshot's arrays and manifest (ref. l.1200-1234).
        A manifest that records ``rescore_cache`` rebuilds that cache (or
        none); one without the key takes the process default. The cache
        re-warms from the reservoir."""
        from repro_torch.index.quant import make_codec
        codec = make_codec(meta["codec"])
        inner = _layout(meta.get("kind", "padded")).restore(
            host, meta, k=k, d=d, dtype=codec.pool_dtype, device=device)
        reservoir = None
        if meta.get("reservoir") and "rescore_ids" in host:
            reservoir = RescoreReservoir.restore(
                host, d, max_bytes=meta.get("rescore_bytes"))
        if "rescore_cache" in meta:
            cmeta = meta["rescore_cache"]
            cache = None if cmeta is None else DeviceRescoreCache(
                d, max_bytes=cmeta.get("max_bytes"),
                ways=cmeta.get("ways", 4), device=inner.device)
        elif resolve_rescore(None) == "device":
            cache = DeviceRescoreCache(d, max_bytes=meta.get("rescore_bytes"),
                                       device=inner.device)
        else:
            cache = None
        st = cls(inner, codec, np.array(host["anchors"], np.float32),
                 reservoir=reservoir, cache=cache, logical_dtype=dtype)
        st._rewarm_cache()
        return st

    def resident_bytes(self) -> int:
        extra = 0 if self.cache is None else self.cache.resident_bytes()
        return (self._inner.resident_bytes() + self.anchors.numel() * 4
                + extra)

    def payload_bytes(self) -> int:
        """Device bytes of the codes, ids and scales alone (ref. l.1247):
        what compares with an fp32 store's ``resident_bytes``."""
        return self._inner.resident_bytes()

    def __repr__(self):
        res = len(self.reservoir) if self.reservoir is not None else 0
        return (f"QuantizedBucketStore(codec={self.codec.kind}, "
                f"inner={self._inner!r}, reservoir_rows={res}, "
                f"cache={self.cache!r})")


def resolve_rescore(rescore: str | None) -> str:
    """The q8 phase-2 row source: ``"device"`` (the ``DeviceRescoreCache``)
    or ``"host"`` (the reservoir round trip, the parity oracle); ``None``
    means ``default_rescore_kind()`` (``REPRO_RESCORE``, else
    ``"device"``), as in the reference. With an unbounded cache the two
    return identical results."""
    rescore = rescore or default_rescore_kind()
    if rescore not in RESCORE_KINDS:
        raise ValueError(
            f"unknown rescore kind {rescore!r}: expected {RESCORE_KINDS}")
    return rescore


def _layout(kind: str) -> type:
    """The store class of a layout kind."""
    return PaddedBucketStore if _resolve_kind(kind) == "padded" \
        else PagedBucketStore


def make_quantized_store(kind: str | None, k: int, d: int, dtype, *,
                         anchors, codec: str = "q8", capacity: int = 8,
                         max_cap: int | None = None,
                         page_size: int | None = None,
                         max_bytes: int | None = None, n_shards: int = 1,
                         rescore_bytes: int | None = None,
                         reservoir: bool = True,
                         rescore: str | None = None,
                         device=None) -> QuantizedBucketStore:
    """Codec-wrapped store of either layout (ref. l.1262-1306) with a
    ``RescoreReservoir`` under an optional byte budget (``rescore_bytes``;
    ``reservoir=False``: none, so the host rescore and ``dense()`` decode
    the codes) and, for ``rescore="device"`` (``None``: ``REPRO_RESCORE``,
    else device), a ``DeviceRescoreCache`` under the same budget, with or
    without the reservoir, as in the reference."""
    from repro_torch.index.quant import make_codec
    cdc = make_codec(codec)
    rescore = resolve_rescore(rescore)
    if _resolve_kind(kind) == "padded":
        inner = PaddedBucketStore(k, d, cdc.pool_dtype, capacity=capacity,
                                  max_cap=max_cap, aux=True, device=device)
    else:
        inner = PagedBucketStore(k, d, cdc.pool_dtype, capacity=capacity,
                                 max_cap=max_cap, page_size=page_size or 64,
                                 max_bytes=max_bytes, n_shards=n_shards,
                                 aux=True, device=device)
    cache = DeviceRescoreCache(d, max_bytes=rescore_bytes, shards=n_shards,
                               device=inner.device) \
        if rescore == "device" else None
    res = RescoreReservoir(d, max_bytes=rescore_bytes) if reservoir \
        else None
    return QuantizedBucketStore(inner, cdc, anchors, reservoir=res,
                                cache=cache, logical_dtype=dtype)


def restore_store(host: dict, meta: dict, *, k: int, d: int, dtype,
                  n_shards: int = 1, device=None) -> BucketStore:
    """A store from snapshot arrays and manifest meta (ref. l.120-133):
    either layout, either codec. Manifests without a ``codec`` key
    (snapshot v1/v2) are fp32. ``device=None`` means ``"cuda"``."""
    if n_shards != 1:
        raise _sharded("restoring a store over several shards")
    dev = resolve_device(device)
    if meta.get("codec", "fp32") != "fp32":
        return QuantizedBucketStore.restore(host, meta, k=k, d=d,
                                            dtype=dtype, device=dev)
    return _layout(meta.get("kind", "padded")).restore(
        host, meta, k=k, d=d, dtype=dtype, device=dev)


def infer_store_meta(host: dict, meta: dict) -> dict:
    """Store meta for a snapshot the manifest does not cover (an older
    seqno than it records): scalars re-derived from the array shapes (ref.
    l.136-156)."""
    if "buckets" in host:
        return {"kind": "padded", "cap": int(host["buckets"].shape[1]),
                "max_cap": meta.get("max_cap"),
                "spilled": int(host["spill_counts"].sum())}
    cell_pages = host["cell_pages"]
    ps = int(host["pool_pages"].shape[1])
    return {"kind": "paged", "page_size": ps,
            "maxp": max(1, int(cell_pages.max()) if cell_pages.size else 1),
            "pps": 0, "n_shards": 1, "max_cap": meta.get("max_cap"),
            "max_bytes": None,
            "spilled": int(host["spill_counts"].sum()),
            "evicted": int(host["evict_counts"].sum()),
            "tick": int(host["last_touch"].max())
            if host["last_touch"].size else 0}
