"""FlashIVF — an online IVF vector-search index on the port's kernels.

Port of ``repro/index/ivf.py`` for one device, both stores (``padded``
and ``paged``: ``store=``, ``page_size=``, ``store_bytes=``), both routers
and both codecs:

- **train** — ``build`` fits the coarse centroids with the port's
  ``KMeans`` (init from a ``torch.Generator`` seeded with ``seed``, so the
  centroids differ from the reference's ``jax.random`` init) and assigns
  the corpus with FlashAssign;
- **invert** — posting lists are the sort-inverse mapping: one stable sort
  of the assignments is the concatenation of all lists;
- **probe** — ``ops.flash_probe`` picks each query's ``nprobe`` nearest
  cells and ``ops.flash_probe_store`` scans their live rows in place in
  the store, through its page table (the store's ``scan_view``; the
  reference gathers a ``(B, nprobe*width, d)`` candidate block first; the
  result is the same); on a ``q8`` store
  ``ops.flash_probe_store_q8`` proposes the top ``R`` from the int8 codes,
  read in place as well, and ``flash_probe_grouped`` rescores the ``R``
  rows in fp32, read from the ``DeviceRescoreCache`` by a gather on the
  card (``rescore="device"``, the default: no host read on the search
  path) or from the host ``RescoreReservoir`` (``rescore="host"``, the
  parity oracle);
- **route** — the router (``index/router.py``) picks each query's
  ``nprobe`` cells from its view of the index's centroids, which the index
  keeps until they move or the router re-groups them. With
  ``router="two_level"`` a coarse FlashProbe picks each query's
  ``nprobe_c`` nearest groups and the store scan reads those groups' fine
  centroids in place in that view, a ``(K_c, gcap, d)`` table (the
  reference gathers a ``(B, nprobe_c * gcap, d)`` block of them); a query
  with fewer candidates than ``nprobe`` gets the sentinel cell ``K``. The
  bucket scans read ``K`` as a cell with no rows (the store's
  ``counts_sentinel`` and ``anchors_sentinel``), so its slots score as
  padding, with id -1;
- **online** — ``add`` assigns with FlashAssign, appends in CSR order and
  folds the batch statistics into pending ``SufficientStats``;
  ``refresh`` commits them and re-centers the centroids, O(K d).

The out-of-core build (``build(chunk_size=)``) trains with
``ChunkedKMeans`` and inverts the chunk stream through ``add``.

Durability and faults (``reliability/``): ``save``/``load`` write and read
snapshots in the reference's format (``reliability/snapshot.py``), and
``faults`` takes a ``FaultInjector`` consulted at the reference's seams in
``add``, ``refresh`` and ``search``.

**Sharded FlashIVF** (``pctx``, a ``core.parallel.ParallelContext``): the
cells are split over the mesh's cells axis, each rank owning ``K / P_k``
centroids, their posting lists (the owned rows of a padded store, or the
owned shard's pages of a paged one; on a q8 store also their anchors and
the rescore cache's slice of their ids) and their running statistics; the
host bookkeeping (counts, capacity, page tables, ids, the host reservoir)
stays global on every rank. A search runs, on every rank, on its slice of
the queries (split over the data axes, a ragged batch padded):

  cell selection  ->  the store scan of the owned probed cells, read in
  place  ->  cross-rank top-k merge (O(b topk) bytes), ties broken by the
  global probe order, as on one device.

The cell selection is FlashProbe over the owned centroids and a cross-rank
top-``nprobe`` merge (O(b L) bytes); under the two-level router, the coarse
probe on every rank (the coarse level is replicated, so every rank gets the
same groups with no traffic), the store scan over the rank's fine table (its
own fine centroids, padding rows elsewhere), and the same merge with the
candidate-axis position as the tie key. On a q8 store the scan proposes the
top ``R`` from the codes, the proposals merge to ``R``, and one all-reduce of
``(b, R, d)`` rows (each rank's own proposals dequantized, or the cache's
rows where it holds them) brings every proposal's row to the rank that
rescores it.

The posting lists' rows never cross ranks outside that q8 exchange.
``build`` trains through the context (the data- and cell-sharded Lloyd
loop), ``add`` assigns by the two-stage argmin and sums the owned
statistics over the data axes. ``counts``, ``posting_lists``,
``search_brute`` and ``len`` answer the whole index on every rank (the
middle two gather, a collective); ``centroids`` is the owned slice
(``global_centroids()`` gathers it).

Under faults (``faults``, the same ``FaultPlan`` on every rank, polled in
lockstep) a ``dead_shard`` event on a K-sharded index blanks that K-shard
out of every cross-rank merge of the search (``shard_ok``, passed as
``merge_topl(valid=)``; on q8 its proposals are blanked before the row
exchange), so the search is the brute force over the surviving shards'
rows; the next call heals. On a data-only mesh, or one device, the event
raises ``InjectedFault``. ``refresh(guard=True)`` sanitizes each rank's owned
statistics and counts the repaired cells over the cells axis, so
``repaired_cells`` is the same on every rank; ``refresh(repair_dead=True)``
gathers the K centroids and statistics, runs the one-device repair on every
rank (the donor is the heaviest of all K cells) and keeps the owned slice.
``save`` gathers the state (every rank calls it) and rank 0 writes it;
``load(pctx=)`` restores a snapshot of any mesh, or of none, onto any mesh.
``IVFIndex`` runs on the card unless it is asked for the CPU:
``device=None`` means ``"cuda"`` (or, with ``pctx``, the mesh's device) and
raises when no CUDA device is present.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import heuristics as _heur
from repro_torch.core import plan as _plan
from repro_torch.core.chunked import ChunkedKMeans
from repro_torch.core.init import init_centroids
from repro_torch.core.kmeans import KMeans, KMeansConfig, resolve_device
from repro_torch.core.streaming import SufficientStats
from repro_torch.index import router as _router
from repro_torch.index import store as _store
from repro_torch.index.rescore_cache import cache_lookup
from repro_torch.kernels import ops, ref
from repro_torch.reliability.faults import InjectedFault, corrupt_stats

_PAD_COORD = _store._PAD_COORD
# entries of a brute-force score matrix scored at a time (1 GiB of f32):
# four ranks sharing one card each hold one
BRUTE_CHUNK_ELEMS = 1 << 28


def _as_float(a, device) -> torch.Tensor:
    """``a`` on ``device``, as float32 unless it is bfloat16 (numpy's
    float64 becomes float32, as ``jnp.asarray`` makes it)."""
    t = torch.as_tensor(a).to(device)
    return t if t.dtype in (torch.float32, torch.bfloat16) else t.float()


def csr_from_assignments(a: torch.Tensor, k: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """CSR posting lists from an assignment vector: ``order`` (N,) int32 is
    the stable argsort of ``a`` (cluster-major, original order within a
    cluster), ``offsets`` (K+1,) int32 the segment boundaries."""
    a_sorted, order = torch.sort(a, stable=True)
    offsets = torch.searchsorted(
        a_sorted, torch.arange(k + 1, dtype=a_sorted.dtype, device=a.device))
    return order.to(torch.int32), offsets.to(torch.int32)


def recall_at_k(ids, ids_ref) -> float:
    """Mean fraction of reference neighbours retrieved, per query; ``-1``
    slots count as misses."""
    ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids)
    ids_ref = np.asarray(ids_ref.cpu() if isinstance(ids_ref, torch.Tensor)
                         else ids_ref)
    k = ids_ref.shape[1]
    return float(np.mean([
        len(set(a.tolist()) & set(b.tolist()) - {-1}) / k
        for a, b in zip(ids, ids_ref)]))


def _train_sharded(pctx, cfg: KMeansConfig, gen: torch.Generator,
                   x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Build-time training over a mesh (ref. l.121-145): the
    ``ParallelContext`` Lloyd loop from centroids drawn with ``gen`` (the
    same draw on every rank), then one two-stage assignment pass under the
    final centroids. A ragged N is padded and masked. Returns the global
    ``(centroids, assignments, min_sq_dists)``."""
    n = x.shape[0]
    c0 = init_centroids(x, cfg.k, cfg.init, generator=gen)
    x_pad, mask, _ = pctx.pad_points(x)
    ragged = x_pad.shape[0] != n
    fit = pctx.make_kmeans_fit(cfg, masked=ragged)
    c = (fit(x_pad, mask, c0) if ragged else fit(x_pad, c0)).centroids
    a, m = pctx.make_assign(cfg)(x_pad, c)
    return c, a[:n], m[:n]


def _take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t (B, C, ...)`` at ``idx (B, L)`` along axis 1."""
    idx = idx.long()
    if t.ndim == 2:
        return torch.gather(t, 1, idx)
    return torch.gather(t, 1, idx.reshape(*idx.shape, *([1] * (t.ndim - 2)))
                        .expand(*idx.shape, *t.shape[2:]))


def _slots(probe: torch.Tensor, li: torch.Tensor, width: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(cell, slot)`` of the store scans' probe-rank-major indices ``li =
    p * width + w`` (B, L): slot w of cell ``probe[b, p]``."""
    li = li.long()
    cell = torch.gather(probe, 1, torch.div(li, width, rounding_mode="floor"))
    return cell, li % width


def _scan_cells(q, probe, view, *, topk: int, width: int, plan=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The posting-list scan: the store scan keeps each query's top-k of
    its probed cells' ``width`` slots (probe-rank-major index ``p * width +
    w``), read in place through the store's ``view`` (``ScanView``), and
    the ids are looked up at those (B, topk) slots. A probe entry may be
    the sentinel cell K (the view's counts and table have K + 1 rows): its
    slots score as padding and take id -1."""
    li, dist = ops.flash_probe_store(q, view.rows, view.counts, probe,
                                     table=view.table, width=width, l=topk,
                                     pad=_PAD_COORD, plan=plan)
    cell, w = _slots(probe, li, width)
    return view.ids_at(cell, w), dist


def _q8_scan(q, probe, view, *, r: int, width: int, plan=None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 of two-phase search on a quantized store, past the probe:
    scan the probed cells' int8 codes and scales in place in the residual
    frame ``q' = q - anchor[cell]`` (the kernel's distance is then the true
    quantized one; the reference gathers a candidate block first, with the
    same result). Returns the top-``r`` ids (-1 where fewer than ``r``
    live candidates exist) and their dequantized rows, the rescore's
    fallback for ids the reservoir does not hold, decoded for those (B,
    r) proposals only. The sentinel cell K scores ``+inf`` (id -1)."""
    li, val = ops.flash_probe_store_q8(q, view.rows, view.scales, view.counts,
                                       probe, view.anchors, table=view.table,
                                       width=width, l=r, plan=plan)
    ids, deq = view.q8_at(*_slots(probe, li, width))
    return torch.where(torch.isfinite(val), ids, -1), deq


def _q8_propose(q, centroids, c_sq, view, *, r: int, nprobe: int,
                width: int, probe_plan=None, scan_plan=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 1 on the flat router: probe, then ``_q8_scan``."""
    probe = _router.probe_cells(q, centroids, c_sq, nprobe=nprobe,
                                plan=probe_plan)
    return _q8_scan(q, probe, view, r=r, width=width, plan=scan_plan)


def _rescore_rows(deq, ids, res_rows, found) -> torch.Tensor:
    """The rows phase 2 scores: the cache's or the reservoir's original
    rows where found, the dequantized codes otherwise; dead proposals (id
    -1) become padding rows."""
    cand = torch.where(found.unsqueeze(-1), res_rows, deq)
    return torch.where((ids < 0).unsqueeze(-1),
                       torch.full_like(cand, _PAD_COORD), cand)


def _rescore_body(q, cand, ids, res_rows, found, *, topk: int,
                  plan=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 2: score the proposed rows (``_rescore_rows``) at full
    precision and keep the true top-k."""
    cand = _rescore_rows(cand, ids, res_rows, found)
    li, dist = ops.flash_probe_grouped(q.to(cand.dtype), cand, l=topk,
                                       plan=plan)
    return _take_rows(ids, li), dist


class IVFIndex:
    """Online IVF index: coarse k-means cells + CSR posting lists.

    >>> index = IVFIndex.build(x, k=256, max_iters=10)          # on "cuda"
    >>> ids, dists = index.search(q, topk=10, nprobe=16)
    >>> index.add(x_new)                 # FlashAssign + list append
    >>> index.refresh()                  # warm-start re-center, O(K d)
    >>> ids_ref, _ = index.search_brute(q, topk=10)   # exactness oracle

    ``codec`` selects the payload ("fp32" | "q8", default from
    ``REPRO_BUCKET_CODEC``): a "q8" index stores int8 residual codes
    anchored at the construction-time centroids and searches in two
    phases (quantized top-``R`` proposal, ``R = rescore_mult * topk``
    clamped to the probed pool, or the codec-aware chooser with
    ``rescore_mult="auto"``; then an exact fp32 rescore).
    ``rescore_bytes`` budgets the rescore reservoir and the device cache
    (None = unbounded); ``rescore`` picks the rescore's row source
    (``"device"``, ``"host"``; None = ``REPRO_RESCORE``, else device).
    ``router`` picks how a search finds its ``nprobe`` cells (``"flat"``,
    ``"two_level"``, a router instance; None = ``REPRO_ROUTER``, else
    flat); a two-level router trains here over the centroids. ``store``
    picks the posting-list layout (``"padded"``, ``"paged"``, a store
    instance; None = ``REPRO_BUCKET_STORE``, else padded); ``page_size``
    (default 64) and ``store_bytes`` (the page pool's LRU budget) shape
    the paged one. ``pctx`` shards the index over a mesh, on every store,
    codec and router (see the module's docstring).
    """

    def __init__(self, centroids, capacity: int, *,
                 max_cap: int | None = None, device=None,
                 planner: "_plan.KernelPlanner | None" = None,
                 pctx=None, store: "str | _store.BucketStore | None" = None,
                 page_size: int | None = None,
                 store_bytes: int | None = None,
                 codec: str | None = None, rescore_mult: "int | str" = 4,
                 rescore_bytes: int | None = None,
                 rescore: str | None = None, router=None):
        self.pctx = pctx
        if pctx is not None:
            if device is None:
                device = pctx.device
            elif torch.device(device).type != pctx.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{pctx.device}")
        self.device = resolve_device(device)
        centroids = _as_float(centroids, self.device)
        k, d = centroids.shape
        self.k, self.d = k, d
        all_centroids = centroids       # what a two-level router trains on
        n_shards = 1
        if self._k_sharded:
            pctx.k_local(k)   # raises unless K divides the cells axis
            n_shards = pctx.n_k_shards
            centroids = pctx.shard_centroids(centroids)   # the owned slice
        self.centroids = centroids
        if isinstance(rescore_mult, str):
            if rescore_mult != "auto":
                raise ValueError(f"rescore_mult={rescore_mult!r}: "
                                 f"expected an int or 'auto'")
            self.rescore_mult = None   # chosen per geometry (_rescore_r)
        else:
            self.rescore_mult = max(1, int(rescore_mult))
        if isinstance(store, _store.BucketStore):
            self.store = store
        else:
            from repro_torch.index.quant import default_codec_kind
            codec = default_codec_kind() if codec is None else codec
            if codec == "fp32":
                self.store = _store.make_store(
                    store, k, d, centroids.dtype, capacity=int(capacity),
                    max_cap=max_cap, page_size=page_size,
                    max_bytes=store_bytes, n_shards=n_shards,
                    device=self.device)
            else:
                # codes are anchored at the construction-time centroids:
                # refresh() moves the routing centroids only
                self.store = _store.make_quantized_store(
                    store, k, d, centroids.dtype, anchors=all_centroids,
                    codec=codec, capacity=int(capacity), max_cap=max_cap,
                    page_size=page_size, max_bytes=store_bytes,
                    n_shards=n_shards, rescore_bytes=rescore_bytes,
                    rescore=rescore, device=self.device)
        if self._k_sharded:
            self.store.place(pctx)
        self.n_total = 0
        self.faults = None          # a reliability.faults.FaultInjector
        self.repaired_cells = 0     # NaN stats rows zeroed by refresh
        self.reseeded_cells = 0     # dead cells re-seeded by refresh
        # committed evidence (what the current centroids were refreshed
        # from) and pending evidence (folded in by the next refresh)
        self.stats = SufficientStats.zero(self.k_owned, d, self.device)
        self._pending = SufficientStats.zero(self.k_owned, d, self.device)
        self.planner = planner if planner is not None \
            else _plan.default_planner(self.device)
        self._cnorms: torch.Tensor | None = None   # ||c||^2, per centroid set
        self._view: tuple | None = None   # (router version, router's view)
        self._search_plans: dict[tuple, tuple] = {}
        # the coarse level of a two-level router trains on all K centroids
        # and is the same on every rank (ref. ``_place``: replicated)
        self.router = _router.make_router(router, all_centroids,
                                          planner=self.planner,
                                          device=self.device)

    # ------------------------------------------------------------------
    # store views
    # ------------------------------------------------------------------

    @property
    def dtype(self) -> torch.dtype:
        return self.store.dtype

    @property
    def cap(self) -> int:
        return self.store.capacity

    @property
    def max_cap(self) -> int | None:
        return self.store.max_cap

    @property
    def counts(self) -> torch.Tensor:
        return self.store.counts

    @counts.setter
    def counts(self, v) -> None:
        self.store.set_counts(v)

    @property
    def spilled(self) -> int:
        return self.store.spilled

    @property
    def spill_counts(self) -> np.ndarray:
        return self.store.spill_counts

    @property
    def evicted(self) -> int:
        return self.store.evicted

    @property
    def evict_counts(self) -> np.ndarray:
        return self.store.evict_counts

    @property
    def store_kind(self) -> str:
        return self.store.kind

    @property
    def codec_kind(self) -> str:
        return self.store.codec_kind

    def resident_bytes(self) -> int:
        """Device bytes held by the posting-list payload (+ anchors and the
        device rescore cache)."""
        return self.store.resident_bytes()

    def block_until_ready(self) -> None:
        self.store.block_until_ready()

    # ------------------------------------------------------------------
    # sharding plumbing (no-ops without a k-sharded ParallelContext)
    # ------------------------------------------------------------------

    @property
    def _k_sharded(self) -> bool:
        return self.pctx is not None and self.pctx.k_axis is not None

    @property
    def k_owned(self) -> int:
        """Cells this rank owns: ``K / P_k`` on a k-sharded index, else K."""
        return self.pctx.k_local(self.k) if self._k_sharded else self.k

    def _shard_cfg(self) -> KMeansConfig:
        """The config the sharded assign and stats programs plan with."""
        return KMeansConfig(k=self.k, planner=self.planner)

    def global_centroids(self) -> torch.Tensor:
        """All K centroids (gathered over the cells axis on a k-sharded
        index: a collective, every rank calls it)."""
        if not self._k_sharded:
            return self.centroids
        return self.pctx.gather(self.centroids, (self.pctx.k_axis,))

    def _corrupt_pending(self, seed: int) -> None:
        """The ``nan_stats`` fault: the reference's seeded rows of all K
        cells set to NaN in the pending statistics (a K-sharded rank
        corrupts those it owns)."""
        lo = self.pctx.k_rank * self.k_owned if self._k_sharded else 0
        self._pending, _ = corrupt_stats(self._pending, seed, k_total=self.k,
                                         lo=lo)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------

    @classmethod
    def build(cls, x, k: int, *, max_iters: int = 10, init: str = "kmeans++",
              tol: float = 0.0, step_impl: str = "auto",
              capacity: int | None = None, max_cap: int | None = None,
              chunk_size: int | None = None, seed: int = 0, device=None,
              planner: "_plan.KernelPlanner | None" = None, pctx=None,
              store: str | None = None, page_size: int | None = None,
              store_bytes: int | None = None, codec: str | None = None,
              rescore_mult: "int | str" = 4,
              rescore_bytes: int | None = None, rescore: str | None = None,
              router=None) -> "IVFIndex":
        """Train coarse centroids on ``x`` (N, d) and invert the corpus
        into posting lists. The initial centroids come from a
        ``torch.Generator`` seeded with ``seed``.

        With ``chunk_size`` set, ``x`` is a host numpy array, CPU tensor or
        chunk factory handled out of core: ``ChunkedKMeans`` trains from
        centroids drawn on the first chunk, then the same chunk stream is
        inverted by ``add`` into an index of capacity 8 (or ``capacity``)
        that grows as the lists fill; the device holds two chunks, the
        centroids and the store.

        ``pctx``: train and serve on a mesh (ref. l.698-710). The points
        are split over the data axes (one O(K d) all-reduce a Lloyd
        iteration, the ``tol`` rule of one device), the cells and their
        posting lists over the cells axis, and the build's assignment is
        the two-stage argmin the sharded add uses; a ragged N is padded
        and masked. With ``chunk_size`` the training stays the one-device
        ``ChunkedKMeans`` loop on every rank and the mesh takes over from
        the inversion on. Every rank passes the same ``x`` and ``seed``."""
        if pctx is not None and device is None:
            device = pctx.device
        dev = resolve_device(device)
        cfg = KMeansConfig(k=k, max_iters=max_iters, init=init, tol=tol,
                           step_impl=step_impl, planner=planner)
        gen = torch.Generator(device=dev).manual_seed(seed)
        kw = dict(max_cap=max_cap, device=dev, planner=planner, store=store,
                  page_size=page_size, store_bytes=store_bytes, codec=codec,
                  rescore_mult=rescore_mult, rescore_bytes=rescore_bytes,
                  rescore=rescore, router=router, pctx=pctx)
        if chunk_size is not None:
            driver = ChunkedKMeans(cfg, chunk_size=chunk_size, device=dev)
            first = _as_float(next(driver._chunks(x)), dev)
            c0 = init_centroids(first, k, init, generator=gen)
            del first
            centroids, _ = driver.fit(x, c0)
            index = cls(centroids, capacity if capacity is not None else 8,
                        **kw)
            for chunk in driver._chunks(x):
                index.add(chunk)
        else:
            x = _as_float(x, dev)
            if pctx is not None:
                centroids, a, m = _train_sharded(pctx, cfg, gen, x)
            else:
                centroids = KMeans(cfg, device=dev).fit(
                    x, generator=gen).centroids
                blk = cfg.blocks_for(x.shape[0], x.shape[1],
                                     x.element_size(), dev)
                a, m = ops.flash_assign(x, centroids.to(x.dtype),
                                        block_n=blk.assign_block_n,
                                        block_k=blk.assign_block_k)
            cap = capacity if capacity is not None else int(
                torch.bincount(a.long(), minlength=k).max())
            index = cls(centroids, cap, **kw)
            index._fold(x, a, m)
        # build-time evidence is the committed baseline, not drift
        index.stats = index.stats.merge(index._pending)
        index._pending = SufficientStats.zero(index.k_owned, index.d, dev)
        return index

    # ------------------------------------------------------------------
    # online mutation
    # ------------------------------------------------------------------

    def add(self, x_new) -> torch.Tensor:
        """Assign, append and account new vectors. Returns their cells.
        An attached injector acts first (ref. l.781-808): ``drop_add``
        loses the batch, ``add_error`` raises, ``latency`` sleeps; its
        ``nan_stats`` events corrupt the pending statistics after the
        fold. Under a ``pctx`` the batch (the same on every rank) is split
        over the data axes, its cells found by the two-stage argmin, and
        the owned statistics arrive summed over the data axes (ref.
        l.811-850)."""
        x_new = torch.as_tensor(x_new).to(device=self.device,
                                          dtype=self.dtype)
        nan_evs: tuple = ()
        if self.faults is not None:   # injection seam (reliability.faults)
            evs = self.faults.poll("add")
            for ev in evs:
                if ev.kind == "drop_add":   # lost message: batch vanishes
                    return torch.zeros((0,), dtype=torch.int32,
                                       device=self.device)
                if ev.kind == "add_error":
                    raise InjectedFault(f"injected add failure ({ev})")
                if ev.kind == "latency":
                    time.sleep(ev.arg)
            nan_evs = tuple(e for e in evs if e.kind == "nan_stats")
        if x_new.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.int32, device=self.device)
        if self.pctx is not None:
            a = self._add_sharded(x_new)
        else:
            blk = self._batch_blocks(x_new.shape[0])
            a, m = ops.flash_assign(x_new, self.centroids.to(x_new.dtype),
                                    block_n=blk.assign_block_n,
                                    block_k=blk.assign_block_k)
            self._fold(x_new, a, m)
        for ev in nan_evs:   # after the fold: refresh must repair
            self._corrupt_pending(int(ev.arg))
        return a

    def _add_sharded(self, x_new: torch.Tensor) -> torch.Tensor:
        """The sharded add: two-stage assign and the owned statistics in one
        program over the data-split batch, then the CSR append of the
        gathered cells (every rank's store writes its own cells)."""
        pctx, cfg = self.pctx, self._shard_cfg()
        x_pad, mask, n = pctx.pad_points(x_new)

        def body(x, ok, c):
            a, m = pctx.two_stage_assign(x, c, cfg)
            s, cnt = pctx.owned_stats(x, a, self.k, cfg, mask=ok)
            return a, s, cnt, pctx.psum(torch.where(ok, m, 0.0).sum())

        a, s, cnt, j = pctx.spmd(
            body, in_specs=(pctx.data_spec, pctx.points_spec, None),
            out_specs=(pctx.points_spec, None, None, None))(
                x_pad, mask, self.centroids)
        a = a[:n]
        self._pending = self._pending.merge(SufficientStats(s, cnt, j))
        self._append(x_new, a)
        return a

    def _batch_blocks(self, n: int):
        """Assign/update tiles for an ``n``-row batch (planner-cached)."""
        return self.planner.block_config(n, self.k, self.d,
                                         self.dtype.itemsize)

    def _fold(self, x: torch.Tensor, a: torch.Tensor, m: torch.Tensor
              ) -> None:
        """Append a pre-assigned batch and account its statistics; a
        k-sharded index keeps the owned cells' rows of them (ref. ``_fold``
        and ``_place``: every rank reduces the whole batch)."""
        blk = self._batch_blocks(x.shape[0])
        s, cnt = ops.centroid_stats(x, a, k=self.k,
                                    block_n=blk.update_block_n,
                                    block_k=blk.update_block_k)
        if self._k_sharded:
            s = self.pctx.shard_centroids(s)
            cnt = self.pctx.put(cnt, (self.pctx.k_axis,))
        self._pending = self._pending.merge(SufficientStats(s, cnt, m.sum()))
        self._append(x, a)

    def refresh(self, decay: float = 1.0, *, guard: bool = False,
                repair_dead: bool = False) -> "IVFIndex":
        """Commit pending evidence and re-center the coarse centroids: one
        O(K d) merge + M-step, no pass over any stored vector. ``decay <
        1`` down-weights old evidence. ``guard`` sanitizes both evidence
        terms before the merge (a cluster with non-finite stats keeps its
        centroid); ``repair_dead`` re-seeds cells with no vectors and no
        evidence by splitting the heaviest cell. An attached injector's
        ``nan_stats`` and ``latency`` act first (ref. l.887-893). Under
        K-sharding each rank commits its owned cells' statistics; the
        guard's count is summed over the cells axis and the dead cells'
        repair runs on the gathered K cells, so both counters are the
        same on every rank."""
        if self.faults is not None:   # injection seam (reliability.faults)
            for ev in self.faults.poll("refresh"):
                if ev.kind == "nan_stats":
                    self._corrupt_pending(int(ev.arg))
                elif ev.kind == "latency":
                    time.sleep(ev.arg)
        pending, base = self._pending, self.stats.scale(decay)
        if guard:
            pending, bad_p = pending.sanitize()
            base, bad_b = base.sanitize()
            bad = bad_p.sum() + bad_b.sum()
            if self._k_sharded:   # each rank sanitized its owned cells
                bad = self.pctx.psum(bad, (self.pctx.k_axis,))
            self.repaired_cells += int(bad)
        self.stats = base.merge(pending)
        self._pending = SufficientStats.zero(self.k_owned, self.d,
                                             self.device)
        self.centroids = self.stats.finalize(self.centroids)
        if repair_dead:
            self.reseeded_cells += self._repair_dead_cells()
        self._cnorms = self._view = None   # centroids moved: both stale
        # the router's groups follow the moved centroids (ref. l.905-909);
        # a sharded index gathers them first (every rank refreshes)
        if self.router.kind != "flat":
            self.router.refresh(self.global_centroids())
        return self

    def _repair_dead_cells(self, eps: float = 1e-3) -> int:
        """Re-seed cells with no stored vectors and no evidence: each takes
        a perturbed copy of the heaviest cell's centroid and half its
        evidence. Host-side, at refresh cadence. A K-sharded index gathers
        the K centroids and statistics (a collective, O(K d)), repairs them
        as one device does on every rank, and keeps its owned slice."""
        cnt_t, sums_t, c_t = self.stats.counts, self.stats.sums, \
            self.centroids
        if self._k_sharded:
            ka = (self.pctx.k_axis,)
            cnt_t, sums_t, c_t = (self.pctx.gather(t, ka)
                                  for t in (cnt_t, sums_t, c_t))
        cnt = cnt_t.cpu().numpy().copy()
        stored = self.counts.cpu().numpy()
        dead = np.where((cnt <= 0.0) & (stored == 0))[0]
        if dead.size == 0:
            return 0
        c = c_t.cpu().numpy().copy()
        sums = sums_t.cpu().numpy().copy()
        n = 0
        for cell in dead:
            donor = int(np.argmax(cnt))
            if cnt[donor] <= 1.0:   # nothing heavy enough to split
                break
            c[cell] = c[donor] * (1.0 + eps) + eps
            cnt[donor] *= 0.5
            sums[donor] *= 0.5
            cnt[cell] = cnt[donor]
            sums[cell] = c[cell] * cnt[cell]
            n += 1
        if n:
            own = slice(None)
            if self._k_sharded:
                lo = self.pctx.k_rank * self.k_owned
                own = slice(lo, lo + self.k_owned)
            dev = self.device
            self.centroids = torch.as_tensor(c[own], device=dev)
            self.stats = SufficientStats(
                torch.as_tensor(sums[own], device=dev),
                torch.as_tensor(cnt[own], device=dev), self.stats.inertia)
        return n

    def _append(self, x: torch.Tensor, a: torch.Tensor) -> None:
        """Append a batch in CSR order; ids stay monotone (spilled rows
        consume ids too)."""
        n = x.shape[0]
        if n == 0:
            return
        order, _ = csr_from_assignments(a, self.k)
        o = order.long()
        a_sorted = a[o].cpu().numpy()
        ids_new = (self.n_total + order.cpu().numpy()).astype(np.int32)
        self.store.append(a_sorted, x[o], ids_new)
        self.n_total += n

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _gather_width(self, topk: int, nprobe: int) -> int:
        """The store's occupied per-cell candidate width for a geometry
        (>= ceil(topk / nprobe), so the scan's top-k always fits)."""
        return self.store.gather_width(-(-int(topk) // max(1, int(nprobe))))

    def _centroid_norms(self) -> torch.Tensor:
        """Cached ``||c||^2`` (K,) f32 of the centroids in the store's
        dtype, fed to every FlashProbe; ``refresh`` invalidates it."""
        if self._cnorms is None:
            c32 = self.centroids.to(self.dtype).float()
            self._cnorms = (c32 * c32).sum(-1)
        return self._cnorms

    def _rescore_cache(self):
        """The store's ``DeviceRescoreCache``, or None (fp32 payloads, or
        the host-reservoir path)."""
        return getattr(self.store, "cache", None)

    def _route_view(self):
        """The router's view of this index's centroids (the flat router's
        ``(centroids, ||c||^2)``, the two-level router's fine table), kept
        until ``refresh`` moves the centroids or the router re-groups
        them."""
        version = self.router.version
        if self._view is None or self._view[0] != version:
            c = self.centroids.to(self.dtype)
            if self._k_sharded and self.router.kind != "flat":
                # this rank's fine centroids, padding rows for the others'
                # (ref. ``_route_cells_sharded``: non-owned slots read the
                # padding row)
                lo = self.pctx.k_rank * self.k_owned
                full = c.new_full((self.k, self.d), _PAD_COORD)
                full[lo:lo + self.k_owned] = c
                c = full
            self._view = (version, self.router.view(
                c, self._centroid_norms()))
        return self._view[1]

    def search_geometry(self, topk: int = 10, nprobe: int = 8,
                        nprobe_c: int | None = None) -> tuple:
        """Changes exactly when the planned search would re-key (ref.
        l.1002-1018): the store's occupancy crossed a ``gather_width``
        bucket, a re-grouping of the two-level router crossed a ``gcap``
        bucket or moved the effective coarse width, or the device rescore
        cache grew its table."""
        nprobe = min(nprobe, self.k)
        cache = self._rescore_cache()
        cfp = cache.fingerprint() if cache is not None else ()
        shards = (self.pctx.n_k_shards,) if self._k_sharded else ()
        return ((nprobe, topk, self._gather_width(topk, nprobe)) + shards
                + self.router.fingerprint(nprobe, nprobe_c) + cfp)

    def _rescore_r(self, topk: int, nprobe: int, width: int) -> int:
        """Phase-1 proposal depth: ``rescore_mult * topk`` (or the
        codec-aware chooser's multiplier with ``"auto"``, which with a
        device cache also sees its hit rate, capacity over live rows; ref.
        l.1020-1039), clamped to the probed candidate pool."""
        mult = self.rescore_mult
        if mult is None:
            cache = self._rescore_cache()
            hit_rate = None
            if cache is not None:
                hit_rate = min(1.0, cache.capacity / max(1, self.n_total))
            mult = _heur.choose_rescore_mult(topk, self.d, nprobe * width,
                                             hit_rate=hit_rate)
        return min(max(topk, mult * topk), nprobe * width)

    def plan_search(self, b: int, topk: int = 10, nprobe: int = 8,
                    nprobe_c: int | None = None) -> tuple:
        """Plan (and cache) the search kernels for a ``(b, d)`` batch.

        Returns the planner's ``KernelPlan`` of each kernel: ``(probe,
        store scan)`` on an fp32 store and ``(probe, q8 store scan,
        rescore scan)`` on a q8 store, the rescore planned as ``"rescore"``
        with a device cache and as ``"scan"`` on the host path (ref.
        l.1119-1123; the same kernel either way). Under the two-level
        router the probe gives way to two plans, the coarse ``probe`` at
        ``(b, K_c, d, nprobe_c)`` and the fine ``scan_store`` at ``(b,
        nprobe_c, gcap, d, leff)`` (ref. l.1093-1103). Cached per ``(b,
        nprobe, topk, width)`` plus the router's fingerprint and the
        cache's; ``width`` is the store's gather-width bucket, so occupancy
        growth re-keys, as does a ``gcap`` bucket.

        Under a k-sharded ``pctx`` every kernel is planned at the shapes a
        rank launches (ref. l.1074-1081) for its slice ``bl`` of the batch:
        the probe over the ``K / P_k`` owned centroids at ``L = ll = min(nprobe,
        K / P_k)`` (or the router's two plans at ``bl``), the store scan over
        ``ll`` owned cells, on q8 at ``min(R, ll * width)`` proposals, and
        the rescore of the ``R`` merged proposals.
        """
        nprobe = min(nprobe, self.k)
        width = self._gather_width(topk, nprobe)
        if not self._k_sharded:
            return self._plan_one_device(b, topk, nprobe, nprobe_c, width)
        kl = self.pctx.k_local(self.k)
        ll = min(nprobe, kl)                 # owned cells a query probes
        bl = max(1, -(-int(b) // self.pctx.n_data_shards))
        cache = self._rescore_cache()
        cfp = cache.fingerprint() if cache is not None else ()
        geom = ((int(b), nprobe, int(topk), width, self.pctx.n_k_shards)
                + self.router.fingerprint(nprobe, nprobe_c) + cfp)
        plans = self._search_plans.get(geom)
        if plans is None:
            dt = self.dtype
            if self.router.kind == "flat":
                head = (self.planner.plan("probe", (bl, kl, self.d, ll), dt),)
            else:
                head = self.router.probe_plans(self.planner, bl, self.k,
                                               self.d, nprobe, nprobe_c, dt)
            if self.store.codec_kind != "fp32":
                r = self._rescore_r(topk, nprobe, width)
                q8 = self.planner.plan(
                    "scan_q8_store", (bl, ll, width, self.d,
                                      min(r, ll * width)), torch.int8)
                rescore = self.planner.plan(
                    "scan" if cache is None else "rescore",
                    (bl, r, self.d, min(topk, r)), torch.float32)
                plans = (*head, q8, rescore)
            else:
                plans = (*head, self.planner.plan(
                    "scan_store", (bl, ll, width, self.d,
                                   min(topk, ll * width)), dt))
            self._search_plans[geom] = plans
        return plans

    def _plan_one_device(self, b: int, topk: int, nprobe: int,
                         nprobe_c: int | None, width: int) -> tuple:
        rfp = self.router.fingerprint(nprobe, nprobe_c)
        cache = self._rescore_cache()
        cfp = cache.fingerprint() if cache is not None else ()
        geom = (int(b), nprobe, int(topk), width) + rfp + cfp
        plans = self._search_plans.get(geom)
        if plans is None:
            dt = self.dtype
            head = self.router.probe_plans(self.planner, b, self.k, self.d,
                                           nprobe, nprobe_c, dt)
            if self.store.codec_kind != "fp32":
                r = self._rescore_r(topk, nprobe, width)
                q8 = self.planner.plan(
                    "scan_q8_store", (b, nprobe, width, self.d, r),
                    torch.int8)
                rescore = self.planner.plan(
                    "scan" if cache is None else "rescore",
                    (int(b), r, self.d, min(topk, r)), torch.float32)
                plans = (*head, q8, rescore)
            else:
                scan = self.planner.plan(
                    "scan_store", (b, nprobe, width, self.d, topk), dt)
                plans = (*head, scan)
            self._search_plans[geom] = plans
        return plans

    def search(self, q, topk: int = 10, nprobe: int = 8, *,
               nprobe_c: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched top-k search. q: (B, d) -> (ids (B, topk) int32,
        sq_dists f32 (B, topk)), ascending; ids of unfilled slots are -1.
        ``nprobe = k`` probes every cell: the result is the brute-force
        top-k over all indexed vectors, on the two-level router too (its
        coarse width grows with ``nprobe`` to every group). ``nprobe_c``
        sets the two-level router's coarse width; the flat router ignores
        it. An attached injector acts after the pool check (ref.
        l.1151-1166): ``latency`` sleeps, ``search_error`` raises, and
        ``dead_shard`` blanks its K-shard (``arg % P_k``) out of this
        call's merges on a K-sharded index; on one device, or a data-only
        mesh, where it is the whole replica, it raises. Under a k-sharded
        ``pctx`` see ``_search_sharded``."""
        q = torch.as_tensor(q).to(device=self.device, dtype=self.dtype)
        nprobe = min(nprobe, self.k)
        cand = nprobe * self.cap
        if topk > cand:
            raise ValueError(
                f"topk={topk} exceeds the probed candidate pool "
                f"nprobe*cap={cand}; raise nprobe or capacity")
        shard_ok = None
        if self.faults is not None:   # injection seam (reliability.faults)
            for ev in self.faults.poll("search"):
                if ev.kind == "latency":
                    time.sleep(ev.arg)
                elif ev.kind == "search_error":
                    raise InjectedFault(f"injected search failure ({ev})")
                elif ev.kind == "dead_shard":
                    if not self._k_sharded:   # one replica: hard fail
                        raise InjectedFault(f"injected replica death ({ev})")
                    nk = self.pctx.n_k_shards
                    shard_ok = np.ones(nk, bool)
                    shard_ok[int(ev.arg) % nk] = False
        if self._k_sharded:
            return self._search_sharded(q, topk, nprobe, nprobe_c, shard_ok)
        if self.store.codec_kind != "fp32":
            return self._search_q8(q, topk, nprobe, nprobe_c)
        width = self._gather_width(topk, nprobe)
        *head, sp = self.plan_search(q.shape[0], topk, nprobe, nprobe_c)
        probe = self._probe(q, nprobe, nprobe_c, head)
        return _scan_cells(q, probe, self.store.scan_view(), topk=topk,
                           width=width, plan=sp)

    def _search_sharded(self, q: torch.Tensor, topk: int, nprobe: int,
                        nprobe_c: int | None = None, shard_ok=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """The sharded search (ref. l.1221-1258, l.1317-1576). Each rank
        takes its slice of the batch (split over the data axes; a ragged
        batch is padded and the result cut back):

        1. the global ``(bl, nprobe)`` probe list (``_sharded_cells``);
        2. the owned probed cells, compacted in global probe order into
           ``(bl, ll)`` (a slot this rank does not own points at the
           shard's sentinel cell ``K / P_k``, which the scans read as
           empty), scanned in place by the store scan;
        3. fp32: the cross-rank top-k merge, ties broken by each candidate's
           global probe-rank-major position (``order[p] * width + w``),
           which is where the one-device scan sees it; ``||q||^2`` is added
           once after the merge, clamped at 0, non-finite values to 0.
           q8 (``_q8_sharded``): the proposals' merge to ``R`` with the same
           tie, the row exchange, and the rescore of the rank's slice.

        ``shard_ok`` ((P_k,) bool, None: all alive): a dead K-shard's lists
        are blanked in every merge (``merge_topl(valid=)``), so it adds no
        cell and no candidate.

        Two (value, id) lists cross ranks (``search_collective_bytes``), and
        on q8 the ``(bl, R, d)`` exchanged rows (``row_exchange_bytes``)."""
        pctx = self.pctx
        b = q.shape[0]
        pd = pctx.n_data_shards
        b_pad = -(-b // pd) * pd
        if b_pad != b:
            q = torch.cat([q, q.new_zeros((b_pad - b, self.d))])
        kl = pctx.k_local(self.k)
        ll = min(nprobe, kl)
        width = self._gather_width(topk, nprobe)
        q8 = self.store.codec_kind != "fp32"
        *head, sp = self.plan_search(b_pad, topk, nprobe, nprobe_c)
        if q8:
            head, sp = head[:-1], (head[-1], sp)
        view = self.store.scan_view()
        lo = pctx.k_rank * kl
        # False where this rank's K-shard is dead, else None: the healthy
        # search adds no work for the mask (eager code needs none)
        alive = None if shard_ok is None or shard_ok[pctx.k_rank] else False

        def body(ql):
            bl = ql.shape[0]
            gcell = self._sharded_cells(ql, nprobe, nprobe_c, head, alive)
            rel = gcell.long() - lo
            owned = (rel >= 0) & (rel < kl)
            pos = torch.arange(nprobe, device=ql.device).expand(bl, nprobe)
            order = torch.sort(torch.where(owned, pos, nprobe), dim=1,
                               stable=True).indices[:, :ll]
            cell = torch.where(torch.gather(owned, 1, order),
                               torch.gather(rel, 1, order), kl)
            cell = cell.to(torch.int32)
            if q8:
                return self._q8_sharded(ql, cell, order, view, topk=topk,
                                        nprobe=nprobe, width=width, plans=sp,
                                        alive=alive)
            lidx, lval = ops.flash_probe_store(
                ql, view.rows, view.counts, cell, table=view.table,
                width=width, l=min(topk, ll * width), pad=_PAD_COORD,
                plan=sp, want_dists=False)
            ids_loc = view.ids_at(*_slots(cell, lidx, width))
            lidx = lidx.long()
            gpos = torch.gather(order, 1, lidx // width) * width \
                + lidx % width
            gids, gval = pctx.merge_topl(ids_loc, lval, topk, tie=gpos,
                                         valid=alive)
            q32 = ql.float()
            gval = gval + (q32 * q32).sum(-1, keepdim=True)
            gval = torch.where(torch.isfinite(gval), gval.clamp(min=0.0),
                               0.0)
            return gids, gval

        ids, dists = pctx.spmd(
            body, in_specs=(pctx.data_spec,),
            out_specs=(pctx.data_spec, pctx.data_spec))(q)
        return ids[:b], dists[:b]

    def _sharded_cells(self, ql: torch.Tensor, nprobe: int,
                       nprobe_c: int | None, head, alive) -> torch.Tensor:
        """Each query's global ``(bl, nprobe)`` cells on a k-sharded index,
        the same list on every rank of the cells axis. Flat: FlashProbe over
        the owned centroids at ``L = min(nprobe, K / P_k)``, then the
        cross-rank top-``nprobe`` merge. Two-level (ref.
        ``_route_cells_sharded``, l.246-281): the coarse probe over the
        replicated coarse centroids gives every rank the same groups with no
        traffic; the store scan over this rank's fine table (``_route_view``:
        its own fine centroids, padding rows for the others', read in place)
        keeps ``leff`` candidates; a candidate this rank does not own is the
        sentinel ``K``; the merge breaks ties by the candidate-axis position
        ``p gcap + w``, where the one-device scan sees it, so the merged list
        is the one-device routed list entry for entry. A dead K-shard
        (``alive`` false) adds no entry to the merge."""
        pctx = self.pctx
        kl = pctx.k_local(self.k)
        lo = pctx.k_rank * kl
        if self.router.kind == "flat":
            idx, val = ops.flash_probe(
                ql, self.centroids.to(ql.dtype), l=min(nprobe, kl),
                plan=head[0], want_dists=False, c_sq=self._centroid_norms())
            gcell, _ = pctx.merge_topl(idx + lo, val, nprobe, valid=alive)
            return gcell
        member, fli, flv = self.router.candidates(
            ql, self._route_view(), nprobe=nprobe, nprobe_c=nprobe_c,
            plans=head)
        owned = (member >= lo) & (member < lo + kl)
        fcell = torch.where(owned, member, self.k)
        gcell, _ = pctx.merge_topl(fcell, flv, nprobe, tie=fli, valid=alive)
        return gcell

    def _q8_sharded(self, ql, cell, order, view, *, topk: int, nprobe: int,
                    width: int, plans, alive
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """A rank's q8 search past the cell selection (ref.
        ``_make_sharded_q8_candidates``, l.1317-1443, and l.1221-1258): the
        q8 store scan proposes this rank's top ``min(R, ll * width)`` of its
        owned probed cells (the sentinel cell's slots are zero-scale rows of
        a zero anchor: ``+inf``, id -1); the proposals merge to ``R`` with
        the global probe-rank-major tie; each rank dequantizes its own
        proposals, swaps in the cache's rows where it holds them (its slice
        holds exactly the ids its cells own), and one all-reduce over the
        cells axis sums the rows by id match (every live id has one owner);
        then the rescore of the ``R`` rows at full precision, with the host
        reservoir's rows where there is no device cache (the oracle). A
        dead K-shard (``alive`` false) blanks its proposals before the
        merge, so none of its rows enters the exchange."""
        pctx, st = self.pctx, self.store
        qp, rp = plans
        r = self._rescore_r(topk, nprobe, width)
        rl = min(r, cell.shape[1] * width)
        lidx, lval = ops.flash_probe_store_q8(
            ql, view.rows, view.scales, view.counts, cell, view.anchors,
            table=view.table, width=width, l=rl, plan=qp)
        ids_loc, deq = view.q8_at(*_slots(cell, lidx, width))
        ids_loc = torch.where(torch.isfinite(lval), ids_loc, -1)
        if alive is False:   # a dead shard proposes nothing
            ids_loc = torch.full_like(ids_loc, -1)
        lidx = lidx.long()
        gpos = torch.gather(order, 1, lidx // width) * width + lidx % width
        gids, _ = pctx.merge_topl(ids_loc, lval, r, tie=gpos, valid=alive)
        cache = self._rescore_cache()
        if cache is not None:
            crows, cfound = cache_lookup(*st.cache_arrays(), ids_loc)
            deq = torch.where(cfound.unsqueeze(-1), crows, deq)
        rows = self._exchange_rows(gids, ids_loc, deq)
        if cache is not None:
            none = torch.zeros(gids.shape, dtype=torch.bool,
                               device=gids.device)
            return _rescore_body(ql, rows, gids, rows, none, topk=topk,
                                 plan=rp)
        res_rows, found = self._host_rows(gids)
        return _rescore_body(ql, rows, gids, res_rows, found, topk=topk,
                             plan=rp)

    def _exchange_rows(self, gids, ids_loc, rows_loc) -> torch.Tensor:
        """The q8 row exchange: ``(bl, R, d)`` rows of the merged proposals
        ``gids``. Each rank puts the row of each proposal it made (``rows_loc``
        at the matching ``ids_loc`` entry) and zeros elsewhere; the sum over
        the cells axis then holds each live id's row from its one owner
        (``x + 0`` is ``x``: the rows cross unchanged); dead ids read
        padding rows."""
        match = (gids.unsqueeze(-1) == ids_loc.unsqueeze(1)) \
            & (ids_loc >= 0).unsqueeze(1)
        at = match.to(torch.uint8).argmax(-1, keepdim=True)
        mine = torch.gather(rows_loc, 1, at.expand(*at.shape[:2],
                                                   rows_loc.shape[-1]))
        mine = torch.where(match.any(-1, keepdim=True), mine, 0.0)
        rows = self.pctx.psum(mine, (self.pctx.k_axis,))
        return torch.where((gids >= 0).unsqueeze(-1), rows, _PAD_COORD)

    def _host_rows(self, ids: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """The host reservoir's rows of ``ids`` and which it holds (none
        without a reservoir): the ``rescore="host"`` path's read."""
        ids_np = ids.cpu().numpy()
        res = self.store.reservoir
        if res is not None:
            rows, found = res.lookup(ids_np)
        else:
            rows = np.zeros(ids_np.shape + (self.d,), np.float32)
            found = np.zeros(ids_np.shape, bool)
        return (torch.as_tensor(rows, device=self.device),
                torch.as_tensor(found, device=self.device))

    def _probe(self, q: torch.Tensor, nprobe: int, nprobe_c: int | None,
               head) -> torch.Tensor:
        """The router's ``(B, nprobe)`` int32 cells in ``[0, K]``, where
        ``K`` is the sentinel cell (a two-level router's, where a query
        has fewer candidates). ``head``: ``plan_search``'s probe plans."""
        return self.router.cells(q, self._route_view(), nprobe=nprobe,
                                 nprobe_c=nprobe_c, plans=head)

    def _search_q8(self, q: torch.Tensor, topk: int, nprobe: int,
                   nprobe_c: int | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Two-phase search on a quantized store: propose the top-``R``
        from the int8 payload, then rescore those ``R`` rows at full
        precision. With a device cache the rows come from ``cache_lookup``
        on the card and nothing is read on the host (ref.
        ``_ivf_search_q8_device``, l.399-423, and l.1287-1297); otherwise
        the ids go to the host reservoir and its rows come back (the
        reference's ``rescore="host"`` path). Both feed ``_rescore_body``
        the same ``(deq, ids, rows, found)``. At full ``nprobe`` with
        ``R`` covering the live candidates this reproduces brute force
        exactly."""
        st = self.store
        width = self._gather_width(topk, nprobe)
        r = self._rescore_r(topk, nprobe, width)
        *head, qp, rp = self.plan_search(q.shape[0], topk, nprobe, nprobe_c)
        probe = self._probe(q, nprobe, nprobe_c, head)
        ids, deq = _q8_scan(q, probe, st.scan_view(), r=r, width=width,
                            plan=qp)
        if self._rescore_cache() is not None:
            rows, found = cache_lookup(*st.cache_arrays(), ids)
        else:
            rows, found = self._host_rows(ids)
        return _rescore_body(q, deq, ids, rows, found, topk=topk, plan=rp)

    def search_brute(self, q, topk: int = 10
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Dense brute-force reference over every indexed vector (the
        exactness/recall oracle). The rows are scored ``BRUTE_CHUNK_ELEMS /
        B`` at a time, each chunk's top-k kept and the chunks' lists merged
        ties to the lower row (``ref.probe_ref``'s order), so a score matrix
        never exceeds that many entries. On a sharded index every rank
        gathers the whole store (a collective). Padding slots (id -1) are
        scored as ``_PAD_COORD`` rows whatever the pool holds there (a
        bfloat16 pool pads with 0, ``store._pad_value``)."""
        q = torch.as_tensor(q).to(device=self.device, dtype=self.dtype)
        flat_x, flat_ids = self.store.flat()
        flat_x = torch.where((flat_ids < 0).unsqueeze(-1),
                             torch.full_like(flat_x, _PAD_COORD), flat_x)
        rows = max(topk, BRUTE_CHUNK_ELEMS // max(1, q.shape[0]))
        parts_i, parts_v = [], []
        for lo in range(0, flat_x.shape[0], rows):
            idx, v = ref.probe_ref(q, flat_x[lo:lo + rows], topk,
                                   want_dists=False)
            parts_i.append(idx.long() + lo)
            parts_v.append(v)
        # chunk-major concatenation: a stable sort keeps equal scores in
        # row order
        v_all, i_all = torch.cat(parts_v, 1), torch.cat(parts_i, 1)
        pos = torch.sort(v_all, dim=1, stable=True).indices[:, :topk]
        idx, v = torch.gather(i_all, 1, pos), torch.gather(v_all, 1, pos)
        q32 = q.float()
        dists = torch.clamp(v + (q32 * q32).sum(-1, keepdim=True), min=0.0)
        return flat_ids[idx], dists

    # ------------------------------------------------------------------
    # durability (reliability.snapshot)
    # ------------------------------------------------------------------

    def save(self, directory: str, *, seqno: int = 0,
             extra: dict | None = None) -> str:
        """Atomic snapshot of the whole index state (store payload, counts,
        committed and pending statistics, router) in the reference's format
        (``reliability.snapshot.save_index``). ``seqno`` marks the WAL
        position it covers. On a mesh every rank calls it (the state is
        gathered) and rank 0 writes."""
        from repro_torch.reliability.snapshot import save_index
        return save_index(self, directory, seqno=seqno, extra=extra)

    @classmethod
    def load(cls, directory: str, *, seqno: int | None = None,
             planner: "_plan.KernelPlanner | None" = None, device=None,
             pctx=None) -> "IVFIndex":
        """Restore a snapshot written by either package, on any mesh or on
        none, onto ``device`` (None: ``"cuda"``) or onto the mesh of
        ``pctx``; see ``reliability.snapshot.load_index``."""
        from repro_torch.reliability.snapshot import load_index
        return load_index(directory, seqno=seqno, planner=planner,
                          device=device, pctx=pctx)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def posting_lists(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The CSR view ``(ids, offsets)``: list ``j`` is
        ``ids[offsets[j]:offsets[j+1]]`` (insertion order preserved)."""
        dense_ids = self.store.dense_ids()
        slot = torch.arange(dense_ids.shape[1], device=dense_ids.device)
        ids = dense_ids[slot.unsqueeze(0) < self.counts.unsqueeze(1)]
        offsets = torch.cat([torch.zeros((1,), dtype=torch.int64,
                                         device=self.device),
                             torch.cumsum(self.counts.long(), 0)])
        return ids, offsets.to(torch.int32)

    def search_collective_bytes(self, b: int, topk: int = 10,
                                nprobe: int = 8) -> int:
        """Modeled cross-rank wire bytes of one search batch (0 unless the
        index is k-sharded); see
        ``ParallelContext.search_collective_bytes``."""
        if not self._k_sharded:
            return 0
        return self.pctx.search_collective_bytes(
            b, min(nprobe, self.k), topk, self.k, cap=self.cap, d=self.d)

    def row_exchange_bytes(self, b: int, topk: int = 10,
                           nprobe: int = 8) -> int:
        """Bytes of the q8 row exchange a rank all-reduces for a batch of
        ``b`` (its slice's ``(bl, R, d)`` f32 rows; 0 unless the index is
        k-sharded and quantized). ``search_collective_bytes`` keeps the
        reference's model, which leaves it out."""
        if not self._k_sharded or self.store.codec_kind == "fp32":
            return 0
        nprobe = min(nprobe, self.k)
        r = self._rescore_r(topk, nprobe, self._gather_width(topk, nprobe))
        return 4 * -(-int(b) // self.pctx.n_data_shards) * r * self.d

    def __len__(self) -> int:
        return self.n_total

    def __repr__(self) -> str:
        shard = (f", cells_sharded x{self.pctx.n_k_shards}"
                 if self._k_sharded else "")
        codec = (f", codec={self.store.codec_kind}"
                 if self.store.codec_kind != "fp32" else "")
        rout = (f", router={self.router.kind}"
                if self.router.kind != "flat" else "")
        return (f"IVFIndex(k={self.k}, d={self.d}, n={self.n_total}, "
                f"cap={self.cap}, store={self.store.kind}{codec}{rout}"
                f"{shard}, device={self.device})")
