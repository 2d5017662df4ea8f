"""Batched vector-search serving over the port's FlashIVF index.

Port of ``SearchConfig`` and ``SearchEngine`` from ``repro/serve/engine.py``
(l.169-714) for one device: continuous batching of ragged query traffic
with inserts interleaved in FIFO order, and overlapped dispatch.

- **Admission.** ``submit`` (a search of any row count) and ``submit_add``
  (an insert) join one FIFO queue bounded by ``queue_max``
  (backpressure); ``pump`` drains it, ``take`` returns one request's
  result.
- **Units.** Consecutive searches coalesce into one unit of up to
  ``query_batch`` rows; a request larger than the unit's room is split and
  its tail keeps its place at the head of the line. A unit is padded with
  zero rows to its power-of-two shape bucket (floor 8, as
  ``KernelPlanner.bucket_dim``), whose plans are pinned at construction
  and re-pinned only when the index's ``search_geometry`` moves.
- **Inserts.** An add runs between units; every ``refresh_every``-th add
  refreshes the index (``refresh_decay``): statistics merge and M-step,
  never a refit.
- **The pipeline.** Up to ``pipeline_depth`` units stay in flight without
  a sync. Each unit records a ``torch.cuda.Event`` on the current stream
  after its dispatch; completion (``take``, or the depth overflowing)
  waits on that event. All work runs on the one current stream: an add
  writes the store's tensors in place, and stream order keeps a unit's
  reads ahead of a later add's writes. On the CPU the event is None and
  completion is immediate.
- **Timing.** ``latency_stats`` gives the reference's keys: ``dispatch``
  is the host's enqueue of a unit, ``complete`` host time from enqueue to
  its event being reached; first-seen shape buckets are not sampled.
- **Reliability** (``repro_torch.reliability``, ref. l.235-714). With a
  ``HealthPolicy`` (``health``), queries and inserts pass ``guard_batch``
  (on the card for a tensor there), every unit walks the degradation
  ladder (retries, halved ``nprobe``, brute force, the last-known-good
  clone, honest ``(-1, 0.0)`` rows) and never raises or returns a
  non-finite distance, an add that fails waits in a bounded queue and is
  retried first at the next add, and ``refresh`` repairs NaN statistics
  and dead cells. A fault of the card's kernels (``KERNEL_FAULTS``: one
  that cannot build or launch) is raised through all of these, never
  answered by a plain version. ``check_finite`` reads each unit's
  distances back, so a unit under a policy waits for its result.
  ``faults`` attaches a ``FaultInjector`` to the index's seams. With
  ``snapshot_dir`` every add is written to the WAL before it is applied
  (``wal_log_every``), ``snapshot_every`` adds snapshot the index, and
  ``recover`` loads the latest snapshot and replays the WAL's tail through
  ``add``, which gives the index an uninterrupted run holds, its schedule
  counters resumed from the manifest.

Not ported yet (ROADMAP.md, queue A): ``recover(pctx=)`` (item 6) and the
clustered-KV ``Engine`` (item 8).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.kernels._build import KernelUnavailable
from repro_torch.reliability.health import (HealthCounters, HealthPolicy,
                                            NonFiniteResult)
from repro_torch.reliability.validate import guard_batch
from repro_torch.reliability.wal import AddLog

# Faults of the card's kernels, never absorbed by the ladder or the queue of
# pending adds: a kernel that cannot build or launch, and a CUDA error that
# torch surfaces after a launch. The reliability layer answers injected and
# transient faults; it does not answer with the plain version instead.
KERNEL_FAULTS = (KernelUnavailable,) + (
    (torch.AcceleratorError,) if hasattr(torch, "AcceleratorError") else ())


@dataclasses.dataclass
class SearchConfig:
    topk: int = 10
    nprobe: int = 8
    nprobe_c: int | None = None   # two-level router's coarse width
    query_batch: int = 256        # largest unit, and the top shape bucket
    pipeline_depth: int = 2       # most un-synced units in flight (1 = sync)
    refresh_every: int = 8        # adds between automatic refreshes
    refresh_decay: float = 1.0
    queue_max: int = 4096         # admission-queue bound (backpressure)
    # durability (None/0 = off)
    snapshot_dir: str | None = None   # index snapshots + WAL live here
    snapshot_every: int = 0           # adds between automatic snapshots
    wal_log_every: int = 1            # RPO knob (see reliability.wal)


class SearchEngine:
    """Continuous-batching query -> top-k serving over an ``IVFIndex``
    (module docstring). ``search``/``add`` are the synchronous wrappers:
    submit, then take."""

    def __init__(self, index, scfg: SearchConfig | None = None, *,
                 health: HealthPolicy | None = None, faults=None):
        self.index = index
        self.scfg = scfg or SearchConfig()
        self.health = health
        self.counters = HealthCounters()
        if faults is not None:   # attach the injector at the index seams
            index.faults = faults
        self.queries_served = 0
        self.adds_since_refresh = 0
        self.refresh_count = 0
        # durability: the WAL and snapshots when a snapshot_dir is set
        self.wal = AddLog(self.scfg.snapshot_dir,
                          log_every=self.scfg.wal_log_every) \
            if self.scfg.snapshot_dir else None
        self._seqno = 0            # the last insert batch's seqno
        self._adds_since_snap = 0
        self._replaying = False    # WAL replay re-enters add(): no re-log
        # the bounded queue of adds that failed, and the last-known-good
        # clone (rung 4 of the ladder)
        self._pending_adds: collections.deque = collections.deque()
        self._lkg = None
        self._mark_healthy()
        self._queue: collections.deque = collections.deque()
        self._results: dict[int, object] = {}
        self._partials: dict[int, tuple[list, list]] = {}
        self._next_rid = 0
        self.batches_formed = 0       # search units executed
        self.coalesced_requests = 0   # requests that shared a unit
        self.interleaved_adds = 0     # adds applied between units
        # units dispatched while an earlier one was still un-synced
        self.overlap_hits = 0
        # (request ids, (ids, dists), enqueue time, warm, event)
        self._inflight: collections.deque = collections.deque()
        self._dispatch_ms: list[float] = []
        self._complete_ms: list[float] = []
        self._seen_buckets: set[int] = set()
        qb = self.scfg.query_batch
        buckets, bsz = [], 8
        while bsz < qb:
            buckets.append(bsz)
            bsz *= 2
        buckets.append(qb)
        self._buckets = buckets
        self._pinned_geom = None
        self._pin_plans()

    # ------------------------------------------------------------------
    # admission, units, interleave
    # ------------------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def _pin_plans(self) -> None:
        """Plan every shape bucket this engine can form (the index caches
        the plans), and remember the geometry they were made for."""
        s = self.scfg
        for bsz in self._buckets:
            self.index.plan_search(bsz, s.topk, s.nprobe, s.nprobe_c)
        self._pinned_geom = self.index.search_geometry(s.topk, s.nprobe,
                                                       s.nprobe_c)

    def _admit(self, kind: str, payload) -> int:
        if len(self._queue) >= self.scfg.queue_max:
            raise RuntimeError(
                f"admission queue full ({self.scfg.queue_max} requests): "
                f"backpressure — pump() or raise queue_max")
        self._next_rid += 1
        self._queue.append((kind, self._next_rid, payload))
        return self._next_rid

    def submit(self, q) -> int:
        """Enqueue a search request (any row count, 0 included); returns
        its request id for ``take``. Rows on the host are copied to the
        index's device here; under a ``HealthPolicy`` they are sanitized
        there (``query_policy``), so the queue holds servable rows only."""
        q = torch.as_tensor(q).to(device=self.index.device)
        if self.health is not None:
            q, rep = guard_batch(q, self.index.d,
                                 policy=self.health.query_policy,
                                 name="query batch")
            self.counters.queries_sanitized += rep.bad_rows
        return self._admit("search", q.to(dtype=self.index.dtype))

    def submit_add(self, x) -> int:
        """Enqueue an insert, applied in FIFO position between search
        units; ``take`` of its id gives the assigned cells."""
        return self._admit("add", x)

    def take(self, rid: int):
        """Pump until request ``rid`` is done and return its result:
        ``(ids, dists)`` for a search, the assigned cells for an add. No
        unit still in flight carries its rows when it returns."""
        while rid not in self._results:
            if not self.pump(1):
                raise KeyError(f"unknown or lost request id {rid}")
        while any(rid in unit[0] for unit in self._inflight):
            self._complete_oldest()
        return self._results.pop(rid)

    def _complete_oldest(self) -> None:
        """Retire the oldest unit in flight: wait for its event and record
        its completion time (warm buckets only)."""
        if not self._inflight:
            return
        _rids, _arrs, t0, warm, event = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        if warm:
            self._complete_ms.append((time.perf_counter() - t0) * 1e3)

    def latency_stats(self) -> dict:
        """Dispatch and completion percentiles (ms, warm buckets only),
        ``overlap_hits`` and the units still in flight."""
        def pct(xs: list[float], p: float) -> float:
            return float(np.percentile(np.asarray(xs), p)) if xs else 0.0
        return {"dispatch_p50_ms": pct(self._dispatch_ms, 50),
                "dispatch_p99_ms": pct(self._dispatch_ms, 99),
                "complete_p50_ms": pct(self._complete_ms, 50),
                "complete_p99_ms": pct(self._complete_ms, 99),
                "overlap_hits": self.overlap_hits,
                "inflight": len(self._inflight)}

    def pump(self, max_units: int | None = None) -> int:
        """Drain the queue: each unit is one coalesced search batch or one
        add. Returns the number of units run (0: the queue was empty)."""
        done = 0
        while self._queue and (max_units is None or done < max_units):
            if self._queue[0][0] == "add":
                _, rid, x = self._queue.popleft()
                self._results[rid] = self.add(x)
                self.interleaved_adds += 1
            else:
                self._run_search_unit()
            done += 1
        return done

    def _run_search_unit(self) -> None:
        """Form one unit from the queue's head, pad it to its bucket,
        dispatch it and hand each request its slice."""
        s = self.scfg
        qb = s.query_batch
        parts: list[tuple[int, torch.Tensor, bool]] = []
        rows = 0
        while self._queue and self._queue[0][0] == "search" and rows < qb:
            kind, rid, q = self._queue.popleft()
            n = q.shape[0]
            if n == 0:   # an empty request gets an empty result at once
                dev = self.index.device
                self._settle(rid, torch.zeros((0, s.topk), dtype=torch.int32,
                                              device=dev),
                             torch.zeros((0, s.topk), dtype=torch.float32,
                                         device=dev), has_tail=False)
                continue
            tk = min(n, qb - rows)
            if n > tk:   # split: the tail keeps its place in line
                self._queue.appendleft((kind, rid, q[tk:]))
            parts.append((rid, q[:tk], n > tk))
            rows += tk
            if n > tk:
                break
        if not parts:
            return
        if len(parts) > 1:
            self.coalesced_requests += len(parts)
        unit = parts[0][1] if len(parts) == 1 else \
            torch.cat([p[1] for p in parts], dim=0)
        bucket = next(bb for bb in self._buckets if bb >= rows)
        if rows < bucket:
            unit = torch.nn.functional.pad(unit, (0, 0, 0, bucket - rows))
        geom = self.index.search_geometry(s.topk, s.nprobe, s.nprobe_c)
        if geom != self._pinned_geom:
            self._pin_plans()
        warm = bucket in self._seen_buckets
        self._seen_buckets.add(bucket)
        if self._inflight:
            self.overlap_hits += 1
        t0 = time.perf_counter()
        ids, dists = self._search_padded(unit)
        if warm:
            self._dispatch_ms.append((time.perf_counter() - t0) * 1e3)
        event = None
        if unit.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.batches_formed += 1
        self.queries_served += rows
        lo = 0
        for rid, qpart, has_tail in parts:
            n = qpart.shape[0]
            self._settle(rid, ids[lo:lo + n], dists[lo:lo + n],
                         has_tail=has_tail)
            lo += n
        self._inflight.append(({rid for rid, _q, _t in parts},
                               (ids, dists), t0, warm, event))
        while len(self._inflight) > max(1, s.pipeline_depth):
            self._complete_oldest()

    def _settle(self, rid: int, ids: torch.Tensor, dists: torch.Tensor, *,
                has_tail: bool) -> None:
        """Keep one slice of a request; finish it once no tail is queued."""
        si, sd = self._partials.get(rid, ([], []))
        si.append(ids)
        sd.append(dists)
        if has_tail:
            self._partials[rid] = (si, sd)
            return
        self._partials.pop(rid, None)
        if len(si) == 1:
            self._results[rid] = (si[0], sd[0])
        else:
            self._results[rid] = (torch.cat(si, dim=0), torch.cat(sd, dim=0))

    # ------------------------------------------------------------------
    # synchronous wrappers and ingestion
    # ------------------------------------------------------------------

    def search(self, q) -> tuple[torch.Tensor, torch.Tensor]:
        """q: (B, d) -> (ids (B, topk), dists) for any B: submit, then
        take. Under a ``HealthPolicy`` it never returns a non-finite
        distance and raises only ``KERNEL_FAULTS``."""
        return self.take(self.submit(q))

    def _search_padded(self, q: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
        if self.health is None:
            return self.index.search(q, topk=self.scfg.topk,
                                     nprobe=self.scfg.nprobe,
                                     nprobe_c=self.scfg.nprobe_c)
        return self._ladder(q)

    def _attempt(self, q: torch.Tensor, nprobe: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """One configured search; non-finite output counts as a failure
        (one read of the unit's distances)."""
        ids, dists = self.index.search(q, topk=self.scfg.topk,
                                       nprobe=nprobe,
                                       nprobe_c=self.scfg.nprobe_c)
        if self.health.check_finite and not bool(torch.isfinite(dists).all()):
            raise NonFiniteResult("search returned non-finite distances")
        return ids, dists

    def _ladder(self, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The degradation ladder (``reliability.health``): retry/backoff,
        nprobe halving, brute force, last-known-good, black hole. Never
        raises, except on a fault of the card's kernels
        (``KERNEL_FAULTS``), which it passes on."""
        pol, ctr = self.health, self.counters
        nprobe = min(self.scfg.nprobe, self.index.k)
        attempts = pol.max_retries + 1   # retries only at the full nprobe
        delay = pol.backoff_s
        while True:
            for i in range(attempts):
                try:
                    ids, dists = self._attempt(q, nprobe)
                    if nprobe >= min(self.scfg.nprobe, self.index.k):
                        ctr.searches_ok += 1
                    else:
                        ctr.nprobe_degraded += 1
                    return ids, dists
                except KERNEL_FAULTS:
                    raise
                except Exception:
                    if i < attempts - 1:
                        ctr.retries += 1
                        if delay > 0:
                            time.sleep(delay)
                            delay *= pol.backoff_factor
            if nprobe > pol.min_nprobe:   # rung 2: cheaper, lower recall
                nprobe = max(pol.min_nprobe, nprobe // 2)
                attempts = 1
                continue
            break
        if pol.brute_fallback:   # rung 3: no probe stage left to fail
            try:
                ids, dists = self.index.search_brute(q, topk=self.scfg.topk)
                if not bool(torch.isfinite(dists).all()):
                    raise NonFiniteResult("brute force non-finite")
                ctr.brute_fallbacks += 1
                return ids, dists
            except KERNEL_FAULTS:
                raise
            except Exception:
                pass
        if pol.lkg_fallback and self._lkg is not None:   # rung 4: stale
            try:
                ids, dists = self._lkg.search(q, topk=self.scfg.topk,
                                              nprobe=nprobe)
                if not bool(torch.isfinite(dists).all()):
                    raise NonFiniteResult("lkg non-finite")
                ctr.lkg_fallbacks += 1
                return ids, dists
            except KERNEL_FAULTS:
                raise
            except Exception:
                pass
        ctr.blackholed += 1   # rung 5: honest empty rows
        b, dev = q.shape[0], self.index.device
        return (torch.full((b, self.scfg.topk), -1, dtype=torch.int32,
                           device=dev),
                torch.zeros((b, self.scfg.topk), dtype=torch.float32,
                            device=dev))

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------

    def add(self, x_new) -> torch.Tensor:
        """Online insert; refreshes the index every ``refresh_every`` adds
        (a host counter). With durability set the batch is written to the
        WAL before it touches the index (a batch on the card is copied to
        the host for its record); under a ``HealthPolicy`` it is validated
        first (``insert_policy``), and a failed add waits in the bounded
        queue and is retried first at the next add, or is rejected once the
        queue is full."""
        x = x_new if isinstance(x_new, torch.Tensor) else np.asarray(x_new)
        if self.health is not None:
            x, rep = guard_batch(x, self.index.d,
                                 policy=self.health.insert_policy,
                                 name="insert batch")
            if rep.action == "dropped":
                self.counters.insert_rows_dropped += rep.bad_rows
        if x.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.int32,
                               device=self.index.device)
        self._seqno += 1
        if self.wal is not None and not self._replaying:
            self.wal.append(self._seqno, x)
        self._drain_pending()
        a = self._apply(self._seqno, x)
        if self.adds_since_refresh >= self.scfg.refresh_every:
            self.refresh()
        self._adds_since_snap += 1
        if (self.scfg.snapshot_every and not self._replaying
                and self._adds_since_snap >= self.scfg.snapshot_every):
            self.snapshot()
        return a

    def _apply(self, seqno: int, x) -> torch.Tensor:
        """Apply one logged batch; park it (bounded) on failure."""
        try:
            a = self.index.add(x)
        except KERNEL_FAULTS:
            raise
        except Exception:
            if self.health is not None and len(self._pending_adds) \
                    < self.health.max_pending_adds:
                self._pending_adds.append((seqno, x))
                self.counters.adds_requeued += 1
            else:
                self.counters.adds_rejected += 1
            if self.health is None:
                raise
            return torch.zeros((0,), dtype=torch.int32,
                               device=self.index.device)
        self.adds_since_refresh += 1
        return a

    def _drain_pending(self) -> None:
        """Retry the parked adds ahead of new work."""
        for _ in range(len(self._pending_adds)):
            seqno, x = self._pending_adds.popleft()
            self._apply(seqno, x)

    def refresh(self) -> None:
        """Commit pending evidence: re-center the index's centroids. Under
        a ``HealthPolicy`` the commit is guarded (NaN statistics rows
        zeroed, dead cells re-seeded), and a failed commit leaves the
        schedule armed instead of raising."""
        pol = self.health
        try:
            if pol is not None:
                r0 = self.index.repaired_cells
                d0 = self.index.reseeded_cells
                self.index.refresh(decay=self.scfg.refresh_decay,
                                   guard=pol.guard_refresh,
                                   repair_dead=pol.repair_dead)
                self.counters.stats_repaired += \
                    self.index.repaired_cells - r0
                self.counters.dead_cells_reseeded += \
                    self.index.reseeded_cells - d0
            else:
                self.index.refresh(decay=self.scfg.refresh_decay)
        except KERNEL_FAULTS:
            raise
        except Exception:
            if pol is None:
                raise
            self.counters.refresh_failures += 1
            return
        self.adds_since_refresh = 0
        self.refresh_count += 1
        self._mark_healthy()

    def _mark_healthy(self) -> None:
        """Retake the last-known-good clone (rung 4 of the ladder): a copy
        of the index on its device (``reliability.snapshot.clone_index``),
        as large as the index."""
        if self.health is not None and self.health.lkg_fallback:
            from repro_torch.reliability.snapshot import clone_index
            self._lkg = None   # free the old clone before the new one
            self._lkg = clone_index(self.index)

    # ------------------------------------------------------------------
    # durability
    # ------------------------------------------------------------------

    def snapshot(self) -> str:
        """Snapshot the index (and the engine's schedule counters) as of
        the current WAL position, then drop the WAL records it covers."""
        if not self.scfg.snapshot_dir:
            raise ValueError("snapshot() needs scfg.snapshot_dir")
        path = self.index.save(
            self.scfg.snapshot_dir, seqno=self._seqno,
            extra={"adds_since_refresh": self.adds_since_refresh,
                   "refresh_count": self.refresh_count,
                   "queries_served": self.queries_served})
        if self.wal is not None:
            self.wal.truncate(self._seqno)
        self._adds_since_snap = 0
        self.counters.snapshots_written += 1
        return path

    @classmethod
    def recover(cls, directory: str, scfg: SearchConfig | None = None, *,
                health: HealthPolicy | None = None, faults=None,
                planner=None, device=None, pctx=None) -> "SearchEngine":
        """Crash recovery: load the latest snapshot onto ``device`` (None:
        ``"cuda"``) and replay the WAL's tail through the live ``add``
        path, which gives the index an uninterrupted run holds (same
        batches, same order, the refresh schedule resumed from the
        manifest's ``extra``). ``pctx`` waits for queue A item 6."""
        if pctx is not None:
            raise NotImplementedError(
                "recovering onto a mesh (pctx) is not ported yet "
                "(ROADMAP.md, queue A item 6)")
        from repro_torch.index.ivf import IVFIndex
        from repro_torch.reliability.snapshot import read_manifest
        index = IVFIndex.load(directory, planner=planner, device=device)
        scfg = dataclasses.replace(scfg or SearchConfig(),
                                   snapshot_dir=directory)
        eng = cls(index, scfg, health=health, faults=faults)
        manifest = read_manifest(directory)
        extra = manifest.get("extra", {})
        eng.adds_since_refresh = extra.get("adds_since_refresh", 0)
        eng.refresh_count = extra.get("refresh_count", 0)
        eng.queries_served = extra.get("queries_served", 0)
        eng._seqno = int(manifest.get("seqno", 0))
        eng._replaying = True
        try:
            for seqno, x in eng.wal.replay(after=eng._seqno):
                eng._seqno = seqno - 1   # add() reassigns exactly seqno
                eng.add(x)
                eng.counters.wal_records_replayed += 1
        finally:
            eng._replaying = False
        eng._mark_healthy()
        return eng
