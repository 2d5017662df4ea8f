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

Not ported yet (ROADMAP.md, queue A item 5, reliability): the health
ladder (``health``), fault injection (``faults``), the WAL and snapshots
(``SearchConfig.snapshot_dir``, ``snapshot_every``, ``wal_log_every``,
``snapshot``) and ``recover``; each raises ``NotImplementedError`` when
given a value. The clustered-KV ``Engine`` waits for queue A item 7.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

_RELIABILITY = ("is not ported yet (ROADMAP.md, queue A item 5: the "
                "reliability layer)")


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
    # durability (queue A item 5; only the defaults are taken)
    snapshot_dir: str | None = None
    snapshot_every: int = 0
    wal_log_every: int = 1


class SearchEngine:
    """Continuous-batching query -> top-k serving over an ``IVFIndex``
    (module docstring). ``search``/``add`` are the synchronous wrappers:
    submit, then take."""

    def __init__(self, index, scfg: SearchConfig | None = None, *,
                 health=None, faults=None):
        self.scfg = scfg or SearchConfig()
        if health is not None:
            raise NotImplementedError(f"health (the HealthPolicy ladder) "
                                      f"{_RELIABILITY}")
        if faults is not None:
            raise NotImplementedError(f"faults (fault injection) "
                                      f"{_RELIABILITY}")
        if (self.scfg.snapshot_dir is not None or self.scfg.snapshot_every
                or self.scfg.wal_log_every != 1):
            raise NotImplementedError(f"snapshot_dir / snapshot_every / "
                                      f"wal_log_every (the WAL and "
                                      f"snapshots) {_RELIABILITY}")
        self.index = index
        self.queries_served = 0
        self.adds_since_refresh = 0
        self.refresh_count = 0
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
        index's device here."""
        q = torch.as_tensor(q).to(device=self.index.device,
                                  dtype=self.index.dtype)
        return self._admit("search", q)

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
        ids, dists = self.index.search(unit, topk=s.topk, nprobe=s.nprobe,
                                       nprobe_c=s.nprobe_c)
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
        take."""
        return self.take(self.submit(q))

    def add(self, x_new) -> torch.Tensor:
        """Online insert; refreshes the index every ``refresh_every`` adds
        (a host counter)."""
        if x_new.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.int32,
                               device=self.index.device)
        a = self.index.add(x_new)
        self.adds_since_refresh += 1
        if self.adds_since_refresh >= self.scfg.refresh_every:
            self.refresh()
        return a

    def refresh(self) -> None:
        """Commit pending evidence: re-center the index's centroids."""
        self.index.refresh(decay=self.scfg.refresh_decay)
        self.adds_since_refresh = 0
        self.refresh_count += 1

    def snapshot(self) -> str:
        raise NotImplementedError(f"SearchEngine.snapshot {_RELIABILITY}")

    @classmethod
    def recover(cls, directory: str, scfg: SearchConfig | None = None, **kw
                ) -> "SearchEngine":
        raise NotImplementedError(f"SearchEngine.recover {_RELIABILITY}")
