"""HealthPolicy: retry/backoff and the degraded-mode search ladder.

Port of ``repro/reliability/health.py``, field for field. The serving
contract under faults: ``SearchEngine.search`` never raises and never
returns non-finite distances. It walks this ladder instead, recording
every rung in ``HealthCounters``:

  1. retry the configured search up to ``max_retries`` times with
     exponential backoff (transient faults);
  2. degrade ``nprobe`` (halving down to ``min_nprobe``): cheaper, lower
     recall, the same index and kernels;
  3. brute force (``IVFIndex.search_brute``): no probe stage to fail,
     exact over whatever the index still holds;
  4. last-known-good: search an on-device clone captured at the last
     healthy refresh (stale but sane data);
  5. black hole: honest ``(-1, 0.0)`` rows, never an exception, never a
     NaN.

Ingestion is guarded the same way: validation policies
(``reliability.validate``), a bounded queue of pending adds, and the
guarded ``refresh`` (NaN-stats repair, dead-cell re-seeding) below it.
"""
from __future__ import annotations

import dataclasses


class NonFiniteResult(RuntimeError):
    """A search returned non-finite distances (treated as a failure and
    retried/degraded like any other fault)."""


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    # ladder rung 1: retry/backoff
    max_retries: int = 2
    backoff_s: float = 0.005       # first retry delay; 0 disables sleeping
    backoff_factor: float = 2.0
    # rung 2..4: degradation
    min_nprobe: int = 1
    brute_fallback: bool = True
    lkg_fallback: bool = True      # keep + search a last-known-good clone
    # ingestion guards
    query_policy: str = "sanitize"   # keep row alignment for queries
    insert_policy: str = "drop"      # never index garbage
    max_pending_adds: int = 64       # admission queue bound (backpressure)
    # refresh self-repair
    guard_refresh: bool = True       # sanitize NaN stats at commit
    repair_dead: bool = True         # re-seed dead cells from a split
    # output guarantee
    check_finite: bool = True        # non-finite results count as failures


@dataclasses.dataclass
class HealthCounters:
    """Every degradation the engine took, surfaced for ops dashboards
    (``launch.serve`` prints this dict; benchmarks record it)."""

    searches_ok: int = 0            # served at the configured nprobe
    retries: int = 0
    nprobe_degraded: int = 0        # searches served at a reduced nprobe
    brute_fallbacks: int = 0
    lkg_fallbacks: int = 0
    blackholed: int = 0             # gave up: honest empty results
    queries_sanitized: int = 0      # non-finite query rows zeroed
    insert_rows_dropped: int = 0    # non-finite insert rows refused
    adds_requeued: int = 0          # failed adds parked for retry
    adds_rejected: int = 0          # admission queue full: refused
    refresh_failures: int = 0
    stats_repaired: int = 0         # NaN stats rows dropped at commit
    dead_cells_reseeded: int = 0
    wal_records_replayed: int = 0
    snapshots_written: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def degraded(self) -> bool:
        return (self.nprobe_degraded + self.brute_fallbacks
                + self.lkg_fallbacks + self.blackholed) > 0
