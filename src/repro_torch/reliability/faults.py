"""Deterministic fault injection for the online serving path.

Port of ``repro/reliability/faults.py``. A ``FaultPlan`` is pure data: a
list of ``FaultEvent``s, each pinned to a *site* (the injection seam) and
a *step* (the site's call index it fires at). ``FaultPlan.seeded`` draws
one from ``np.random.default_rng(seed)`` in the reference's order, so both
packages build the same plan from the same seed, and a plan serializes to
JSON for bug reports.

Injection seams (consulted by ``IVFIndex`` when an injector is attached as
``index.faults``; the serving engine recovers above them):

- ``add``: ``drop_add`` silently loses the batch (the WAL still has it),
  ``add_error`` raises ``InjectedFault``, ``latency`` sleeps ``arg``
  seconds, ``nan_stats`` sets a seeded subset of the pending
  ``SufficientStats`` rows to NaN after the fold (``refresh(guard=True)``
  must repair it);
- ``refresh``: ``nan_stats`` as above, at commit time, and ``latency``;
- ``search``: ``latency``, ``search_error`` (raises ``InjectedFault``), and
  ``dead_shard``, which on one device, where there is no shard to lose but
  the whole replica, raises ``InjectedFault`` as the reference's
  single-device branch does.

Events fire once: the injector counts calls per site and an event at step
``i`` hits only the ``i``-th call, so a retry recovers unless the plan
says otherwise.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

SITES = ("add", "refresh", "search")
KINDS = ("drop_add", "add_error", "nan_stats", "dead_shard", "latency",
         "search_error")
_SITE_OF = {"drop_add": "add", "add_error": "add", "nan_stats": "add",
            "dead_shard": "search", "latency": "search",
            "search_error": "search"}


class InjectedFault(RuntimeError):
    """Raised by an injection seam to simulate a hard failure."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    site: str         # injection seam consulted ("add"/"refresh"/"search")
    kind: str         # one of KINDS
    step: int         # fires at the site's step-th call (0-based)
    arg: float = 0.0  # latency seconds / corruption seed / shard id

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """An immutable, replayable schedule of fault events."""

    def __init__(self, events):
        self.events = tuple(sorted(
            events, key=lambda e: (e.site, e.step, e.kind)))

    @classmethod
    def seeded(cls, seed: int, *, kinds=KINDS, n_events: int = 6,
               horizon: int = 16) -> "FaultPlan":
        """Derive a deterministic plan from ``seed``: ``n_events`` faults
        of the given ``kinds``, each landing at a call index < ``horizon``
        of its natural site. Same seed -> same plan, forever."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            kind = kinds[int(rng.integers(len(kinds)))]
            step = int(rng.integers(horizon))
            if kind == "latency":
                arg = float(rng.uniform(0.001, 0.01))
            else:   # corruption seed / shard id — any small int works
                arg = float(rng.integers(64))
            events.append(FaultEvent(_SITE_OF[kind], kind, step, arg))
        return cls(events)

    def to_json(self) -> str:
        return json.dumps([dataclasses.asdict(e) for e in self.events])

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        return cls([FaultEvent(**e) for e in json.loads(s)])

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.events)!r})"


class FaultInjector:
    """Stateful executor of a ``FaultPlan``: counts calls per site and
    hands each seam the events firing at its current call index."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._calls: dict[str, int] = {}
        self.fired: list[FaultEvent] = []

    def poll(self, site: str) -> tuple[FaultEvent, ...]:
        """Advance ``site``'s call counter; return the events firing now."""
        i = self._calls.get(site, 0)
        self._calls[site] = i + 1
        evs = tuple(e for e in self.plan.events
                    if e.site == site and e.step == i)
        self.fired.extend(evs)
        return evs

    def count(self, kind: str | None = None) -> int:
        if kind is None:
            return len(self.fired)
        return sum(1 for e in self.fired if e.kind == kind)


def corrupt_stats(stats, seed: int, frac: float = 0.125):
    """Corrupt a seeded subset of per-cluster stats rows to NaN.

    ``frac`` of the K rows (at least one), chosen by ``seed`` as the
    reference chooses them, get NaN sums and counts, on the stats' device.
    Returns ``(corrupted SufficientStats, bad_cells int array)``.
    """
    from repro_torch.core.streaming import SufficientStats
    k = stats.counts.shape[0]
    rng = np.random.default_rng(int(seed))
    bad = np.sort(rng.choice(k, max(1, int(k * frac)), replace=False))
    bad_t = torch.as_tensor(bad, device=stats.sums.device)
    return SufficientStats(stats.sums.index_fill(0, bad_t, float("nan")),
                           stats.counts.index_fill(0, bad_t, float("nan")),
                           stats.inertia), bad
