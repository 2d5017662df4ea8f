"""repro_torch.reliability — the serving path's reliability layer.

Port of ``repro/reliability``, on one device and over a mesh (rank 0 writes
the files, and every rank agrees that they are in place before it goes on),
in the reference's file formats:

- **durability** (``snapshot``, ``wal``): ``IVFIndex`` snapshots (npz plus
  a JSON manifest, written atomically, ``SNAPSHOT_VERSION = 5``) and a
  write-ahead add-log, so inserts between snapshots replay on recovery;
  a snapshot or WAL written by either package restores in the other;
- **guarded ingestion** (``validate``): shape, dtype and non-finite checks
  with reject, drop and sanitize policies, on the card for a tensor there;
- **fault injection** (``faults``): seeded, replayable fault plans with
  seams in ``IVFIndex.add``, ``refresh`` and ``search``;
- **health** (``health``): the ``HealthPolicy`` retry, backoff and
  degradation ladder and the ``HealthCounters`` it reports through.
"""
from repro_torch.reliability.faults import (FaultEvent, FaultInjector,
                                            FaultPlan, InjectedFault,
                                            corrupt_stats)
from repro_torch.reliability.health import (HealthCounters, HealthPolicy,
                                            NonFiniteResult)
from repro_torch.reliability.snapshot import (clone_index,
                                              latest_snapshot_seqno,
                                              load_index, read_manifest,
                                              save_index)
from repro_torch.reliability.validate import (BatchReport, ValidationError,
                                              guard_batch)
from repro_torch.reliability.wal import AddLog

__all__ = [
    "AddLog", "BatchReport", "FaultEvent", "FaultInjector", "FaultPlan",
    "HealthCounters", "HealthPolicy", "InjectedFault", "NonFiniteResult",
    "ValidationError", "clone_index", "corrupt_stats", "guard_batch",
    "latest_snapshot_seqno", "load_index", "read_manifest", "save_index",
]
