"""Write-ahead add-log: inserts between snapshots replay on recovery.

Port of ``repro/reliability/wal.py``, in its file format. Every accepted
insert batch is appended to the log *before* it is applied to the live
index, one atomically written npz record per batch (``wal_%08d.npz``, the
batch under the key ``x``; tmp + rename), keyed by a monotonically
increasing sequence number. A snapshot records the sequence number it
covers; recovery loads the snapshot and replays every record with a higher
seqno through the live ``add`` path, which reproduces the index an
uninterrupted run holds (same batches, same order, same refresh schedule).

A batch that is a tensor on the card is copied to the host for its record;
a bfloat16 batch is written as the reference writes one, as 2-byte void
records (``|V2``, ``utils.host.host_array``), and ``replay``
yields that ``|V2`` array, as the reference's does.
``log_every = r`` logs every r-th batch (the RPO knob: up to ``r - 1``
recent batches may be lost); ``fsync=True`` flushes each record to disk
before its rename.

On a mesh (``pctx``, a ``core.parallel.ParallelContext``; every rank holds
the same batches) rank 0 alone writes a record, or drops the records a
snapshot covers, and every rank then agrees on the outcome
(``ParallelContext.rank0_write``): no rank applies an add before its record
is durable, and a failed write raises on every rank. Every rank reads
``replay``.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.utils.host import host_array

_PREFIX, _SUFFIX = "wal_", ".npz"


class AddLog:
    def __init__(self, directory: str, *, log_every: int = 1,
                 fsync: bool = False, pctx=None):
        if log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {log_every}")
        self.dir = directory
        self.log_every = int(log_every)
        self.fsync = fsync
        self.pctx = pctx
        self.appended = 0   # append() calls (logged or RPO-skipped)
        self.skipped = 0    # batches inside the RPO window (not logged)
        os.makedirs(directory, exist_ok=True)

    def _path(self, seqno: int) -> str:
        return os.path.join(self.dir, f"{_PREFIX}{seqno:08d}{_SUFFIX}")

    def append(self, seqno: int, x) -> bool:
        """Durably record batch ``seqno``; returns False when the RPO
        policy (``log_every``) skipped it. On a mesh every rank calls it
        and returns once rank 0's record is in place (or raises, every
        rank, when it could not be written)."""
        self.appended += 1
        if (self.appended - 1) % self.log_every != 0:
            self.skipped += 1
            return False
        if self.pctx is None:
            self._write(seqno, x)
        else:
            self.pctx.rank0_write(lambda: self._write(seqno, x))
        return True

    def _write(self, seqno: int, x) -> None:
        path = self._path(seqno)
        tmp = path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, x=host_array(x))
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)

    def seqnos(self) -> list[int]:
        return sorted(int(f[len(_PREFIX):-len(_SUFFIX)])
                      for f in os.listdir(self.dir)
                      if f.startswith(_PREFIX) and f.endswith(_SUFFIX)
                      and not f.endswith(".tmp.npz"))

    def replay(self, after: int = 0):
        """Yield ``(seqno, batch)`` for every record with seqno > after, in
        order: the recovery stream (host numpy batches)."""
        for s in self.seqnos():
            if s > after:
                with np.load(self._path(s)) as data:
                    yield s, data["x"]

    def truncate(self, upto: int) -> int:
        """Drop records covered by a snapshot (seqno <= upto); on a mesh
        rank 0 removes them and every rank agrees on the outcome."""
        covered = [s for s in self.seqnos() if s <= upto]

        def drop():
            for s in covered:
                os.remove(self._path(s))
        if self.pctx is None:
            drop()
        else:
            self.pctx.rank0_write(drop)
        return len(covered)
