"""Write-ahead add-log: inserts between snapshots replay on recovery.

Port of ``repro/reliability/wal.py``, in its file format. Every accepted
insert batch is appended to the log *before* it is applied to the live
index, one atomically written npz record per batch (``wal_%08d.npz``, the
batch under the key ``x``; tmp + rename), keyed by a monotonically
increasing sequence number. A snapshot records the sequence number it
covers; recovery loads the snapshot and replays every record with a higher
seqno through the live ``add`` path, which reproduces the index an
uninterrupted run holds (same batches, same order, same refresh schedule).

A batch that is a tensor on the card is copied to the host for its record.
``log_every = r`` logs every r-th batch (the RPO knob: up to ``r - 1``
recent batches may be lost); ``fsync=True`` flushes each record to disk
before its rename.
"""
from __future__ import annotations

import os

import numpy as np
import torch

_PREFIX, _SUFFIX = "wal_", ".npz"


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            raise NotImplementedError(
                "a bfloat16 batch has no numpy form without ml_dtypes; log "
                "it as float32")
        return x.detach().cpu().numpy()
    return np.asarray(x)


class AddLog:
    def __init__(self, directory: str, *, log_every: int = 1,
                 fsync: bool = False):
        if log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {log_every}")
        self.dir = directory
        self.log_every = int(log_every)
        self.fsync = fsync
        self.appended = 0   # append() calls (logged or RPO-skipped)
        self.skipped = 0    # batches inside the RPO window (not logged)
        os.makedirs(directory, exist_ok=True)

    def _path(self, seqno: int) -> str:
        return os.path.join(self.dir, f"{_PREFIX}{seqno:08d}{_SUFFIX}")

    def append(self, seqno: int, x) -> bool:
        """Durably record batch ``seqno``; returns False when the RPO
        policy (``log_every``) skipped it."""
        self.appended += 1
        if (self.appended - 1) % self.log_every != 0:
            self.skipped += 1
            return False
        path = self._path(seqno)
        tmp = path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, x=_host(x))
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        return True

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
        """Drop records covered by a snapshot (seqno <= upto)."""
        n = 0
        for s in self.seqnos():
            if s <= upto:
                os.remove(self._path(s))
                n += 1
        return n
