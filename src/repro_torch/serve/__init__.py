"""repro_torch.serve — serving over the port's index.

  SearchConfig / SearchEngine — continuous-batching vector search over an
  ``IVFIndex`` with inserts interleaved and CUDA-event overlapped dispatch
  (``serve/engine.py``), with the reliability layer's health ladder, fault
  injection, WAL, snapshots and ``recover``.

Not ported yet (ROADMAP.md, queue A): the clustered-KV ``Engine`` and
``ServeConfig`` (item 8).
"""
from repro_torch.serve.engine import SearchConfig, SearchEngine

__all__ = ["SearchConfig", "SearchEngine"]
