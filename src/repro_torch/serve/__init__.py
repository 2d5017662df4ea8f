"""repro_torch.serve — the port's serving engines.

  ServeConfig / Engine — LM serving of every architecture record: prefill
  and decode, dense or against the flash-kmeans clustered KV cache with
  incremental re-clustering (``serve/engine.py``).
  SearchConfig / SearchEngine — continuous-batching vector search over an
  ``IVFIndex`` with inserts interleaved and CUDA-event overlapped dispatch,
  with the reliability layer's health ladder, fault injection, WAL,
  snapshots and ``recover``.

Both serve over a mesh: ``Engine(mesh=)`` (the LM's DTensors,
``utils.sharding``) and ``SearchEngine`` over a sharded ``IVFIndex``.
"""
from repro_torch.serve.engine import (Engine, SearchConfig, SearchEngine,
                                      ServeConfig)

__all__ = ["Engine", "SearchConfig", "SearchEngine", "ServeConfig"]
