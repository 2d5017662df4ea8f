"""Distributed flash-kmeans — the thin adapter over ``core.parallel``.

Port of ``repro/core/distributed.py``: the stable public surface of the
multi-rank Lloyd loop, built on ``core.parallel.ParallelContext``.

- ``make_distributed_kmeans(mesh, cfg, data_axes, k_axis,
  compress_pod_axis)`` builds a ``ParallelContext`` and returns its Lloyd
  loop ``fit(x, c0) -> FitResult(centroids, assignments, inertia)`` over
  global tensors;
- ``shard_points`` gives this rank's rows of a global array.

The statistics ``(s_k, n_k)`` are sufficient and associative, so the
out-of-core chunk reduction (``core.chunked``), the streaming accumulator
(``core.streaming``) and the multi-rank reduction here are one tree:
per-rank Lloyd statistics, an all-reduce over the data axes, the
replicated ``finalize_centroids`` update. N-sharding keeps the centroids
replicated (one (K, d) + (K,) all-reduce an iteration, the fused FlashLloyd
step where ``auto`` takes it); K-sharding splits them too, with the
two-stage argmin and the owned-range statistics (the sort-inverse update
over K/P_k + 1 buckets).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.kmeans import KMeansConfig
from repro_torch.core.parallel import ParallelContext


def make_distributed_kmeans(mesh, cfg: KMeansConfig,
                            data_axes: Sequence[str] = ("data",),
                            k_axis: str | None = None,
                            compress_pod_axis: str | None = None):
    """``fit(x, c0) -> FitResult(centroids, assignments, inertia)``: x (N,
    d) and c0 (K, d) global, split over ``data_axes`` and ``k_axis`` by
    the program. See ``ParallelContext.make_kmeans_fit``."""
    pctx = ParallelContext(mesh, data_axes=data_axes, k_axis=k_axis)
    return pctx.make_kmeans_fit(cfg, compress_pod_axis=compress_pod_axis)


def shard_points(mesh, x, data_axes: Sequence[str] = ("data",)):
    """This rank's rows of the global host array ``x`` (split along N)."""
    return ParallelContext(mesh, data_axes=data_axes).shard_points(x)
