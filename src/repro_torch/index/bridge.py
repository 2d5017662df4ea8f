"""Carry a FlashIVF index between the JAX package and the port, as numpy.

``index_from_numpy`` builds the port's ``IVFIndex`` from an index's host
state: its centroids, the store's ``state_arrays()`` and ``meta()`` (the
keys of the reference's snapshot format), ``n_total``, and the committed
and pending ``SufficientStats`` as ``(sums, counts, inertia)``.
``index_to_numpy`` gives the same state back from the port's index. The
JAX side converts with ``np.asarray``; neither package is imported here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kmeans import resolve_device
from repro_torch.core.streaming import SufficientStats
from repro_torch.index import store as _store
from repro_torch.index.ivf import IVFIndex


def _stats(t, device) -> SufficientStats:
    sums, counts, inertia = (torch.tensor(np.asarray(a, np.float32),
                                          device=device) for a in t)
    return SufficientStats(sums, counts, inertia)


def index_from_numpy(centroids, store_arrays: dict, store_meta: dict, *,
                     n_total: int, stats, pending, device=None,
                     planner=None, rescore_mult: "int | str" = 4
                     ) -> IVFIndex:
    """The port's index over the given state (``device=None`` means
    ``"cuda"``, as every entry point). A q8 store's reservoir comes back
    as the host rescore path; the reference's device rescore cache is not
    part of the state (it re-warms from the reservoir)."""
    centroids = np.array(centroids, np.float32)    # a writable copy
    k, d = centroids.shape
    host = {key: np.asarray(v) for key, v in store_arrays.items()}
    index = IVFIndex(centroids, int(store_meta["cap"]), device=device,
                     planner=planner, rescore_mult=rescore_mult,
                     store=_restore_store(host, store_meta, k, d, device))
    index.n_total = int(n_total)
    index.stats = _stats(stats, index.device)
    index._pending = _stats(pending, index.device)
    return index


def _restore_store(host: dict, meta: dict, k: int, d: int, device):
    dev = resolve_device(device)
    if meta.get("codec", "fp32") != "fp32":
        return _store.QuantizedBucketStore.restore(
            host, meta, k=k, d=d, dtype=torch.float32, device=dev)
    _store._resolve_kind(meta.get("kind", "padded"))
    return _store.PaddedBucketStore.restore(host, meta, k=k, d=d,
                                            dtype=torch.float32, device=dev)


def index_to_numpy(index: IVFIndex) -> dict:
    """``{"centroids", "store_arrays", "store_meta", "n_total", "stats",
    "pending"}`` of the port's index, as host numpy."""
    host = lambda st: tuple(t.cpu().numpy() for t in st)
    return {"centroids": index.centroids.float().cpu().numpy(),
            "store_arrays": index.store.state_arrays(),
            "store_meta": index.store.meta(), "n_total": index.n_total,
            "stats": host(index.stats), "pending": host(index._pending)}
