"""Carry a FlashIVF index between the JAX package and the port, as numpy.

``index_from_numpy`` builds the port's ``IVFIndex`` from an index's host
state: its centroids, the store's ``state_arrays()`` and ``meta()`` (the
keys of the reference's snapshot format), ``n_total``, the committed and
pending ``SufficientStats`` as ``(sums, counts, inertia)`` and, for a q8
store with a device rescore cache, the cache's state (``CACHE_KEYS``:
``keys``, ``rows``, ``ref``, ``hand``, ``sets``, ``ways``, ``max_bytes``,
``inserted``), so a budgeted cache crosses with its eviction state, and
the router as ``{"meta": router.meta(), "arrays": router.state_arrays()}``
(the reference's snapshot keys; ``router_from_numpy``, through the
snapshot's ``router.restore_router``), so both packages
search over one coarse level (their trainings draw from different RNGs).
``index_to_numpy`` gives the same state back from the port's index (a
paged store in the reference's canonical packed form: occupied pages
cell-major, no free-list state). The
JAX side converts with ``np.asarray``; neither package is imported here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.streaming import SufficientStats
from repro_torch.index.ivf import IVFIndex
from repro_torch.index.rescore_cache import DeviceRescoreCache
from repro_torch.index.router import restore_router
from repro_torch.index.store import restore_store

CACHE_KEYS = ("keys", "rows", "ref", "hand", "sets", "ways", "max_bytes",
              "inserted")


def _stats(t, device) -> SufficientStats:
    sums, counts, inertia = (torch.tensor(np.asarray(a, np.float32),
                                          device=device) for a in t)
    return SufficientStats(sums, counts, inertia)


def router_from_numpy(state: dict | None, *, device=None, planner=None):
    """A router from ``{"meta", "arrays"}`` (a router's ``meta()`` and
    ``state_arrays()``, either package's); None or a flat meta gives the
    flat router (``router.restore_router``; ``device=None`` means
    ``"cuda"``)."""
    state = state or {}
    return restore_router(state.get("meta"), state.get("arrays") or {},
                          planner=planner, device=device)


def index_from_numpy(centroids, store_arrays: dict, store_meta: dict, *,
                     n_total: int, stats, pending, cache: dict | None = None,
                     router: dict | None = None, device=None, planner=None,
                     rescore_mult: "int | str" = 4) -> IVFIndex:
    """The port's index over the given state (``device=None`` means
    ``"cuda"``, as every entry point). A q8 store's reservoir comes back
    as the durable host tier. Its device rescore cache is the carried
    ``cache`` state when given; otherwise the manifest's ``rescore_cache``
    entry rebuilds it and it re-warms from the reservoir, as a snapshot
    restore does. ``router``: the carried router state
    (``router_from_numpy``; None: the flat router)."""
    centroids = np.array(centroids, np.float32)    # a writable copy
    k, d = centroids.shape
    host = {key: np.asarray(v) for key, v in store_arrays.items()}
    meta = store_meta if cache is None else dict(store_meta,
                                                 rescore_cache=None)
    store = restore_store(host, meta, k=k, d=d, dtype=torch.float32,
                          device=device)
    if cache is not None:
        store.cache = _cache_from_numpy(cache, d, store.device)
    rt = router_from_numpy(router, device=store.device, planner=planner)
    index = IVFIndex(centroids, store.capacity, device=device,
                     planner=planner, rescore_mult=rescore_mult,
                     store=store, router=rt)
    index.n_total = int(n_total)
    index.stats = _stats(stats, index.device)
    index._pending = _stats(pending, index.device)
    return index


def _cache_from_numpy(state: dict, d: int, device) -> DeviceRescoreCache:
    cache = DeviceRescoreCache(d, max_bytes=state["max_bytes"],
                               ways=int(state["ways"]), device=device)
    cache.sets = int(state["sets"])
    as_t = lambda key, dt: torch.tensor(np.asarray(state[key]), dtype=dt,
                                        device=device)
    cache.keys = as_t("keys", torch.int32).reshape(cache.sets, cache.ways)
    cache.rows = as_t("rows", torch.float32).reshape(cache.sets, cache.ways,
                                                     d)
    cache.ref = as_t("ref", torch.int32).reshape(cache.sets, cache.ways)
    cache.hand = as_t("hand", torch.int32).reshape(cache.sets)
    cache.inserted = int(state["inserted"])
    return cache


def cache_to_numpy(cache: DeviceRescoreCache | None) -> dict | None:
    """A device rescore cache's state under ``CACHE_KEYS``, as host numpy
    (None for no cache)."""
    if cache is None:
        return None
    return {"keys": cache.keys.cpu().numpy(), "rows": cache.rows.cpu().numpy(),
            "ref": cache.ref.cpu().numpy(), "hand": cache.hand.cpu().numpy(),
            "sets": cache.sets, "ways": cache.ways,
            "max_bytes": cache.max_bytes, "inserted": cache.inserted}


def index_to_numpy(index: IVFIndex) -> dict:
    """``{"centroids", "store_arrays", "store_meta", "n_total", "stats",
    "pending", "cache", "router"}`` of the port's index, as host numpy
    (``cache``: ``cache_to_numpy`` of the store's device rescore cache;
    ``router``: its ``meta()`` and ``state_arrays()``)."""
    host = lambda st: tuple(t.cpu().numpy() for t in st)
    return {"centroids": index.centroids.float().cpu().numpy(),
            "store_arrays": index.store.state_arrays(),
            "store_meta": index.store.meta(), "n_total": index.n_total,
            "stats": host(index.stats), "pending": host(index._pending),
            "cache": cache_to_numpy(getattr(index.store, "cache", None)),
            "router": {"meta": index.router.meta(),
                       "arrays": index.router.state_arrays()}}
