"""Durable ``IVFIndex`` snapshots in the reference's format.

Port of ``repro/reliability/snapshot.py`` for one device, file for file:
one atomically written npz a snapshot (``index_%08d.npz``, tmp + rename)
and a JSON manifest (``index_manifest.json``) recording each array's shape
and dtype (``checkpoint.array_manifest``), the WAL sequence number the
snapshot covers, and the index's scalar state. The arrays are the store's
canonical form (``state_arrays``: a paged store writes its occupied pages
packed cell-major, no physical page ids), the router's, the centroids and
the committed and pending statistics, under the reference's keys and
dtypes, so a snapshot written by either package restores in the other.

Version history (the reference's): v3 adds the payload codec (a q8 store
writes its codes, scales, anchors and the rescore reservoir; v1/v2
manifests restore as fp32); v4 the router (``manifest["router"]``; v1-v3
restore with the flat router); v5 the device rescore cache's geometry
(``manifest["store"]["rescore_cache"]``, never its rows: restore re-warms
the cache from the reservoir; v1-v4 take the process default).

Plans. The reference writes its plan cache (tuples of TPU block sizes)
under ``search_plans`` and installs it on load. The port's plans are
``KernelPlan`` objects for the card, so it writes ``"search_plans": []``
and never installs a list read from a manifest: its plans come back from
its planner, in memory or from its disk cache keyed to the card.

A bfloat16 index is refused (``NotImplementedError``): the reference's npz
holds ``ml_dtypes`` bfloat16 arrays, which the card's machine cannot read.

``clone_index`` is the last-known-good copy the ``HealthPolicy`` ladder
falls back to. The reference round-trips the state through the host; the
port copies each tensor on its device (``copy.deepcopy``, which clones
tensors into new storage), so the clone shares no storage with the live
index and costs no host round trip.
"""
from __future__ import annotations

import copy
import json
import os

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import array_manifest, validate_arrays
from repro_torch.core.streaming import SufficientStats
from repro_torch.index import router as _router
from repro_torch.index import store as _store

SNAPSHOT_VERSION = 5
_PREFIX, _SUFFIX = "index_", ".npz"
MANIFEST = "index_manifest.json"


def _no_bf16(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: a bfloat16 index's snapshot holds ml_dtypes bfloat16 "
        f"arrays, which are not supported (ROADMAP.md, queue A)")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _state_arrays(index) -> dict[str, np.ndarray]:
    """The full index state on the host, under the snapshot's keys."""
    if index.centroids.dtype == torch.bfloat16:
        raise _no_bf16("save_index")
    host = {
        "centroids": _host(index.centroids),
        "stats_sums": _host(index.stats.sums),
        "stats_counts": _host(index.stats.counts),
        "stats_inertia": _host(index.stats.inertia),
        "pending_sums": _host(index._pending.sums),
        "pending_counts": _host(index._pending.counts),
        "pending_inertia": _host(index._pending.inertia),
    }
    host.update(index.store.state_arrays())
    host.update(index.router.state_arrays())
    return host


def _path(directory: str, seqno: int) -> str:
    return os.path.join(directory, f"{_PREFIX}{seqno:08d}{_SUFFIX}")


def save_index(index, directory: str, *, seqno: int = 0,
               extra: dict | None = None) -> str:
    """Snapshot ``index`` into ``directory`` as of WAL position ``seqno``.
    ``extra`` (JSON-able) rides in the manifest: the serving engine keeps
    its schedule counters there, so recovery resumes the schedule."""
    os.makedirs(directory, exist_ok=True)
    host = _state_arrays(index)
    path = _path(directory, seqno)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **host)
    os.replace(tmp, path)
    manifest = {
        "version": SNAPSHOT_VERSION, "seqno": int(seqno),
        "k": index.k, "d": index.d, "cap": index.cap,
        "max_cap": index.max_cap, "n_total": index.n_total,
        "spilled": int(index.spilled),
        "store": index.store.meta(),
        "router": index.router.meta(),
        "search_plans": [],
        "arrays": array_manifest(host),
        "extra": extra or {},
    }
    mpath = os.path.join(directory, MANIFEST)
    with open(mpath + ".tmp", "w") as f:
        json.dump(manifest, f)
    os.replace(mpath + ".tmp", mpath)
    return path


def read_manifest(directory: str) -> dict:
    with open(os.path.join(directory, MANIFEST)) as f:
        return json.load(f)


def latest_snapshot_seqno(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    seqs = [int(f[len(_PREFIX):-len(_SUFFIX)])
            for f in os.listdir(directory)
            if f.startswith(_PREFIX) and f.endswith(_SUFFIX)
            and not f.endswith(".tmp.npz")]
    return max(seqs) if seqs else None


def _stats(host: dict, prefix: str, device) -> SufficientStats:
    return SufficientStats(*(torch.tensor(host[f"{prefix}_{key}"],
                                          device=device)
                             for key in ("sums", "counts", "inertia")))


def _rebuild(host: dict, meta: dict, *, planner=None, device=None):
    """A live ``IVFIndex`` from host state and its manifest meta."""
    from repro_torch.index.ivf import IVFIndex   # lazy: an import cycle
    centroids = np.asarray(host["centroids"])
    if centroids.dtype != np.float32:   # a bfloat16 index's npz
        raise _no_bf16("load_index")
    k, d = centroids.shape
    store = _store.restore_store(host, meta["store"], k=k, d=d,
                                 dtype=torch.float32, device=device)
    if store.kind != meta["store"].get("kind", "padded"):
        raise ValueError(f"store kind drifted: {store.kind!r} restored, "
                         f"{meta['store'].get('kind')!r} recorded")
    # the router comes back from its state, never re-trained
    router = _router.restore_router(meta.get("router"), host,
                                    planner=planner, device=store.device)
    index = IVFIndex(centroids, capacity=store.capacity, device=store.device,
                     planner=planner, store=store, router=router)
    index.n_total = int(meta["n_total"])
    index.stats = _stats(host, "stats", index.device)
    index._pending = _stats(host, "pending", index.device)
    return index


def load_index(directory: str, *, seqno: int | None = None, planner=None,
               device=None):
    """Restore a snapshot (the latest, or a given ``seqno``) onto
    ``device`` (None: ``"cuda"``). Where the manifest covers the seqno,
    the arrays are validated against its shape/dtype records first; an
    older snapshot takes its scalars from the array shapes
    (``store.infer_store_meta``), as in the reference."""
    if seqno is None:
        seqno = latest_snapshot_seqno(directory)
        if seqno is None:
            raise FileNotFoundError(f"no index snapshot in {directory}")
    manifest = read_manifest(directory)
    with np.load(_path(directory, seqno)) as data:
        host = {k: data[k] for k in data.files}
    if manifest.get("seqno") == seqno:
        if "bfloat16" in (manifest["arrays"].get("centroids") or {}).get(
                "dtype", ""):
            raise _no_bf16("load_index")
        validate_arrays(manifest["arrays"], host,
                        context=f"load_index(seqno {seqno})")
        meta = manifest
        if "store" not in meta:   # pre-paged (version 1) manifest
            meta = dict(meta, store=_store.infer_store_meta(host, meta))
    else:   # older snapshot than the manifest covers: scalars from shapes
        meta = {"n_total": int(host["counts"].sum()),
                "store": _store.infer_store_meta(host, {})}
    return _rebuild(host, meta, planner=planner, device=device)


def clone_index(index, *, planner=None):
    """The last-known-good copy: every tensor of the store (its device
    rescore cache included), the router, the centroids and both statistics
    cloned on its device, the host reservoir and host mirrors copied; no
    storage shared with ``index`` and no fault injector attached."""
    from repro_torch.index.ivf import IVFIndex   # lazy: an import cycle
    planner = planner if planner is not None else index.planner
    memo = {id(index.planner): index.planner, id(planner): planner}
    rt = getattr(index.router, "planner", None)
    if rt is not None:
        memo[id(rt)] = rt
    store = copy.deepcopy(index.store, memo)
    router = copy.deepcopy(index.router, memo)
    clone = IVFIndex(index.centroids.clone(), store.capacity,
                     device=index.device, planner=planner,
                     rescore_mult=("auto" if index.rescore_mult is None
                                   else index.rescore_mult),
                     store=store, router=router)
    clone.n_total = index.n_total
    clone.stats = SufficientStats(*(t.clone() for t in index.stats))
    clone._pending = SufficientStats(*(t.clone() for t in index._pending))
    clone._search_plans = dict(index._search_plans)
    return clone
