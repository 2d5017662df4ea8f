"""Durable, mesh-agnostic ``IVFIndex`` snapshots in the reference's format.

Port of ``repro/reliability/snapshot.py``, file for file:
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

A bfloat16 index is written as the reference writes one: its centroids
and buckets as 2-byte void records (``|V2``, the form ``np.savez`` gives an
``ml_dtypes`` bfloat16 array; ``utils.host.host_array``) under
manifest entries ``bfloat16``. Neither package reads such a snapshot back:
``load_index`` raises the reference's ``ValueError`` (the manifest says
``bfloat16``, the npz holds ``|V2``).

Meshes. A sharded index (``IVFIndex(pctx=)``) is saved unsharded: every
rank gathers the whole state (the store's cells, the centroids and both
statistics over the cells axis; a collective, so every rank calls
``save_index``), rank 0 alone copies it to the host and writes the npz
and the manifest (tmp + rename), and no rank goes on until they are
durable. The file is the one-device twin's, array for array; only the paged
store's meta ``n_shards`` and ``pps`` tell the mesh. ``load_index(pctx=)``
reads the same file on every rank and restores it onto any mesh, or onto
none: the store is rebuilt for the mesh's K-shards and placed
(``store.restore_store(pctx=)``), the router comes back replicated from its
state, never re-trained. A failed write raises on every rank
(``ParallelContext.rank0_write``), so no rank waits for a peer that left.

``clone_index`` is the last-known-good copy the ``HealthPolicy`` ladder
falls back to. The reference round-trips the state through the host; the
port copies each tensor on its device (``copy.deepcopy``, which clones
tensors into new storage), so the clone shares no storage with the live
index and costs no host round trip. On a mesh each rank clones its own
shard on its device; the context, its mesh and its process groups are
shared, never copied.
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
from repro_torch.utils.host import host_array

SNAPSHOT_VERSION = 5
_PREFIX, _SUFFIX = "index_", ".npz"
MANIFEST = "index_manifest.json"


def _state_arrays(index, host: bool = True) -> dict:
    """The full index state under the snapshot's keys (on a K-sharded
    index gathered over the cells axis: every rank calls it), on the host
    unless ``host`` is false (a rank that writes nothing)."""
    out = host_array if host else (lambda t: t)

    def whole(t):   # a per-cell tensor of all K cells
        if not index._k_sharded:
            return t
        return index.pctx.gather(t, (index.pctx.k_axis,))
    arrays = {"centroids": out(index.global_centroids())}
    for prefix, st in (("stats", index.stats), ("pending", index._pending)):
        arrays[f"{prefix}_sums"] = out(whole(st.sums))
        arrays[f"{prefix}_counts"] = out(whole(st.counts))
        arrays[f"{prefix}_inertia"] = out(st.inertia)
    arrays.update(index.store.state_arrays(host))
    arrays.update(index.router.state_arrays())
    return arrays


def _path(directory: str, seqno: int) -> str:
    return os.path.join(directory, f"{_PREFIX}{seqno:08d}{_SUFFIX}")


def save_index(index, directory: str, *, seqno: int = 0,
               extra: dict | None = None) -> str:
    """Snapshot ``index`` into ``directory`` as of WAL position ``seqno``.
    ``extra`` (JSON-able) rides in the manifest: the serving engine keeps
    its schedule counters there, so recovery resumes the schedule. On a
    mesh every rank calls it (the gathers); rank 0 alone copies the state
    to the host and writes, no rank returns before the files are in
    place, and a failed write raises on every rank."""
    pctx = index.pctx
    writes = pctx is None or pctx.is_world_rank0
    host = _state_arrays(index, host=writes)
    path = _path(directory, seqno)
    if pctx is None:
        _write(index, host, directory, path, seqno, extra)
    else:
        pctx.rank0_write(lambda: _write(index, host, directory, path, seqno,
                                        extra))
    return path


def _write(index, host: dict, directory: str, path: str, seqno: int,
           extra: dict | None) -> None:
    """The npz, then the manifest, each written to a temporary name and
    renamed into place."""
    os.makedirs(directory, exist_ok=True)
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


def _rebuild(host: dict, meta: dict, *, planner=None, device=None,
             pctx=None):
    """A live ``IVFIndex`` from host state and its manifest meta, on
    ``pctx``'s mesh when given (ref. l.128-145: the store restored for
    ``n_shards = pctx.n_k_shards`` and placed on this rank's cells)."""
    from repro_torch.index.ivf import IVFIndex   # lazy: an import cycle
    centroids = np.asarray(host["centroids"])
    k, d = centroids.shape
    if pctx is not None:
        device = pctx.device
    store = _store.restore_store(host, meta["store"], k=k, d=d,
                                 dtype=torch.float32, device=device,
                                 pctx=pctx)
    if store.kind != meta["store"].get("kind", "padded"):
        raise ValueError(f"store kind drifted: {store.kind!r} restored, "
                         f"{meta['store'].get('kind')!r} recorded")
    # the router comes back from its state, never re-trained
    router = _router.restore_router(meta.get("router"), host,
                                    planner=planner, device=store.device)
    index = IVFIndex(centroids, capacity=store.capacity, device=store.device,
                     planner=planner, store=store, router=router, pctx=pctx)
    index.n_total = int(meta["n_total"])
    index.stats = _owned(index, _stats(host, "stats", index.device))
    index._pending = _owned(index, _stats(host, "pending", index.device))
    return index


def _owned(index, st: SufficientStats) -> SufficientStats:
    """``st`` of all K cells cut to the cells ``index`` owns."""
    if not index._k_sharded:
        return st
    pctx = index.pctx
    return SufficientStats(pctx.shard_centroids(st.sums),
                           pctx.put(st.counts, (pctx.k_axis,)), st.inertia)


def load_index(directory: str, *, seqno: int | None = None, planner=None,
               device=None, pctx=None):
    """Restore a snapshot (the latest, or a given ``seqno``) onto
    ``device`` (None: ``"cuda"``), or onto the mesh of ``pctx`` (every rank
    calls it; the snapshot may come from any mesh or from none). Where the
    manifest covers the seqno, the arrays are validated against its
    shape/dtype records first; an older snapshot takes its scalars from
    the array shapes (``store.infer_store_meta``), as in the reference."""
    if seqno is None:
        seqno = latest_snapshot_seqno(directory)
        if seqno is None:
            raise FileNotFoundError(f"no index snapshot in {directory}")
    manifest = read_manifest(directory)
    with np.load(_path(directory, seqno)) as data:
        host = {k: data[k] for k in data.files}
    if manifest.get("seqno") == seqno:
        validate_arrays(manifest["arrays"], host,
                        context=f"load_index(seqno {seqno})")
        meta = manifest
        if "store" not in meta:   # pre-paged (version 1) manifest
            meta = dict(meta, store=_store.infer_store_meta(host, meta))
    else:   # older snapshot than the manifest covers: scalars from shapes
        meta = {"n_total": int(host["counts"].sum()),
                "store": _store.infer_store_meta(host, {})}
    return _rebuild(host, meta, planner=planner, device=device, pctx=pctx)


def clone_index(index, *, planner=None):
    """The last-known-good copy: every tensor of the store (its device
    rescore cache included), the router, the centroids and both statistics
    cloned on its device, the host reservoir and host mirrors copied; no
    storage shared with ``index`` and no fault injector attached. On a
    mesh each rank clones its own shard (the centroids are gathered, a
    collective: every rank calls it) and the clone carries ``index.pctx``;
    the context, its mesh and its process groups are shared, not copied."""
    from repro_torch.index.ivf import IVFIndex   # lazy: an import cycle
    planner = planner if planner is not None else index.planner
    memo = {id(index.planner): index.planner, id(planner): planner}
    rt = getattr(index.router, "planner", None)
    if rt is not None:
        memo[id(rt)] = rt
    pctx = index.pctx
    if pctx is not None:   # never deep-copy a process group
        memo[id(pctx)] = pctx
        memo[id(pctx.mesh)] = pctx.mesh
    store = copy.deepcopy(index.store, memo)
    router = copy.deepcopy(index.router, memo)
    clone = IVFIndex(index.global_centroids().clone(), store.capacity,
                     device=index.device, planner=planner,
                     rescore_mult=("auto" if index.rescore_mult is None
                                   else index.rescore_mult),
                     store=store, router=router, pctx=pctx)
    clone.n_total = index.n_total
    clone.stats = SufficientStats(*(t.clone() for t in index.stats))
    clone._pending = SufficientStats(*(t.clone() for t in index._pending))
    clone._search_plans = dict(index._search_plans)
    return clone
