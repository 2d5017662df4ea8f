"""Carry a k-means state between the JAX package and the port, as numpy.

A JAX ``KMeansState`` handed over as a dict of numpy arrays (``centroids``,
``assignments``, ``inertia``, ``iteration``, ``shift``) becomes the port's
``KMeansState`` and back; a ``StreamingKMeans``'s state (``STREAM_FIELDS``:
the centroids, the running statistics' sums, counts and inertia, and
``n_batches``) likewise, so one stream can go on in the other package (the
two bootstraps draw from different generators). Neither package is
imported here: the JAX side converts with ``np.asarray``. bfloat16 arrays
(numpy's ``bfloat16`` extension type, as JAX hands them over) are
reinterpreted bit for bit; ``state_to_numpy`` widens bfloat16 to float32,
which is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kmeans import KMeansState

FIELDS = KMeansState._fields
STREAM_FIELDS = ("centroids", "sums", "counts", "inertia", "n_batches")


def _to_tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: JAX hands over read-only views
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def state_from_numpy(d: dict, device) -> KMeansState:
    """Build the port's state from numpy arrays keyed by field name."""
    missing = [f for f in FIELDS if f not in d]
    if missing:
        raise KeyError(f"state_from_numpy: missing fields {missing}")
    return KMeansState(
        centroids=_to_tensor(d["centroids"], device),
        assignments=_to_tensor(d["assignments"], device).to(torch.int32),
        inertia=_to_tensor(d["inertia"], device).to(torch.float32),
        iteration=_to_tensor(d["iteration"], device).to(torch.int32),
        shift=_to_tensor(d["shift"], device).to(torch.float32))


def state_to_numpy(state: KMeansState) -> dict[str, np.ndarray]:
    """The port's state as host numpy arrays (bfloat16 widened to f32)."""
    out = {}
    for name, t in zip(FIELDS, state):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy()
    return out


def stream_to_numpy(sk) -> dict:
    """A bootstrapped ``StreamingKMeans``'s state as host numpy arrays."""
    if sk.centroids is None:
        raise ValueError("stream_to_numpy: the stream has no centroids yet")
    out = {"centroids": sk.centroids, "sums": sk.stats.sums,
           "counts": sk.stats.counts, "inertia": sk.stats.inertia}
    out = {k: v.detach().float().cpu().numpy() if v.dtype == torch.bfloat16
           else v.detach().cpu().numpy() for k, v in out.items()}
    out["n_batches"] = np.asarray(sk.n_batches)
    return out


def stream_from_numpy(sk, d: dict):
    """Load ``d`` (``STREAM_FIELDS``) into ``sk``, a ``StreamingKMeans``
    made with the stream's config, on its device; an init buffer it held
    is dropped. Returns ``sk``."""
    from repro_torch.core.streaming import SufficientStats
    missing = [f for f in STREAM_FIELDS if f not in d]
    if missing:
        raise KeyError(f"stream_from_numpy: missing fields {missing}")
    dev = sk.device
    c = _to_tensor(d["centroids"], dev)
    sk.centroids = c if sk.cfg.dtype is None else c.to(sk.cfg.dtype)
    sk.stats = SufficientStats(
        *(_to_tensor(d[f], dev).to(torch.float32)
          for f in ("sums", "counts", "inertia")))
    sk.n_batches = int(d["n_batches"])
    sk._init_buf, sk._pending = [], None
    return sk
