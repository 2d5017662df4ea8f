"""Arrays on the host as the reference's files hold them.

The checkpointer, the index stores' snapshots, the WAL and the snapshot
writer turn tensors into numpy with ``host_array``. numpy has no bfloat16
without ``ml_dtypes``, whose arrays ``np.savez`` stores as 2-byte void
records (``|V2``), so a bfloat16 tensor's bits go out as those same records,
and ``written_dtype`` names such an array ``bfloat16`` in a manifest, as the
reference's manifests name their own.
"""
from __future__ import annotations

import numpy as np
import torch


def dtype_name(v) -> str:
    """A leaf's dtype as numpy names it (``torch.float32`` -> ``float32``)."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).rsplit(".", 1)[1]
    return str(v.dtype if hasattr(v, "dtype") else np.asarray(v).dtype)


def host_array(v) -> np.ndarray:
    """A leaf on the host as numpy: a bfloat16 tensor as the reference's
    files hold one, its bits as 2-byte void records (``|V2``)."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).cpu().numpy().view("V2")
        return v.cpu().numpy()
    return np.asarray(v)


def written_dtype(v) -> str:
    """The manifest's dtype of a written array: a ``|V2`` array is a
    bfloat16 tensor's records (``host_array``), named ``bfloat16``."""
    if isinstance(v, np.ndarray) and v.dtype == np.dtype("V2"):
        return "bfloat16"
    return dtype_name(v)
