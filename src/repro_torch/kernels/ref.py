"""Plain PyTorch reference oracles for the flash-kmeans kernels.

Ports of ``repro/kernels/ref.py``, the *standard* (paper Algorithm 1)
dataflow:

- ``assign_ref`` materializes the full ``N x K`` distance matrix, then
  reduces it row-wise;
- ``update_scatter_ref`` adds point by point into the cluster rows (the
  atomic-contention baseline);
- ``update_dense_onehot_ref`` computes ``S = A_onehot^T X``, contention
  free but ``O(N K d)`` flops;
- ``probe_ref`` materializes the ``N x K`` scores and sorts each row
  (the FlashProbe oracle).

They are the oracles of the tests and the reference implementations
behind ``assign_impl="ref"`` and ``update_impl="scatter"/"dense_onehot"``.
Every function takes 2-D inputs; ``pairwise_sq_dists`` and the assign
oracles also take a leading batch dimension.
"""
from __future__ import annotations

import torch


def pairwise_sq_dists(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Materialized ``N x K`` squared distances (f32), expanded form
    ``||x||^2 + ||c||^2 - 2 x.c``."""
    x32, c32 = x.float(), c.float()
    xsq = (x32 * x32).sum(-1, keepdim=True)
    csq = (c32 * c32).sum(-1)
    cross = torch.matmul(x32, c32.transpose(-1, -2))
    return xsq + csq.unsqueeze(-2) - 2.0 * cross


def _argmin_rows(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    a = torch.argmin(d, dim=-1)  # first occurrence on ties, as jnp.argmin
    m = torch.gather(d, -1, a.unsqueeze(-1)).squeeze(-1)
    return a.to(torch.int32), m


def assign_ref(x: torch.Tensor, c: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Standard assignment: ``(assignments int32 (N,), min_sq_dist f32
    (N,))``."""
    return _argmin_rows(pairwise_sq_dists(x, c))


def assign_ref_crossterm(x: torch.Tensor, c: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Assignment on the x-norm-free score ``||c||^2 - 2 x.c`` (the
    kernels' on-chip form); the returned minimum excludes ``||x||^2``."""
    c32 = c.float()
    csq = (c32 * c32).sum(-1)
    score = csq.unsqueeze(-2) - 2.0 * torch.matmul(x.float(),
                                                   c32.transpose(-1, -2))
    return _argmin_rows(score)


def probe_ref(q: torch.Tensor, c: torch.Tensor, l: int, *,
              want_dists: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense top-L oracle of FlashProbe: the full score matrix in the
    kernel's form ``||c||^2 - 2 q.c``, then a *stable* ascending sort, so
    equal scores keep the lower index first (``lax.top_k``'s order;
    ``torch.topk`` leaves it unspecified). Returns ``(indices int32 (N, l),
    values f32 (N, l))``; with ``want_dists`` the per-query ``||q||^2`` is
    added back and the result clamped at 0."""
    c32 = c.float()
    csq = (c32 * c32).sum(-1)
    score = csq.unsqueeze(0) - 2.0 * torch.matmul(q.float(), c32.t())
    v, idx = torch.sort(score, dim=-1, stable=True)
    idx, v = idx[:, :l].to(torch.int32), v[:, :l]
    if not want_dists:
        return idx, v
    q32 = q.float()
    return idx, torch.clamp(v + (q32 * q32).sum(-1, keepdim=True), min=0.0)


def update_scatter_ref(x: torch.Tensor, a: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter-style statistics: ``(sums f32 (K, d), counts f32 (K,))``."""
    ids = a.long()
    s = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    s.index_add_(0, ids, x.float())
    cnt = torch.zeros((k,), dtype=torch.float32, device=x.device)
    cnt.index_add_(0, ids, torch.ones_like(ids, dtype=torch.float32))
    return s, cnt


def update_dense_onehot_ref(x: torch.Tensor, a: torch.Tensor, k: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense one-hot matmul statistics ``S = A^T X``."""
    oh = (a.long().unsqueeze(1)
          == torch.arange(k, device=a.device).unsqueeze(0)).float()
    return oh.transpose(0, 1) @ x.float(), oh.sum(0)


def lloyd_stats_ref(x: torch.Tensor, c: torch.Tensor):
    """Oracle of the fused pass: ``(a int32 (N,), sums f32 (K, d),
    counts f32 (K,), inertia f32 ())``."""
    a, m = assign_ref(x, c)
    s, cnt = update_dense_onehot_ref(x, a, c.shape[0])
    return a, s, cnt, m.sum()


def centroid_update_ref(x: torch.Tensor, a: torch.Tensor,
                        c_prev: torch.Tensor) -> torch.Tensor:
    """Reference centroid update with empty-cluster fallback. Clamps the
    divisor to ``max(cnt, 1)`` as the JAX oracle does; the pipeline's
    ``ops.finalize_centroids`` divides by any ``cnt > 0`` instead."""
    s, cnt = update_scatter_ref(x, a, c_prev.shape[0])
    new_c = s / torch.clamp(cnt, min=1.0).unsqueeze(1)
    return torch.where((cnt > 0).unsqueeze(1), new_c,
                       c_prev.float()).to(c_prev.dtype)
