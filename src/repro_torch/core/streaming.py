"""Sufficient statistics: the one reduction type of the k-means drivers.

Port of ``SufficientStats`` from ``repro/core/streaming.py`` (l.56-159):
per-cluster point sums, counts and the batch inertia, associative under
addition and closed under exponential down-weighting. FlashIVF's ``add``
and ``refresh`` keep their pending and committed evidence in it. The
drivers built on it (``partial_fit_step``, ``StreamingKMeans``) are not
ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops


class SufficientStats(NamedTuple):
    """``sums`` (K, d) f32, ``counts`` (K,) f32, ``inertia`` () f32.

    - ``merge`` is the associative/commutative reduction;
    - ``scale`` decays past evidence (inertia too, so ``inertia /
      counts.sum()`` stays a per-point average);
    - ``finalize`` is the Lloyd M-step with the empty-cluster fallback.
    """

    sums: torch.Tensor     # (K, d) f32
    counts: torch.Tensor   # (K,) f32
    inertia: torch.Tensor  # () f32

    @classmethod
    def zero(cls, k: int, d: int, device=None) -> "SufficientStats":
        return cls(torch.zeros((k, d), dtype=torch.float32, device=device),
                   torch.zeros((k,), dtype=torch.float32, device=device),
                   torch.zeros((), dtype=torch.float32, device=device))

    @classmethod
    def from_centroids(cls, c: torch.Tensor, counts: torch.Tensor
                       ) -> "SufficientStats":
        """``sums = c * n``: the lossless inverse of ``finalize`` for
        these counts."""
        counts = counts.float()
        return cls(c.float() * counts.unsqueeze(1), counts,
                   torch.zeros((), dtype=torch.float32, device=c.device))

    def merge(self, other: "SufficientStats") -> "SufficientStats":
        return SufficientStats(self.sums + other.sums,
                               self.counts + other.counts,
                               self.inertia + other.inertia)

    def scale(self, gamma) -> "SufficientStats":
        return SufficientStats(self.sums * gamma, self.counts * gamma,
                               self.inertia * gamma)

    def sanitize(self) -> tuple["SufficientStats", torch.Tensor]:
        """Zero the rows carrying non-finite or negative evidence. Returns
        ``(clean, bad)`` with ``bad`` a (K,) bool mask of the rows
        dropped; ``finalize`` then keeps those rows' centroids."""
        ok = (torch.isfinite(self.sums).all(dim=1)
              & torch.isfinite(self.counts) & (self.counts >= 0.0))
        zero = torch.zeros((), dtype=torch.float32, device=self.sums.device)
        clean = SufficientStats(
            torch.where(ok.unsqueeze(1), self.sums, zero),
            torch.where(ok, self.counts, zero),
            torch.where(torch.isfinite(self.inertia), self.inertia, zero))
        return clean, ~ok

    def finalize(self, c_prev: torch.Tensor) -> torch.Tensor:
        return ops.finalize_centroids(self.sums, self.counts, c_prev)

    @property
    def weight(self) -> torch.Tensor:
        """Total (decayed) point weight currently represented."""
        return self.counts.sum()
