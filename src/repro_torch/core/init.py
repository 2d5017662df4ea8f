"""Centroid initialization: random subset and k-means++ (exact D² sampling).

Port of ``repro/core/init.py`` on explicit ``torch.Generator``s. The random
numbers differ from ``jax.random``'s, so tests that compare the packages
hand both the same initial centroids.
"""
from __future__ import annotations

import torch


def random_init(x: torch.Tensor, k: int, *,
                generator: torch.Generator) -> torch.Tensor:
    """k distinct data points, uniformly sampled."""
    n = x.shape[0]
    if k > n:
        raise ValueError(
            f"random_init needs at least k data points to draw k distinct "
            f"centroids, got k={k} > n={n}")
    idx = torch.randperm(n, generator=generator, device=generator.device)[:k]
    return x.index_select(0, idx.to(x.device))


def kmeans_plus_plus(x: torch.Tensor, k: int, *,
                     generator: torch.Generator) -> torch.Tensor:
    """Exact k-means++ (Arthur & Vassilvitskii): each next centroid is drawn
    with probability proportional to its squared distance to the closest
    already-chosen centroid. O(NKd) total."""
    n, d = x.shape
    gdev = generator.device
    x32 = x.float()
    xsq = (x32 * x32).sum(-1)

    def dist_to(c: torch.Tensor) -> torch.Tensor:
        return torch.clamp(xsq + (c * c).sum() - 2.0 * (x32 @ c), min=0.0)

    first = int(torch.randint(0, n, (1,), generator=generator, device=gdev))
    cents = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    cents[0] = x32[first]
    min_d = dist_to(cents[0])
    for i in range(1, k):
        # Gumbel-max draw proportional to min_d. When every min_d is zero
        # (all points coincide with chosen centroids) the D² distribution
        # is degenerate: fall back to a uniform draw instead of always
        # picking row 0.
        u = torch.rand(n, generator=generator, device=gdev).to(x.device)
        gumbel = -torch.log(-torch.log(u))
        pos = min_d > 0
        logits = torch.where(pos, torch.log(torch.where(pos, min_d, 1.0)),
                             float("-inf"))
        logits = torch.where(pos.any(), logits, torch.zeros_like(logits))
        idx = torch.argmax(logits + gumbel)
        cents[i] = x32[idx]
        min_d = torch.minimum(min_d, dist_to(cents[i]))
    return cents.to(x.dtype)


def init_centroids(x: torch.Tensor, k: int, method: str, *,
                   generator: torch.Generator) -> torch.Tensor:
    if method == "random":
        return random_init(x, k, generator=generator)
    if method in ("kmeans++", "k-means++", "plusplus"):
        return kmeans_plus_plus(x, k, generator=generator)
    raise ValueError(f"unknown init method {method!r}")
