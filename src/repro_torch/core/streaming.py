"""Streaming / mini-batch k-means on the port's kernels.

Port of ``repro/core/streaming.py``. One Lloyd iteration factors through
small **sufficient statistics** — per-cluster point sums, counts and the
batch inertia — which are associative under addition and closed under
exponential down-weighting. ``SufficientStats`` is that reduction type,
shared by the drivers:

- ``ChunkedKMeans`` (``core.chunked``): out-of-core chunks reduce to one
  ``SufficientStats`` per iteration, an exact full-batch Lloyd step;
- ``StreamingKMeans`` (here): the statistics persist across batches with
  an optional decay (online / mini-batch k-means, warm-started, never
  refit);
- ``IVFIndex`` keeps its pending and committed evidence in it.

The per-batch kernel work is ``core.kmeans.lloyd_stats`` — FlashLloyd or
FlashAssign + the sort-inverse update, by ``KMeansConfig.step_impl`` — so
this layer adds no dataflow, only a persistence policy. Batch sizes are
bucketed to powers of two by the ``KernelPlanner``, so a stream of ragged
batches plans only on bucket boundaries (the planner's buckets take the
place of the reference's jit cache; the step runs eagerly).

``partial_fit`` with running stats ``(S, N)``, decay ``gamma`` and a batch
contributing ``(s, n)`` under the current centroids:

    S' = gamma * S + s,   N' = gamma * N + n,   c' = S' / N'

``gamma = 1`` is online k-means (every past point keeps full weight);
``gamma < 1`` an exponentially weighted window for drifting streams.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import kmeans as _km
from repro_torch.core.init import init_centroids
from repro_torch.core.kmeans import KMeansConfig, resolve_device
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
    def from_batch(cls, x: torch.Tensor, c: torch.Tensor, cfg: KMeansConfig,
                   blk=None, mask: torch.Tensor | None = None
                   ) -> tuple["SufficientStats", torch.Tensor]:
        """Assign ``x`` to ``c`` and reduce. Returns (stats, assignments).

        Goes through ``lloyd_stats`` (fused or two-pass by
        ``cfg.step_impl``). ``mask`` (N,) bool keeps rows out of the
        statistics (their assignments are still returned): masked rows go
        to a dummy segment ``k`` that is sliced off. The fused step cannot
        skip rows, so the masked path is always two-pass.
        """
        if mask is None:
            a, s, cnt, j = _km.lloyd_stats(x, c, cfg, blk)
            return cls(s, cnt, j.float()), a
        if blk is None:
            blk = cfg.blocks_for(x.shape[0], x.shape[1], x.element_size(),
                                 x.device)
        a, m = _km._assign(x.unsqueeze(0), c.unsqueeze(0), cfg, blk)
        a, m = a[0], m[0]
        a_eff = torch.where(mask, a, cfg.k).to(torch.int32)
        s, cnt = ops.centroid_stats(
            x, a_eff, k=cfg.k + 1, impl=cfg.stats_only_update_impl(),
            block_n=blk.update_block_n, block_k=blk.update_block_k)
        j = torch.where(mask, m, 0.0).sum()
        return cls(s[:cfg.k], cnt[:cfg.k], j), a

    @classmethod
    def from_centroids(cls, c: torch.Tensor, counts: torch.Tensor
                       ) -> "SufficientStats":
        """``sums = c * n``: the lossless inverse of ``finalize`` for
        these counts. Takes (K, d) and (K,), or a batch (P, K, d) and (P,
        K) (then ``inertia`` is (P,))."""
        counts = counts.float()
        return cls(c.float() * counts.unsqueeze(-1), counts,
                   torch.zeros(counts.shape[:-1], dtype=torch.float32,
                               device=c.device))

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


def partial_fit_step(x: torch.Tensor, c: torch.Tensor,
                     stats: SufficientStats, *, cfg: KMeansConfig,
                     decay: float = 1.0, local_iters: int = 1,
                     mask: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, SufficientStats, torch.Tensor,
                                torch.Tensor]:
    """One decayed mini-batch Lloyd update, warm-started at ``c``.

    Past evidence is decayed once per call; the batch is re-assigned
    ``local_iters`` times against the tentatively updated centroids, and
    only the last batch's statistics are committed (no double counting).
    ``mask`` (N,) bool keeps rows out of the statistics. Returns ``(c_new,
    stats_new, assignments, batch_inertia)``; reads nothing back to the
    host.
    """
    base = stats.scale(decay)
    merged, a, batch = base, None, None
    for _ in range(max(1, local_iters)):
        batch, a = SufficientStats.from_batch(x, c, cfg, mask=mask)
        merged = base.merge(batch)
        c = merged.finalize(c)
    return c, merged, a, batch.inertia


def _batch_stats(x: torch.Tensor, c: torch.Tensor, cfg: KMeansConfig,
                 mask: torch.Tensor | None
                 ) -> tuple[SufficientStats, torch.Tensor]:
    """``SufficientStats.from_batch`` over P problems at once: x (P, N,
    d), c (P, K, d), mask (P, N) bool or None. Every field gains the
    leading P axis; one launch a kernel for all P."""
    if mask is None:
        a, s, cnt, j = _km._stats_batched(x, c, cfg, None)
        return SufficientStats(s, cnt, j.float()), a
    k = cfg.k
    blk = cfg.blocks_for(x.shape[1], x.shape[2], x.element_size(), x.device)
    a, m = _km._assign(x, c, cfg, blk)
    a_eff = torch.where(mask, a, k).to(torch.int32)
    s, cnt = ops.centroid_stats_batched(
        x, a_eff, k=k + 1, impl=cfg.stats_only_update_impl(),
        block_n=blk.update_block_n, block_k=blk.update_block_k)
    j = torch.where(mask, m, 0.0).sum(-1)
    return SufficientStats(s[:, :k], cnt[:, :k], j), a


def partial_fit_step_batched(x: torch.Tensor, c: torch.Tensor,
                             stats: SufficientStats, *, cfg: KMeansConfig,
                             decay: float = 1.0, local_iters: int = 1,
                             mask: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, SufficientStats,
                                        torch.Tensor, torch.Tensor]:
    """``partial_fit_step`` of P independent problems in one pass a local
    iteration: x (P, N, d), c (P, K, d), ``stats`` with a leading P axis
    (``SufficientStats.from_centroids`` of (P, K, d) and (P, K)), mask (P,
    N) bool. The statistics come from the batched assignment and update
    (``core.kmeans._stats_batched``; with a mask, the two-pass path with
    the masked rows in a dummy segment), so each kernel launches once a
    local iteration for all P. Returns ``(c_new (P, K, d), stats_new,
    assignments (P, N), batch_inertia (P,))``; reads nothing back to the
    host."""
    base = stats.scale(decay)
    merged, a, batch = base, None, None
    for _ in range(max(1, local_iters)):
        batch, a = _batch_stats(x, c, cfg, mask)
        merged = base.merge(batch)
        c = merged.finalize(c)
    return c, merged, a, batch.inertia


class StreamingKMeans:
    """Online / mini-batch exact-assignment k-means (warm start, no refit).

    >>> sk = StreamingKMeans(KMeansConfig(k=64), decay=0.95)   # on "cuda"
    >>> for batch in stream:                     # (B_i, d) host or device
    ...     sk.partial_fit(batch)                # decayed mini-batch Lloyd
    >>> sk.update(x_new)                         # append-only refinement
    >>> a = sk.predict(x)

    State between calls: the centroids (K, d) and the running
    ``SufficientStats``, O(K d) on the device however long the stream.
    Each ``partial_fit`` costs one ``lloyd_stats`` pass over the batch per
    local iteration. The centroids are drawn with ``cfg.init`` from the
    first batch — or, with ``init_size=m``, from the first ``m`` buffered
    points, which are then folded into the statistics as one batch, so
    every point counts once. The draw uses a ``torch.Generator`` seeded
    with ``seed`` (other numbers than the reference's ``jax.random``); a
    warm ``partial_fit`` or ``update`` makes no host sync.

    ``device=None`` means ``"cuda"`` (raises without a CUDA device), or
    with ``pctx`` the mesh's device.

    ``pctx`` (a ``core.parallel.ParallelContext`` without a ``k_axis``)
    makes ``partial_fit``/``update`` data-parallel: each batch is padded to
    a multiple of the data shards, each rank reduces its rows (the padding
    masked out) and one O(K d) all-reduce a mini-batch merges them;
    centroids and running statistics stay replicated. Every rank feeds the
    same batches.
    """

    def __init__(self, cfg: KMeansConfig, *, decay: float = 1.0,
                 local_iters: int = 1, seed: int = 0,
                 init_size: int | None = None, pctx=None, device=None):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if pctx is not None and pctx.k_axis is not None:
            raise ValueError(
                "StreamingKMeans is data-parallel only; use a "
                "ParallelContext without a k_axis (centroids replicate)")
        self.cfg = cfg
        self.decay = float(decay)
        self.local_iters = int(local_iters)
        self.init_size = init_size
        self.pctx = pctx
        self._steps: dict[tuple, object] = {}   # (decay, iters) -> program
        if pctx is not None and device is None:
            device = pctx.device
        self.device = resolve_device(device)
        self.centroids: torch.Tensor | None = None
        self.stats: SufficientStats | None = None
        self.n_batches = 0
        self.last_batch_inertia: torch.Tensor | None = None
        self._init_buf: list[torch.Tensor] = []
        self._pending: torch.Tensor | None = None
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _cast(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.device)
        return x if self.cfg.dtype is None else x.to(self.cfg.dtype)

    def _bootstrap(self, batch: torch.Tensor) -> bool:
        """Draw the centroids; False while still buffering. The buffered
        row count is host-side (shapes), so buffering reads no device."""
        if self.init_size is not None:
            self._init_buf.append(batch)
            if sum(b.shape[0] for b in self._init_buf) < self.init_size:
                return False
            batch = torch.cat(self._init_buf, dim=0)
            self._init_buf = []
        self.centroids = init_centroids(batch, self.cfg.k, self.cfg.init,
                                        generator=self._gen)
        self.stats = SufficientStats.zero(self.cfg.k, batch.shape[1],
                                          self.device)
        self._pending = batch
        return True

    def _step(self, batch: torch.Tensor, decay: float, local_iters: int):
        """One step on one device, or through the mesh's program."""
        if self.pctx is None:
            return partial_fit_step(batch, self.centroids, self.stats,
                                    cfg=self.cfg, decay=decay,
                                    local_iters=local_iters)
        prog = self._steps.get((decay, local_iters))
        if prog is None:
            prog = self.pctx.make_partial_fit(self.cfg, decay=decay,
                                              local_iters=local_iters)
            self._steps[(decay, local_iters)] = prog
        x_pad, mask, n = self.pctx.pad_points(batch)
        c, s, cnt, j, a, bj = prog(x_pad, mask if x_pad.shape[0] != n
                                   else None, self.centroids, *self.stats)
        return c, SufficientStats(s, cnt, j), a[:n], bj

    def partial_fit(self, batch) -> "StreamingKMeans":
        """Fold one mini-batch into the model (decayed warm-start step)."""
        batch = self._cast(batch)
        self.n_batches += 1
        if self.centroids is None:
            if not self._bootstrap(batch):
                return self
            batch, self._pending = self._pending, None
        self.centroids, self.stats, _, self.last_batch_inertia = \
            self._step(batch, self.decay, self.local_iters)
        return self

    def update(self, x_new) -> torch.Tensor:
        """Append-only refinement: new points join at full weight (no
        decay of history). Returns their assignments (of the whole init
        buffer if this call completes the bootstrap)."""
        x_new = self._cast(x_new)
        if self.centroids is None:
            buffered = sum(b.shape[0] for b in self._init_buf)
            if (self.init_size is not None
                    and buffered + x_new.shape[0] < self.init_size):
                # refuse before buffering: a caught-and-retried batch must
                # not be counted twice
                raise ValueError(
                    "update() needs initialized centroids; still buffering "
                    f"init points ({buffered + x_new.shape[0]} of "
                    f"{self.init_size}) — feed more data or use "
                    "partial_fit for the warm-up phase")
            self._bootstrap(x_new)
            x_new, self._pending = self._pending, None
        self.centroids, self.stats, a, self.last_batch_inertia = \
            self._step(x_new, 1.0, 1)
        self.n_batches += 1
        return a

    def _assign(self, x, who: str, want_dists: bool = True):
        if self.centroids is None:
            raise ValueError(f"{who}() before any partial_fit/update")
        x = self._cast(x)
        blk = self.cfg.blocks_for(x.shape[0], x.shape[1], x.element_size(),
                                  x.device)
        a, m = _km._assign(x.unsqueeze(0),
                           self.centroids.to(x.dtype).unsqueeze(0),
                           self.cfg, blk, want_dists=want_dists)
        return a[0], m[0]

    def predict(self, x) -> torch.Tensor:
        """The ids alone: FlashAssign returns no distances here."""
        return self._assign(x, "predict", want_dists=False)[0]

    def inertia(self, x) -> float:
        """Full-batch inertia of ``x`` under the live centroids."""
        return float(self._assign(x, "inertia")[1].sum())
