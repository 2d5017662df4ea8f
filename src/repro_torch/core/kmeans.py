"""flash-kmeans public API on PyTorch: exact Lloyd iterations on the
port's CUDA kernels.

Port of ``repro/core/kmeans.py``. ``KMeans`` is the composable module:
configure once, then ``fit`` (the Lloyd loop to ``tol`` or ``max_iters``),
``iterate`` (one step — the online primitive), ``predict``, or
``fit_batched`` (B independent problems, one kernel launch per step over
the whole batch). The math is Lloyd's algorithm exactly; only the dataflow
differs by ``assign_impl`` / ``update_impl`` / ``step_impl``.

``KMeans`` runs on the card unless it is asked for the CPU: ``device=None``
means ``"cuda"`` and raises when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import plan as _plan
from repro_torch.core.init import init_centroids
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import BlockConfig


@dataclasses.dataclass(frozen=True)
class KMeansConfig:
    k: int
    max_iters: int = 25
    tol: float = 0.0                  # centroid-shift^2 tolerance (0 = run all iters)
    init: str = "random"              # random | kmeans++
    assign_impl: str = "flash"        # flash | ref
    update_impl: str = "sort_inverse" # sort_inverse | scatter | dense_onehot | fused
    step_impl: str = "auto"           # auto | fused | two_pass
    block: BlockConfig | None = None  # None -> KernelPlanner plan
    dtype: torch.dtype | None = None  # compute dtype override for x/c
    # planning layer override (None -> the device's default planner)
    planner: "_plan.KernelPlanner | None" = dataclasses.field(
        default=None, compare=False, repr=False)

    def _planner(self, device=None) -> "_plan.KernelPlanner":
        return self.planner if self.planner is not None \
            else _plan.default_planner(device)

    def blocks_for(self, n: int, d: int, dtype_bytes: int,
                   device=None) -> BlockConfig:
        if self.block is not None:
            return self.block
        return self._planner(device).block_config(n, self.k, d, dtype_bytes)

    def resolved_step_impl(self, n: int, d: int, dtype_bytes: int,
                           blk: BlockConfig | None = None,
                           device=None) -> str:
        """'fused' (single FlashLloyd pass) or 'two_pass' (assign+update).

        ``step_impl="auto"`` applies the planner's shared-memory + roofline
        crossover rule at the block shapes that will be launched, but only
        on the flash + sort_inverse fast path; explicitly requested
        reference impls are honoured. ``update_impl="fused"`` is an alias
        for ``step_impl="fused"``; either spelling combined with
        ``step_impl="two_pass"``, a non-flash ``assign_impl`` or a
        reference ``update_impl`` is contradictory and raises.
        """
        if self.update_impl == "fused" or self.step_impl == "fused":
            if self.step_impl == "two_pass":
                raise ValueError(
                    "update_impl='fused' contradicts step_impl='two_pass'")
            if self.assign_impl != "flash":
                raise ValueError(
                    "the fused step subsumes the assignment; it cannot "
                    f"be combined with assign_impl={self.assign_impl!r}")
            if self.update_impl not in ("fused", "sort_inverse"):
                raise ValueError(
                    "step_impl='fused' contradicts "
                    f"update_impl={self.update_impl!r}")
            return "fused"
        if self.step_impl == "two_pass":
            return "two_pass"
        if self.step_impl != "auto":
            raise ValueError(f"unknown step impl {self.step_impl!r}")
        if self.assign_impl != "flash" or self.update_impl != "sort_inverse":
            return "two_pass"
        return self._planner(device).step_impl(
            n, self.k, d, dtype_bytes,
            blk=blk if blk is not None else self.block)

    def stats_only_update_impl(self) -> str:
        """Update impl for a stats-only pass over *given* assignments: the
        fused step has no stats-only form, so it maps to sort_inverse."""
        if self.update_impl == "fused" or self.step_impl == "fused":
            return "sort_inverse"
        return self.update_impl


class KMeansState(NamedTuple):
    centroids: torch.Tensor    # (K, d), or (B, K, d) from fit_batched
    assignments: torch.Tensor  # (N,) int32
    inertia: torch.Tensor      # () f32 — sum of min squared distances
    iteration: torch.Tensor    # () int32
    shift: torch.Tensor        # () f32 — squared centroid movement of last step


def _assign(x: torch.Tensor, c: torch.Tensor, cfg: KMeansConfig,
            blk: BlockConfig, want_dists: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched assignment: x (B, N, d), c (B, K, d)."""
    if cfg.assign_impl == "flash":
        return ops.flash_assign_batched(x, c, block_n=blk.assign_block_n,
                                        block_k=blk.assign_block_k,
                                        want_dists=want_dists)
    if cfg.assign_impl == "ref":
        return ref.assign_ref(x, c)
    raise ValueError(f"unknown assign impl {cfg.assign_impl!r}")


def _stats_batched(x: torch.Tensor, c: torch.Tensor, cfg: KMeansConfig,
                   blk: BlockConfig | None):
    """(a (B, N), sums (B, K, d), counts (B, K), inertia (B,))."""
    n, d = x.shape[1], x.shape[2]
    if blk is None:
        blk = cfg.blocks_for(n, d, x.element_size(), x.device)
    impl = cfg.resolved_step_impl(n, d, x.element_size(), blk=blk,
                                  device=x.device)
    if impl == "fused":
        return ops.flash_lloyd_step_batched(
            x, c, block_n=blk.fused_block_n, block_k=blk.fused_block_k)
    a, m = _assign(x, c, cfg, blk)
    s, cnt = ops.centroid_stats_batched(
        x, a, k=cfg.k, impl=cfg.update_impl, block_n=blk.update_block_n,
        block_k=blk.update_block_k)
    return a, s, cnt, m.sum(-1)


def lloyd_stats(x: torch.Tensor, c: torch.Tensor, cfg: KMeansConfig,
                blk: BlockConfig | None = None):
    """One iteration's sufficient statistics: (a, sums, counts, inertia).

    Dispatches between the fused FlashLloyd kernel (one read of ``x``) and
    the two-pass assign + update pipeline by ``cfg.resolved_step_impl`` —
    identical math either way, only the dataflow differs.
    """
    a, s, cnt, j = _stats_batched(x.unsqueeze(0), c.unsqueeze(0), cfg, blk)
    return a[0], s[0], cnt[0], j[0]


def lloyd_step(x: torch.Tensor, c: torch.Tensor, cfg: KMeansConfig,
               blk: BlockConfig | None = None):
    """One exact Lloyd iteration. Returns (c_new, assignments, inertia)."""
    a, s, cnt, inertia = lloyd_stats(x, c, cfg, blk)
    return ops.finalize_centroids(s, cnt, c), a, inertia


def _lloyd_loop(x: torch.Tensor, c0: torch.Tensor, cfg: KMeansConfig
                ) -> KMeansState:
    """The Lloyd loop over a batch x (B, N, d) from c0 (B, K, d).

    Each problem runs while ``iteration < max_iters and shift > tol``
    (``shift`` starts at inf), as the JAX ``while_loop`` (and its vmap)
    does: every step computes all B problems in one launch per kernel and
    keeps the new state only where the problem is still running. The
    inertia is the one taken at the pre-update centroids. The loop reads
    one flag from the device per iteration to decide whether to go on.
    """
    b, n, d = x.shape
    dev = x.device
    blk = cfg.blocks_for(n, d, x.element_size(), dev)
    c = c0
    a = torch.zeros((b, n), dtype=torch.int32, device=dev)
    inertia = torch.full((b,), float("inf"), device=dev)
    iteration = torch.zeros((b,), dtype=torch.int32, device=dev)
    shift = torch.full((b,), float("inf"), device=dev)
    while True:
        active = (iteration < cfg.max_iters) & (shift > cfg.tol)
        if not bool(active.any()):  # the one host read per iteration
            break
        a_new, s, cnt, j = _stats_batched(x, c, cfg, blk)
        c_new = ops.finalize_centroids(s, cnt, c)
        sh = ((c_new.float() - c.float()) ** 2).sum((1, 2))
        c = torch.where(active[:, None, None], c_new, c)
        a = torch.where(active[:, None], a_new, a)
        inertia = torch.where(active, j, inertia)
        shift = torch.where(active, sh, shift)
        iteration = iteration + active.to(torch.int32)
    return KMeansState(c, a, inertia, iteration, shift)


def _default_generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def make_kmeans_fn(cfg: KMeansConfig):
    """Build ``fit(x, *, generator=None, c0=None) -> KMeansState`` for a
    fixed config. ``c0`` gives the initial centroids; otherwise
    ``cfg.init`` draws them with ``generator`` (seed 0 if ``None``)."""

    def fit(x: torch.Tensor, *, generator: torch.Generator | None = None,
            c0: torch.Tensor | None = None) -> KMeansState:
        if cfg.dtype is not None:
            x = x.to(cfg.dtype)
        if c0 is None:
            g = generator if generator is not None \
                else _default_generator(x.device)
            c0 = init_centroids(x, cfg.k, cfg.init, generator=g)
        c0 = c0.to(device=x.device, dtype=x.dtype)
        st = _lloyd_loop(x.unsqueeze(0), c0.unsqueeze(0), cfg)
        return KMeansState(*(t[0] for t in st))

    return fit


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``"cuda"``; a CUDA device without CUDA raises (the
    entry points never fall back to the CPU on their own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch's entry points (KMeans, IVFIndex) run on a CUDA "
            "device by default and none is available; pass device='cpu' to "
            "run the plain PyTorch versions on the CPU")
    return dev


class KMeans:
    """Composable exact k-means module (the paper's contribution as an op).

    >>> km = KMeans(KMeansConfig(k=64, max_iters=10))       # on "cuda"
    >>> state = km.fit(x)                                     # (N, d)
    >>> states = km.fit_batched(xb)                           # (B, N, d)
    >>> c1, a, j = km.iterate(x, c0)                          # one step
    """

    def __init__(self, cfg: KMeansConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._fit = make_kmeans_fn(cfg)

    def _cast(self, x: torch.Tensor) -> torch.Tensor:
        """Move to the module's device and apply ``cfg.dtype`` exactly as
        ``fit`` does, so every entry point computes in one precision."""
        x = x.to(self.device)
        return x if self.cfg.dtype is None else x.to(self.cfg.dtype)

    def fit(self, x: torch.Tensor, *, generator: torch.Generator | None = None,
            c0: torch.Tensor | None = None) -> KMeansState:
        return self._fit(self._cast(x), generator=generator,
                         c0=None if c0 is None else c0.to(self.device))

    def fit_batched(self, x: torch.Tensor, *,
                    generator: torch.Generator | None = None,
                    c0: torch.Tensor | None = None) -> KMeansState:
        """B independent problems x (B, N, d); every field of the state
        gains a leading B axis. ``c0`` (B, K, d), else each problem draws
        its own initial centroids from ``generator`` in turn."""
        x = self._cast(x)
        if c0 is None:
            g = generator if generator is not None \
                else _default_generator(x.device)
            c0 = torch.stack([init_centroids(xb, self.cfg.k, self.cfg.init,
                                             generator=g) for xb in x])
        return _lloyd_loop(x, c0.to(device=x.device, dtype=x.dtype),
                           self.cfg)

    def iterate(self, x: torch.Tensor, c: torch.Tensor):
        return lloyd_step(self._cast(x), self._cast(c), self.cfg)

    def iterate_batched(self, x: torch.Tensor, c: torch.Tensor):
        """One step of B problems, x (B, N, d), c (B, K, d): returns
        ``(c_new (B, K, d), a (B, N), inertia (B,))``, one launch per
        kernel."""
        x, c = self._cast(x), self._cast(c)
        a, s, cnt, j = _stats_batched(x, c, self.cfg, None)
        return ops.finalize_centroids(s, cnt, c), a, j

    def predict(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """The ids alone: FlashAssign returns no distances here."""
        x, c = self._cast(x), self._cast(c)
        blk = self.cfg.blocks_for(x.shape[0], x.shape[1], x.element_size(),
                                  x.device)
        return _assign(x.unsqueeze(0), c.unsqueeze(0), self.cfg, blk,
                       want_dists=False)[0][0]
