"""ParallelContext — the one SPMD execution layer of the port.

Port of ``repro/core/parallel.py``. Every multi-rank program of the port
(the distributed Lloyd loop, the data-parallel ``partial_fit``, the sharded
FlashIVF build, add and search) is built here, from four collective
primitives:

- **stats all-reduce** (``psum_stats`` / ``owned_stats``): per-rank
  ``SufficientStats`` are summed over the data axes, O(K d) bytes a round
  whatever N is;
- **two-stage assignment** (``two_stage_assign``): with the centroids split
  over ``k_axis``, each rank takes the argmin over its own K / P_k
  centroids (the same FlashAssign kernel as on one device), then the
  per-rank ``(score, id)`` minima are merged, O(N_local P_k) bytes; ties go
  to the lower global centroid id, as on one device;
- **top-L merge** (``merge_topl``): per-rank ascending lists ``(B, L_loc)``
  are gathered and reduced to the global top-L, O(B L_loc) bytes a rank;
- **logical axes**: meshes name physical axes (``data``/``model``/``pod``);
  k-means programs speak ``"points"`` and ``"cells"``, resolved through
  ``utils.sharding`` by ``ParallelContext.for_mesh``.

The execution model is multi-controller SPMD, PyTorch's idiom, where the
reference is one controller over ``shard_map``: one process a rank, every
rank running the same program on the same global host inputs (made from
the same seed). The mesh is a ``torch.distributed`` ``DeviceMesh`` with
named dims; an axis's collectives run on ``mesh.get_group(axis)`` and
``jax.lax.axis_index(axis)`` is ``mesh.get_local_rank(axis)``. A sum over
several data axes is one ``all_reduce`` a group in turn.

- Placement is slicing, without communication: ``put``, ``shard_points``,
  ``shard_centroids`` and ``replicate`` take this rank's piece of a global
  tensor (a spec names, for each leading dim, the mesh axes it is split
  over, row-major over those axes as in a ``PartitionSpec``). Local pieces
  are plain tensors.
- ``spmd(f, in_specs, out_specs)`` is the only place that turns global
  inputs into local ones and local results back into global ones (an
  all-gather over each split dim's axes). The ``make_*`` methods return
  programs that take and return plain global tensors; data-sharded results
  are gathered, so every rank holds the global result.
- No other module of the port calls a collective: they go through this
  context (``psum``, ``all_gather``, ``gather``).

Backends are explicit (``build_mesh``): on ``"cuda"`` the default is NCCL,
one rank a card; on ``"cpu"`` gloo. Ranks that share one card pass
``backend="gloo"`` themselves (NCCL refuses two ranks on one GPU, an error
that is raised, never caught). Every collective is bounded by the process
group's timeout. The Lloyd loops read one stop flag from the device an
iteration, as ``core.kmeans._lloyd_loop`` does; the flag comes from
all-reduced statistics and centroids, which are the same bits on every
rank, so every rank leaves the loop on the same iteration.
"""
from __future__ import annotations

import datetime
import math
import os
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core import kmeans as _km
from repro_torch.core.kmeans import KMeansConfig
from repro_torch.core.streaming import SufficientStats
from repro_torch.kernels import ops, ref
from repro_torch.optim import compression
from repro_torch.utils import sharding as shu

# seconds before a collective (or the rendezvous) gives up: a rank that
# leaves the program early then fails its peers instead of hanging them
DEFAULT_TIMEOUT_S = 600.0

_owned_world = False   # build_mesh initialized the default process group


def _default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def init_world(device_type: str = "cuda", backend: str | None = None,
               timeout_s: float | None = None) -> None:
    """Initialize the default process group unless one exists: from the
    environment (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``;
    on ``"cuda"`` the rank's card is ``LOCAL_RANK``), else a world of one
    rank. An existing group of another backend than ``backend`` raises."""
    global _owned_world
    if dist.is_initialized():
        if backend is not None and dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                             f"not the requested {backend!r}")
        return
    backend = backend or _default_backend(device_type)
    timeout = datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S)
    env = "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ
    if device_type == "cuda":   # the rank's card, before any communicator
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) if env
                              else torch.cuda.current_device())
    if env:
        dist.init_process_group(backend, timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
    _owned_world = True


def release_world() -> None:
    """Destroy the default process group if ``build_mesh`` made it."""
    global _owned_world
    if _owned_world and dist.is_initialized():
        dist.destroy_process_group()
    _owned_world = False


# ---------------------------------------------------------------------------
# mesh construction — the one helper every launcher builds meshes through
# ---------------------------------------------------------------------------

def build_mesh(shape: Sequence[int], axes: Sequence[str], *,
               device_type: str = "cuda", backend: str | None = None,
               timeout_s: float | None = None):
    """The port's one mesh constructor: a ``DeviceMesh`` of ``shape`` with
    dims named ``axes`` over every rank of the world (initialized by
    ``init_world`` if needed). ``device_type="cuda"`` without CUDA raises,
    as ``core.kmeans.resolve_device`` does; a mesh whose size is not the
    world's raises ``ValueError``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} disagree")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type={device_type!r}: cuda or cpu")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_mesh(device_type='cuda') needs a CUDA device and none is "
            "available; pass device_type='cpu' for a gloo mesh on the CPU")
    init_world(device_type, backend, timeout_s)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, **kw):
    """16x16 (256 ranks) or 2x16x16 ``pod x data x model`` (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return build_mesh(shape, axes, **kw)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device_type: str = "cuda", backend: str | None = None):
    """A small ``data x model`` mesh, clamped to the world's size as the
    reference clamps it to its devices."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh(device_type='cuda') needs a CUDA "
                           "device and none is available")
    init_world(device_type, backend)
    n = dist.get_world_size()
    data = max(1, min(data, n))
    model = max(1, min(model, n // max(data, 1)))
    return build_mesh((data, model), ("data", "model"),
                      device_type=device_type, backend=backend)


def parse_mesh_flag(flag: str, *, device_type: str = "cuda",
                    backend: str | None = None):
    """A ``--mesh`` flag -> mesh: ``"8"`` is 8-way data parallelism,
    ``"2x4"`` 2 data shards x 4 cell shards (axes ``data`` x ``model``)."""
    parts = [int(p) for p in flag.lower().replace("*", "x").split("x")]
    if len(parts) == 1:
        parts = [parts[0], 1]
    if len(parts) != 2 or any(p < 1 for p in parts):
        raise ValueError(f"--mesh expects 'DATA' or 'DATAxCELLS', got {flag!r}")
    return build_mesh(parts, ("data", "model"), device_type=device_type,
                      backend=backend)


class FitResult(tuple):
    """``(centroids, assignments, inertia)`` of a distributed fit, with the
    iterations it ran as ``iterations``."""

    def __new__(cls, centroids, assignments, inertia, iterations: int):
        self = super().__new__(cls, (centroids, assignments, inertia))
        self.iterations = int(iterations)
        return self

    centroids = property(lambda self: self[0])
    assignments = property(lambda self: self[1])
    inertia = property(lambda self: self[2])


# ---------------------------------------------------------------------------
# ParallelContext
# ---------------------------------------------------------------------------

class ParallelContext:
    """One mesh + axis assignment = one k-means execution substrate.

    >>> mesh = build_mesh((2, 4), ("data", "model"))
    >>> pctx = ParallelContext(mesh, data_axes=("data",), k_axis="model")
    >>> fit = pctx.make_kmeans_fit(cfg)          # distributed Lloyd loop
    >>> step = pctx.make_partial_fit(cfg)        # streaming mini-batch
    >>> assign = pctx.make_assign(cfg)           # two-stage argmin

    ``data_axes`` split the points (N); ``k_axis`` (optional) the centroids
    and posting lists (K). The collective primitives (``psum_stats``,
    ``two_stage_assign``, ``merge_topl``, ``owned_stats``) run on local
    tensors inside a program built by ``spmd``; every rank must call them
    in the same order.
    """

    def __init__(self, mesh, data_axes: Sequence[str] = ("data",),
                 k_axis: str | None = None):
        self.mesh = mesh
        names = shu.mesh_axis_names(mesh)
        self.data_axes = tuple(data_axes)
        missing = [a for a in self.data_axes if a not in names]
        if missing or not self.data_axes:
            raise ValueError(f"data_axes {missing or tuple(data_axes)} not "
                             f"in mesh axes {names} "
                             "(for_mesh resolves logical axes instead)")
        if k_axis is not None and k_axis not in names:
            raise ValueError(f"k_axis={k_axis!r} not in mesh axes {names}")
        if k_axis in self.data_axes:
            raise ValueError(f"k_axis={k_axis!r} overlaps data_axes")
        self.k_axis = k_axis
        # payload bytes of this rank's collectives over axes of more than one
        # rank: an all-gather's result, an all-reduce's tensor (callers zero
        # and read it around a program)
        self.wire_bytes = {"all_gather": 0, "all_reduce": 0}

    @classmethod
    def for_mesh(cls, mesh, rules: dict | None = None) -> "ParallelContext":
        """Resolve ``"points"`` onto the data-parallel axes and ``"cells"``
        onto the centroid axis (``utils.sharding`` rules); a size-1 cells
        axis degrades to no K-sharding."""
        names = shu.mesh_axis_names(mesh)
        rules = rules or shu.rules_for_mesh(mesh)
        data_axes = tuple(a for a in rules.get("points", ()) if a in names)
        cand = tuple(a for a in rules.get("cells", ())
                     if a in names and a not in data_axes)
        k_axis = cand[0] if cand and _size(mesh, cand[0]) > 1 else None
        return cls(mesh, data_axes=data_axes or names[:1], k_axis=k_axis)

    # -- shard counts, ranks, specs ------------------------------------------

    def axis_size(self, axis: str) -> int:
        return _size(self.mesh, axis)

    def axis_rank(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``jax.lax.axis_index``)."""
        return int(self.mesh.get_local_rank(axis))

    @property
    def n_data_shards(self) -> int:
        return math.prod(self.axis_size(a) for a in self.data_axes)

    @property
    def n_k_shards(self) -> int:
        return self.axis_size(self.k_axis) if self.k_axis else 1

    @property
    def k_rank(self) -> int:
        """This rank's centroid shard (0 without a ``k_axis``)."""
        return self.axis_rank(self.k_axis) if self.k_axis else 0

    def k_local(self, k: int) -> int:
        pk = self.n_k_shards
        if k % pk != 0:
            raise ValueError(f"K={k} must divide the {pk}-way k_axis")
        return k // pk

    @property
    def device(self) -> torch.device:
        """The device this rank's pieces live on (its current card)."""
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    @property
    def data_spec(self) -> tuple:
        return (self.data_axes, None)

    @property
    def points_spec(self) -> tuple:
        """The 1-D spec of per-point vectors (assignments, masks)."""
        return (self.data_axes,)

    @property
    def centroid_spec(self) -> tuple:
        return (self.k_axis, None) if self.k_axis else (None, None)

    def _shard(self, axes: tuple) -> tuple[int, int]:
        """(this rank's index, shard count) over ``axes``, row-major."""
        idx, n = 0, 1
        for a in axes:
            idx = idx * self.axis_size(a) + self.axis_rank(a)
            n *= self.axis_size(a)
        return idx, n

    # -- placement and its inverse (no other module slices or gathers) ------

    def put(self, x, spec: tuple | None) -> torch.Tensor:
        """This rank's piece of the global ``x`` under ``spec``, on the
        rank's device (``None``: the whole of ``x``, replicated). Slicing
        only: no communication. A split dim must divide evenly."""
        x = torch.as_tensor(x)
        for dim, entry in enumerate(spec or ()):
            axes = _axes(entry)
            if not axes:
                continue
            idx, n = self._shard(axes)
            size = x.shape[dim]
            if size % n:
                raise ValueError(f"dim {dim} of size {size} does not split "
                                 f"evenly over {axes} ({n} shards)")
            x = x.narrow(dim, idx * (size // n), size // n)
        return x.contiguous().to(self.device)

    def shard_points(self, x) -> torch.Tensor:
        """This rank's rows of a global ``(N, d)`` array (split along N)."""
        return self.put(x, self.data_spec)

    def shard_centroids(self, c) -> torch.Tensor:
        return self.put(c, self.centroid_spec)

    def replicate(self, x) -> torch.Tensor:
        return self.put(x, None)

    def gather(self, t: torch.Tensor, spec: tuple | None) -> torch.Tensor:
        """The global tensor of which ``t`` is this rank's piece under
        ``spec`` (the inverse of ``put``): an all-gather over each split
        dim's axes, the innermost axis first."""
        for dim, entry in enumerate(spec or ()):
            for a in reversed(_axes(entry)):
                t = torch.cat(list(self.all_gather(t, a)), dim=dim)
        return t

    def spmd(self, f, in_specs, out_specs):
        """A program over this mesh: ``run(*global_tensors)`` puts each
        input under its spec (an input of ``None`` stays ``None``), calls
        ``f`` on the local pieces, and gathers each output under its spec
        (``None``: returned as this rank holds it, replicated or local)."""
        def run(*args):
            out = f(*(None if a is None else self.put(a, s)
                      for a, s in zip(args, in_specs)))
            single = not isinstance(out, tuple)
            outs = (out,) if single else out
            res = tuple(o if s is None else self.gather(o, s)
                        for o, s in zip(outs, out_specs))
            return res[0] if single else res
        return run

    def pad_points(self, x, value=0) -> tuple[torch.Tensor, torch.Tensor, int]:
        """Pad N up to a data-shard multiple; returns ``(x_pad, mask, n)``.
        The mask keeps the padding rows out of every statistics reduction
        (a shard made entirely of padding contributes exact zeros)."""
        x = torch.as_tensor(x)
        n = x.shape[0]
        mult = self.n_data_shards
        n_pad = -(-n // mult) * mult
        if n_pad != n:
            x = torch.cat([x, x.new_full((n_pad - n, *x.shape[1:]), value)])
        mask = torch.arange(n_pad, device=x.device) < n
        return x, mask, n

    # -- collectives (the only calls into torch.distributed) ----------------

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``(P, *t.shape)``: every rank's ``t`` on ``axis``, by coordinate."""
        p = self.axis_size(axis)
        if p == 1:
            return t.unsqueeze(0)
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(p)]
        dist.all_gather(out, t, group=self.mesh.get_group(axis))
        self.wire_bytes["all_gather"] += p * t.numel() * t.element_size()
        return torch.stack(out)

    def psum(self, t: torch.Tensor, axes: Sequence[str] | None = None
             ) -> torch.Tensor:
        """Sum of ``t`` over ``axes`` (default the data axes), one
        ``all_reduce`` an axis in turn; axes of one rank add nothing."""
        axes = self.data_axes if axes is None else tuple(axes)
        live = [a for a in axes if self.axis_size(a) > 1]
        if not live:
            return t
        out = t.reshape(1) if t.ndim == 0 else t.clone()
        for a in live:
            dist.all_reduce(out, op=dist.ReduceOp.SUM,
                            group=self.mesh.get_group(a))
            self.wire_bytes["all_reduce"] += out.numel() * out.element_size()
        return out.reshape(()) if t.ndim == 0 else out

    def psum_stats(self, stats: SufficientStats,
                   axes: Sequence[str] | None = None) -> SufficientStats:
        """The O(K d) sufficient-statistics reduction tree."""
        return SufficientStats(self.psum(stats.sums, axes),
                               self.psum(stats.counts, axes),
                               self.psum(stats.inertia, axes))

    def merge_topl(self, idx: torch.Tensor, val: torch.Tensor, l: int, *,
                   axis: str | None = None, tie: torch.Tensor | None = None,
                   valid=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Cross-rank ascending top-``l`` of per-rank lists ``idx``/``val``
        (B, L_loc), each ascending: gathers O(B L_loc) bytes a rank, never
        the candidates' rows.

        Without ``tie``, equal values break toward the lower (rank, local
        position): a stable sort of the rank-major concatenation. With
        ``tie`` (B, L_loc) int, equal values break toward the lower tie key
        (a lexicographic (value, tie) order: a stable sort by tie, then by
        value). ``valid`` (a bool, this rank's): ``False`` blanks this
        rank's list to ``(+inf, -1)`` (tie ``int32`` max) before the
        gather, as if the rank were absent."""
        axis = axis if axis is not None else self.k_axis
        if valid is not None:
            ok = torch.as_tensor(valid, device=val.device)
            val = torch.where(ok, val, torch.inf)
            idx = torch.where(ok, idx, -1)
            if tie is not None:
                tie = torch.where(ok, tie, torch.iinfo(torch.int32).max)
        if axis is None:
            return idx[:, :l], val[:, :l]
        b = val.shape[0]

        def cat(arr):
            return self.all_gather(arr, axis).transpose(0, 1).reshape(b, -1)

        v_cat, i_cat = cat(val), cat(idx)
        t_cat = cat(tie) if tie is not None else None
        if v_cat.shape[1] < l:   # a pool smaller than l: pad honestly
            pad = l - v_cat.shape[1]
            v_cat = torch.cat([v_cat, v_cat.new_full((b, pad), torch.inf)], 1)
            i_cat = torch.cat([i_cat, i_cat.new_full((b, pad), -1)], 1)
            if t_cat is not None:
                t_cat = torch.cat([t_cat, t_cat.new_full(
                    (b, pad), torch.iinfo(torch.int32).max)], 1)
        if t_cat is None:
            pos = torch.sort(v_cat, dim=1, stable=True).indices[:, :l]
        else:
            o1 = torch.sort(t_cat, dim=1, stable=True).indices
            o2 = torch.sort(torch.gather(v_cat, 1, o1), dim=1,
                            stable=True).indices
            pos = torch.gather(o1, 1, o2)[:, :l]
        return torch.gather(i_cat, 1, pos), torch.gather(v_cat, 1, pos)

    def two_stage_assign(self, x: torch.Tensor, c_local: torch.Tensor,
                         cfg: KMeansConfig
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """Global argmin with the centroids split over ``k_axis``:
        ``(a int32 (N_local,), min squared distance f32 (N_local,))``.

        Stage 1 is FlashAssign over this rank's K / P_k centroids; stage 2
        merges the per-rank ``(score, id)`` minima, ties to the lower
        global id. Each pair is scored as it is against all K centroids,
        so the ids equal single-device FlashAssign's. The merge compares
        the ``||x||^2``-free scores, whose argmin the kernel takes; the
        distance is the winner's score plus ``||x||^2``, clamped at 0.
        Without a ``k_axis`` this is the single-device assignment."""
        blk = cfg.blocks_for(x.shape[0], x.shape[1], x.element_size(),
                             x.device)
        c = c_local.to(x.dtype)
        if self.k_axis is None:
            a, m = _km._assign(x.unsqueeze(0), c.unsqueeze(0), cfg, blk)
            return a[0], m[0]
        if cfg.assign_impl == "flash":
            a_loc, s_loc = ops.flash_assign(
                x, c, block_n=blk.assign_block_n, block_k=blk.assign_block_k,
                want_dists=False)
        elif cfg.assign_impl == "ref":
            a_loc, s_loc = ref.assign_ref_crossterm(x, c)
        else:
            raise ValueError(f"unknown assign impl {cfg.assign_impl!r}")
        lo = self.k_rank * c.shape[0]
        gi, gv = self.merge_topl((a_loc + lo).unsqueeze(1),
                                 s_loc.unsqueeze(1), 1)
        x32 = x.float()
        m = torch.clamp(gv[:, 0] + (x32 * x32).sum(-1), min=0.0)
        return gi[:, 0].to(torch.int32), m

    def owned_stats(self, x: torch.Tensor, a_glob: torch.Tensor, k: int,
                    cfg: KMeansConfig, mask: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Statistics of the owned centroid range, summed over the data
        axes: ``(sums (k_owned, d) f32, counts (k_owned,) f32)``, ``k_owned
        = k / P_k``. Rows another rank owns, and masked rows, go to one
        extra bucket that is sliced off, so a rank owning only dead cells
        reduces to exact zeros."""
        blk = cfg.blocks_for(x.shape[0], x.shape[1], x.element_size(),
                             x.device)
        if self.k_axis is None:
            if mask is None:
                a_eff, k_eff = a_glob, k
            else:
                a_eff = torch.where(mask, a_glob, k).to(torch.int32)
                k_eff = k + 1
        else:
            kl = self.k_local(k)
            rel = a_glob - self.k_rank * kl
            ok = (rel >= 0) & (rel < kl)
            if mask is not None:
                ok = ok & mask
            a_eff = torch.where(ok, rel, kl).to(torch.int32)
            k_eff, k = kl + 1, kl
        s, n = ops.centroid_stats(
            x, a_eff, k=k_eff, impl=cfg.stats_only_update_impl(),
            block_n=blk.update_block_n, block_k=blk.update_block_k)
        return self.psum(s[:k]), self.psum(n[:k])

    # -- programs -----------------------------------------------------------

    def make_assign(self, cfg: KMeansConfig):
        """``assign(x (N, d), c (K, d)) -> (a (N,), min_sq_d (N,))`` over
        global tensors: x split over the data axes, c over ``k_axis``
        (the two-stage argmin) or replicated."""
        return self.spmd(lambda x, c: self.two_stage_assign(x, c, cfg),
                         in_specs=(self.data_spec, self.centroid_spec),
                         out_specs=(self.points_spec, self.points_spec))

    def make_kmeans_fit(self, cfg: KMeansConfig,
                        compress_pod_axis: str | None = None,
                        masked: bool = False):
        """The distributed Lloyd loop: ``fit(x, c0)`` (or ``fit(x, mask,
        c0)`` with ``masked=True``, for a ragged N padded to a shard
        multiple) over global tensors -> ``FitResult(centroids,
        assignments, inertia)`` with ``iterations``. One collective round
        an iteration (the O(K d) stats all-reduce; under K-sharding also
        the O(N_local P_k) assignment merge), under the single-device rule
        ``while iteration < max_iters and shift > tol``.

        ``compress_pod_axis``: full-precision sums inside each pod, then
        the error-feedback int8 exchange of the (K, d) statistics across
        the pod axis (``optim.compression``)."""
        if self.k_axis is None:
            body = self._fit_n_sharded(cfg, compress_pod_axis, masked)
        else:
            if compress_pod_axis is not None:
                raise NotImplementedError(
                    "compressed pod reduction is not supported together "
                    "with K-sharding")
            if cfg.k % self.n_k_shards != 0:
                raise ValueError(f"K={cfg.k} must divide the k_axis size "
                                 f"{self.n_k_shards}")
            body = self._fit_k_sharded(cfg, masked)
        c_spec = self.centroid_spec if self.k_axis else None
        prog = self.spmd(body, in_specs=(self.data_spec, self.points_spec,
                                         c_spec),
                         out_specs=(c_spec, self.points_spec, None, None))
        if masked:
            return lambda x, mask, c0: FitResult(*prog(x, mask, c0))
        return lambda x, c0: FitResult(*prog(
            x, torch.ones((x.shape[0],), dtype=torch.bool), c0))

    def _loop(self, cfg: KMeansConfig, x: torch.Tensor, c: torch.Tensor,
              step):
        """Run ``step(c) -> (c_new, a, inertia, shift)`` while ``iteration
        < max_iters and shift > tol``; one host read of the replicated
        shift an iteration."""
        a = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
        inertia = torch.full((), float("inf"), device=x.device)
        it, shift = 0, float("inf")
        while it < cfg.max_iters and shift > cfg.tol:
            c, a, inertia, sh = step(c)
            shift = float(sh)   # the one host read an iteration
            it += 1
        return c, a, inertia, it

    def _fit_n_sharded(self, cfg: KMeansConfig,
                       compress_pod_axis: str | None, masked: bool):
        data_axes = self.data_axes
        intra = tuple(a for a in data_axes if a != compress_pod_axis)

        def body(x, mask, c0):
            if cfg.dtype is not None:
                x = x.to(cfg.dtype)
            blk = cfg.blocks_for(x.shape[0], x.shape[1], x.element_size(),
                                 x.device)
            err = [torch.zeros((cfg.k, x.shape[1]), device=x.device),
                   torch.zeros((cfg.k,), device=x.device)]

            def step(c):
                if masked:
                    batch, a = SufficientStats.from_batch(x, c, cfg, blk,
                                                          mask=mask)
                    s, n, j = batch
                else:
                    a, s, n, j = _km.lloyd_stats(x, c, cfg, blk)
                if compress_pod_axis is None:
                    s, n = self.psum(s, data_axes), self.psum(n, data_axes)
                else:
                    s, n = self.psum(s, intra), self.psum(n, intra)
                    s, err[0] = compression.ef_quantized_allreduce(
                        s, err[0], compress_pod_axis, pctx=self)
                    n, err[1] = compression.ef_quantized_allreduce(
                        n, err[1], compress_pod_axis, pctx=self)
                c_new = ops.finalize_centroids(s, n, c)
                shift = ((c_new.float() - c.float()) ** 2).sum()
                return c_new, a, self.psum(j, data_axes), shift

            return self._loop(cfg, x, c0.to(x.dtype), step)

        return body

    def _fit_k_sharded(self, cfg: KMeansConfig, masked: bool):
        def body(x, mask, c0_local):
            if cfg.dtype is not None:
                x = x.to(cfg.dtype)

            def step(c):
                a, m = self.two_stage_assign(x, c, cfg)
                j = torch.where(mask, m, 0.0) if masked else m
                s, n = self.owned_stats(x, a, cfg.k, cfg,
                                        mask=mask if masked else None)
                c_new = ops.finalize_centroids(s, n, c)
                # the global shift: this rank's slice, summed over cells
                shift = self.psum(((c_new.float() - c.float()) ** 2).sum(),
                                  (self.k_axis,))
                return c_new, a, self.psum(j.sum()), shift

            return self._loop(cfg, x, c0_local.to(x.dtype), step)

        return body

    def make_partial_fit(self, cfg: KMeansConfig, *, decay: float = 1.0,
                         local_iters: int = 1):
        """The data-parallel streaming step, the twin of
        ``streaming.partial_fit_step``: ``step(x_pad, mask, c, sums, counts,
        inertia) -> (c', sums', counts', inertia', a, batch_inertia)`` over
        global tensors. Per-rank masked batch statistics, one O(K d)
        all-reduce a mini-batch, a replicated M-step. ``mask=None`` (a
        batch without padding) takes the per-batch step of one device,
        fused or two-pass by ``cfg.step_impl``; a mask forces two-pass."""
        axes = self.data_axes

        def body(x, mask, c, sums, counts, inertia):
            base = SufficientStats(sums, counts, inertia).scale(decay)
            merged, a, batch = base, None, None
            for _ in range(max(1, local_iters)):
                batch, a = SufficientStats.from_batch(x, c, cfg, mask=mask)
                batch = self.psum_stats(batch, axes)
                merged = base.merge(batch)
                c = merged.finalize(c)
            return (c, merged.sums, merged.counts, merged.inertia, a,
                    batch.inertia)

        return self.spmd(
            body, in_specs=(self.data_spec, self.points_spec, None, None,
                            None, None),
            out_specs=(None, None, None, None, self.points_spec, None))

    # -- collective-bytes model ---------------------------------------------

    def collective_bytes(self, op: str, *, k: int = 0, d: int = 0,
                         n_local: int = 0, b: int = 0, l: int = 0) -> int:
        """Modeled wire bytes a rank of one collective round:

        - ``stats_psum``:    2·4·(K·d + K + 1)          (O(K·d), N-free)
        - ``assign_merge``:  2·4·N_local·P_k            (value + id gather)
        - ``topl_merge``:    2·4·b·l·P_k                (O(b·L))
        """
        if op == "stats_psum":
            return 2 * 4 * (k * d + k + 1)
        if op == "assign_merge":
            return 2 * 4 * n_local * self.n_k_shards
        if op == "topl_merge":
            return 2 * 4 * b * l * self.n_k_shards
        raise ValueError(f"unknown collective op {op!r}")

    def search_collective_bytes(self, b: int, nprobe: int, topk: int,
                                k: int, cap: int = 0, d: int = 0) -> int:
        """A search batch's cross-rank traffic: the probe merge at ``L =
        min(nprobe, K/P_k)`` and the result merge at ``L = topk``; the
        posting lists' rows never move (``cap`` and ``d`` do not count)."""
        del cap, d
        return search_collective_bytes_model(b, nprobe, topk, k,
                                             self.n_k_shards)

    def describe(self) -> str:
        shape = {a: self.axis_size(a) for a in shu.mesh_axis_names(self.mesh)}
        return (f"ParallelContext(mesh={shape}, points={self.data_axes}, "
                f"cells={self.k_axis or '-'}x{self.n_k_shards})")

    __repr__ = describe


def _size(mesh, axis: str) -> int:
    return int(mesh.shape[shu.mesh_axis_names(mesh).index(axis)])


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def search_collective_bytes_model(b: int, nprobe: int, topk: int, k: int,
                                  p_k: int) -> int:
    """Closed-form wire model of a sharded search over a ``p_k``-way cells
    split: a probe merge at ``L = min(nprobe, K/p_k)`` and a result merge at
    ``L = topk``, each a (value, id) all-gather of ``2·4·b·L·p_k`` bytes a
    rank; 0 on one shard."""
    if p_k <= 1:
        return 0
    ll = min(nprobe, max(1, k // p_k))
    return 2 * 4 * b * (ll + topk) * p_k
