"""Logical-axis sharding: layers declare *logical* specs, the mesh names
physical axes, and the resolvers map one onto the other.

Port of ``repro/utils/sharding.py``. Logical axes:

  "fsdp"  — parameter/optimizer sharding over the data-parallel axes
  "tp"    — tensor parallelism (heads / d_ff / experts / vocab)
  "dp"    — batch dimension of activations
  "sp"    — sequence dimension (long-context / KV-cache sharding)
  "points"— k-means point axis (N): the Lloyd, streaming and IVF-build
            reductions (``core.parallel``)
  "cells" — k-means centroid axis (K): the two-stage argmin and the
            sharded FlashIVF
  None    — replicated

A spec is a tuple of logical names per dim, e.g. ``("fsdp", "tp")`` for a
(D, F) matmul weight. ``resolve_spec`` turns it into the reference's
``PartitionSpec`` entries for a concrete mesh (``None``, one mesh axis, or
a tuple of them), dropping any logical axis whose mapped mesh-axis product
does not divide the dim (the fallback is replication on that dim, never an
error). The mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims,
or anything with ``shape`` and ``axis_names`` (the tests' stub meshes).

On a ``DeviceMesh`` a resolved spec becomes DTensor placements, one per
mesh dim (``placements``): a tensor dim split over ``("pod", "data")`` is
``Shard(dim)`` on both mesh dims, row-major as a ``PartitionSpec`` is.
``DTensor.redistribute`` plays the part of ``with_sharding_constraint``
(``constrain``), and DTensor's propagation through torch ops the part of
GSPMD between those named points; ``region`` lets the plain tensors a
layer makes (positions, masks, zeros) meet DTensors as replicated values.
Every redistribution of the LM path goes through this module: ``place``
(a global tensor to its placements, by slicing, without communication),
``constrain``, ``gather`` (the whole tensor on every rank), ``local`` (a
function on each rank's own pieces, the hand-written kernels' way onto a
mesh) and ``to_placements``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Sequence

import torch

# logical -> tuple of physical mesh axis names (order matters)
DEFAULT_RULES = {
    "fsdp": ("data",),
    "tp": ("model",),
    "dp": ("pod", "data"),
    "sp": ("data",),
    "mdl": ("model",),     # explicit model-axis placement (e.g. KV seq split)
    "expert": ("model",),
    # k-means logical axes: points ride the data-parallel axes, cells the
    # model axis
    "points": ("pod", "data"),
    "cells": ("model",),
}


def mesh_axis_names(mesh) -> tuple[str, ...]:
    """The named dims of a ``DeviceMesh`` (``mesh_dim_names``), or a stub
    mesh's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    return tuple(names or ())


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (1 where the mesh has no such axis)."""
    return _axis_sizes(mesh).get(name, 1)


def _axis_sizes(mesh) -> dict:
    names = mesh_axis_names(mesh)
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(names, tuple(shape)))


def rules_for_mesh(mesh) -> dict:
    """``DEFAULT_RULES`` adapted to ``mesh``: with a ``"pod"`` axis the
    data-parallel names span pods too, else they take ``"data"`` alone."""
    rules = dict(DEFAULT_RULES)
    if "pod" in mesh_axis_names(mesh):
        rules["fsdp"] = ("pod", "data")   # FSDP spans pods too
        rules["dp"] = ("pod", "data")
        rules["points"] = ("pod", "data")
    else:
        rules["dp"] = ("data",)
        rules["points"] = ("data",)
    return rules


def _mesh_size(sizes: dict, axes: Sequence[str]) -> int:
    return math.prod(sizes[a] for a in axes if a in sizes)


def resolve_spec(logical: tuple, shape: tuple, mesh,
                 rules: dict | None = None) -> tuple:
    """Map one logical spec tuple onto the entries of a ``PartitionSpec``
    for ``shape``: per dim ``None``, one axis name, or a tuple of them."""
    rules = rules or rules_for_mesh(mesh)
    sizes = _axis_sizes(mesh)
    out = []
    used: set[str] = set()
    for dim, name in enumerate(logical):
        if name is None:
            out.append(None)
            continue
        axes = tuple(a for a in rules.get(name, ())
                     if a in sizes and a not in used)
        if not axes:
            out.append(None)
            continue
        size = _mesh_size(sizes, axes)
        if size <= 1 or shape[dim] % size != 0:
            # try a prefix of the axes (e.g. fsdp=(pod,data) -> (pod,))
            while axes and (shape[dim] % _mesh_size(sizes, axes) != 0
                            or _mesh_size(sizes, axes) <= 1):
                axes = axes[:-1]
            if not axes:
                out.append(None)
                continue
        used.update(axes)
        out.append(axes if len(axes) > 1 else axes[0])
    return tuple(out)


def is_spec(x) -> bool:
    """A spec leaf: a tuple whose entries are None, an axis name or (in a
    resolved spec) a tuple of axis names."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and e and all(isinstance(a, str) for a in e))
        for e in x)


def map_specs(fn, spec_tree: Any, *trees: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree and matching trees (dicts,
    lists and tuples of tensors; a spec tuple is a leaf)."""
    if is_spec(spec_tree):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in spec_tree.items()}
    return type(spec_tree)(map_specs(fn, v, *(t[i] for t in trees))
                           for i, v in enumerate(spec_tree))


def resolve_tree(logical_tree: Any, params: Any, mesh,
                 rules: dict | None = None) -> Any:
    """Map a tree of logical specs over a matching params tree (each leaf
    a tensor or anything with ``shape``)."""
    rules = rules or rules_for_mesh(mesh)
    return map_specs(lambda spec, p: resolve_spec(spec, tuple(p.shape), mesh,
                                                  rules),
                     logical_tree, params)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements (one per mesh dim) of a resolved spec: a tensor
    dim split over several mesh axes is ``Shard(dim)`` on each, row-major,
    so its axes must appear in mesh-dim order."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"dim order {names}")
        for i in order:
            out[i] = Shard(dim)
    return out


def named_tree(spec_tree: Any, mesh) -> Any:
    """A tree of resolved specs -> a tree of placement lists."""
    return map_specs(lambda s: placements(s, mesh), spec_tree)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def is_dtensor_type(cls) -> bool:
    """Whether ``cls`` is DTensor or a subclass of it (a dispatch mode's
    ``types``)."""
    from torch.distributed.tensor import DTensor
    return issubclass(cls, DTensor)


def local_part(x: torch.Tensor) -> torch.Tensor:
    """This rank's piece of a DTensor; a plain tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def group_size(group) -> int:
    """The ranks of a process group, given as a group or by the name a
    functional collective carries."""
    if not isinstance(group, str):
        return group.size()
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group).size()


def local_slice(x: torch.Tensor, mesh, pl: Sequence) -> torch.Tensor:
    """This rank's piece of a global tensor under placements ``pl`` (a
    view, on ``x``'s device)."""
    from torch.distributed.tensor import Shard
    local = x
    for mdim, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(mdim)
            i = mesh.get_local_rank(mdim)
            step = local.shape[p.dim] // n
            local = local.narrow(p.dim, i * step, step)
    return local


def place(x: torch.Tensor, mesh, pl: Sequence) -> torch.Tensor:
    """A global tensor, the same on every rank, as a DTensor of placements
    ``pl``: each rank keeps its own slice, without communication."""
    return global_of(local_slice(x, mesh, pl).contiguous(), mesh, pl,
                      x.shape)


def global_of(local: torch.Tensor, mesh, pl: Sequence, shape):
    """The DTensor of global ``shape`` whose piece on this rank is
    ``local`` (contiguous strides; no communication)."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, list(pl), run_check=False,
                              shape=shape, stride=tuple(reversed(stride)))


def place_tree(tree: Any, spec_tree: Any, mesh,
               rules: dict | None = None) -> Any:
    """Place every leaf of ``tree`` (global tensors) by the logical spec
    tree resolved on ``mesh``; a leaf that is a DTensor already is
    redistributed to its placements."""
    rules = rules or rules_for_mesh(mesh)

    def one(spec, t):
        pl = placements(resolve_spec(spec, tuple(t.shape), mesh, rules),
                        mesh)
        if is_dtensor(t):
            return to_placements(t, pl)
        return place(t, mesh, pl)
    return map_specs(one, spec_tree, tree)


def to_placements(x, pl: Sequence):
    """Redistribute a DTensor to placements ``pl`` (the identity when it
    has them already)."""
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(x.device_mesh, list(pl))


def constrain(x, mesh, *logical, rules: dict | None = None):
    """``with_sharding_constraint`` with logical names for activations: a
    DTensor is redistributed to the resolved placements. The identity
    without a mesh, and on a plain tensor (a value every rank holds
    whole, such as a rank's local problem)."""
    if mesh is None or not is_dtensor(x):
        return x
    spec = resolve_spec(tuple(logical), tuple(x.shape), mesh, rules)
    return to_placements(x, placements(spec, mesh))


def same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` view the same memory the same way (for
    DTensors: the same placements and the same local view on this rank; a
    DTensor's own ``data_ptr`` is not its local tensor's)."""
    if is_dtensor(a) != is_dtensor(b):
        return False
    if is_dtensor(a):
        if tuple(a.placements) != tuple(b.placements):
            return False
        a, b = a.to_local(), b.to_local()
    return a.data_ptr() == b.data_ptr() and a.stride() == b.stride()


def replicated(x):
    """A DTensor redistributed to be whole on every rank (partial sums
    reduced), still a DTensor; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    return to_placements(x, placements((), x.device_mesh))


def gather(x):
    """The global tensor on every rank (a DTensor's ``full_tensor``); a
    plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


@contextlib.contextmanager
def region(mesh):
    """The context a mesh program runs in: plain tensors that meet DTensors
    count as replicated (DTensor's implicit replication), restored to what
    it was on exit, so regions nest. Without a mesh, nothing."""
    if mesh is None:
        yield
        return
    was = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(was)


def local(fn, args: tuple, in_pl: tuple, out_pl, mesh, in_grad_pl=None):
    """``fn`` on each rank's own pieces (DTensor's ``local_map``): each
    DTensor argument is redistributed to its placements in ``in_pl`` and
    taken local, a plain tensor counting as replicated; every tensor of the
    result is wrapped back as a DTensor of ``out_pl``. A placements entry is
    a list (for every tensor of that argument or result), None (the argument
    passes as it is), a tuple or dict of entries matching the tree, or, for
    ``out_pl``, a function of the result returning such an entry. The
    gradients flow through both ends; ``in_grad_pl`` (entries as
    ``in_pl``'s, None: the forward's) declares an argument's gradient
    placements where they differ, e.g. ``partial_data`` for a weight every
    rank uses whole on its own rows. Used where an op has no DTensor rule
    or a hand-written kernel needs a plain tensor."""
    from torch.distributed.tensor import DTensor

    def sub(pl, key):
        return pl[key] if isinstance(pl, (tuple, dict)) else pl

    def to_local(a, pl, gpl=None):
        if pl is None:
            return a
        if isinstance(a, dict):
            return {k: to_local(v, sub(pl, k), sub(gpl, k))
                    for k, v in a.items()}
        if isinstance(a, (tuple, list)):
            return type(a)(to_local(v, sub(pl, i), sub(gpl, i))
                           for i, v in enumerate(a))
        if not isinstance(a, torch.Tensor):
            return a
        if not is_dtensor(a):   # a value every rank holds whole
            a = DTensor.from_local(a, mesh, placements((), mesh),
                                   run_check=False)
        return to_placements(a, pl).to_local(
            grad_placements=None if gpl is None else list(gpl))

    def wrap(r, pl):
        if isinstance(r, dict):
            return {k: wrap(v, sub(pl, k)) for k, v in r.items()}
        if isinstance(r, (tuple, list)):
            return type(r)(wrap(v, sub(pl, i)) for i, v in enumerate(r))
        if not isinstance(r, torch.Tensor):
            return r
        return DTensor.from_local(r, mesh, list(pl), run_check=False)

    gpls = in_grad_pl or (None,) * len(args)
    out = fn(*(to_local(a, pl, g) for a, pl, g in zip(args, in_pl, gpls)))
    return wrap(out, out_pl(out) if callable(out_pl) else out_pl)


def on_local(fn, x):
    """``fn`` on each rank's piece of the DTensor ``x``, the placements
    kept: for an op along dims ``x`` does not split (a pad, a view),
    which DTensor's own rule may not carry. A plain tensor: ``fn(x)``."""
    if not is_dtensor(x):
        return fn(x)
    pl = list(x.placements)
    return local(fn, (x,), (pl,), pl, x.device_mesh)


def partial_over(entry, pl: Sequence, mesh) -> list:
    """``pl`` with every mesh dim of ``entry`` (a resolved spec entry: None,
    an axis or a tuple of them) made ``Partial``: the placements of a sum
    each rank takes over its own share along those axes."""
    from torch.distributed.tensor import Partial
    axes = () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)
    names = mesh_axis_names(mesh)
    return [Partial() if names[i] in axes else p for i, p in enumerate(pl)]


def problem_split(mesh, rules: dict | None = None, **sizes) -> dict:
    """``{logical name: resolved entry}`` for the dims a computation's
    independent problems run over, each resolved against its size (e.g.
    ``dp=B, tp=H``): the split that ``problem_placements`` applies to every
    tensor of that computation."""
    rules = rules or rules_for_mesh(mesh)
    return {n: resolve_spec((n,), (size,), mesh, rules)[0]
            for n, size in sizes.items()}


def problem_placements(spec: tuple, split: dict, mesh) -> list:
    """Placements of a logical spec under ``problem_split``'s split: each
    named dim takes its problem axes, every other dim is whole."""
    return placements(tuple(split.get(n) for n in spec), mesh)


def partial_data(mesh, rules: dict | None = None) -> list:
    """Placements of a per-rank partial sum over the ``"dp"`` axes (a sum
    of each rank's own share of a batch), replicated over the rest."""
    from torch.distributed.tensor import Partial, Replicate
    rules = rules or rules_for_mesh(mesh)
    names = mesh_axis_names(mesh)
    return [Partial() if a in rules["dp"] else Replicate() for a in names]


def data_split(x, dim: int = 0):
    """A DTensor redistributed to ``data_placements`` (each rank holds its
    share of the batch whole along every other dim); a plain tensor as it
    is. For ops that have no DTensor rule over a split they contract or
    index."""
    if not is_dtensor(x):
        return x
    return to_placements(x, data_placements(x.device_mesh, dim))


def split_heads(x, heads: int, head_dim: int):
    """``x.reshape(*lead, heads, head_dim)``. A DTensor whose last dim is
    split more ways than ``heads`` divides (kv heads fewer than the model
    axis) has no view rule for that: it is first redistributed to whole
    rows of its last dim."""
    if is_dtensor(x):
        from torch.distributed.tensor import Shard
        ways = math.prod(x.device_mesh.size(i)
                         for i, p in enumerate(x.placements)
                         if isinstance(p, Shard) and p.dim % x.ndim
                         == x.ndim - 1)
        if heads % ways:
            x = data_split(x, 0)
    return x.reshape(*x.shape[:-1], heads, head_dim)


class _GradPlacements(torch.autograd.Function):
    """The identity, whose backward redistributes the gradient to the
    placements ``pl``."""

    @staticmethod
    def forward(fctx, x, pl):
        fctx.pl = pl
        return x.view_as(x)

    @staticmethod
    def backward(fctx, grad):
        return to_placements(grad, fctx.pl), None


def merge_heads(x):
    """``x.reshape(*lead, heads * head_dim)``, the inverse of
    ``split_heads``. On a DTensor whose heads the ``"tp"`` axes do not
    divide, the gradient of the merged tensor (split along its last dim
    by the projection that reads it) would have to be unflattened into
    heads split more ways than there are; so it is first redistributed to
    the placements ``x`` had, which keep every head whole, as the
    reference's divisibility fallback replicates such a head dim."""
    merged = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if is_dtensor(x):
        mesh = x.device_mesh
        ways = _mesh_size(_axis_sizes(mesh), rules_for_mesh(mesh)["tp"])
        if x.shape[-2] % ways:
            merged = _GradPlacements.apply(merged, tuple(merged.placements))
    return merged


def data_placements(mesh, dim: int, rules: dict | None = None) -> list:
    """Placements that split tensor dim ``dim`` over the ``"dp"`` axes and
    replicate it over the rest: a rank's share of a batch."""
    rules = rules or rules_for_mesh(mesh)
    names = mesh_axis_names(mesh)
    spec = [None] * dim + [tuple(a for a in rules["dp"] if a in names)]
    spec[dim] = spec[dim] or None
    return placements(tuple(spec), mesh)


# ---------------------------------------------------------------------------
# DTensor's collectives over gloo on CUDA tensors
# ---------------------------------------------------------------------------

_list_collectives_on: set = set()
wire_bytes: dict = {}


def _reduce_op(name: str):
    import torch.distributed as dist
    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
           "product": dist.ReduceOp.PRODUCT, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}
    return ops[name.lower()]


def use_list_collectives(device_type: str) -> None:
    """Route DTensor's functional collectives on ``device_type`` tensors
    through ``all_gather`` of a list and ``all_reduce``.

    Ranks that share one card run gloo (NCCL refuses two ranks on one GPU),
    and gloo's tensor-form collectives on CUDA tensors
    (``all_gather_into_tensor`` and the rest that DTensor issues) end the
    process with a segmentation fault (torch 2.11), while its list
    ``all_gather`` and ``all_reduce`` work. So each functional op is built
    here from those two: a reduce-scatter is an all-reduce and this rank's
    chunk, an all-to-all a gather of every rank's input. Gloo stages each
    of them through host memory. So this is a stand-in for a real mesh's
    collectives: what it moves, and how long it takes, are not what NCCL
    would move or take. Process-wide and idempotent; a process whose
    meshes run NCCL never calls it. ``wire_bytes`` counts each kind's
    result bytes as this stand-in makes them (a reduce-scatter's
    all-reduce counts under both; the caller zeroes and reads it around a
    step)."""
    if device_type in _list_collectives_on:
        return
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def gather_parts(t, pg):
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(pg))]
        dist.all_gather(parts, t.contiguous(), group=pg)
        return parts

    def count(kind, t):
        wire_bytes[kind] = wire_bytes.get(kind, 0) + t.numel() * \
            t.element_size()
        return t

    def all_reduce(t, reduce_op, group_name):
        pg = _resolve_process_group(group_name)
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_reduce_op(reduce_op), group=pg)
        if reduce_op.lower() == "avg":
            out.div_(dist.get_world_size(pg))
        return count("all_reduce", out)

    def all_reduce_(t, reduce_op, group_name):
        t.copy_(all_reduce(t, reduce_op, group_name))
        return t

    def all_gather_into_tensor(t, group_size, group_name):
        pg = _resolve_process_group(group_name)
        return count("all_gather", torch.cat(gather_parts(t, pg), 0))

    def reduce_scatter_tensor(t, reduce_op, group_size, group_name):
        pg = _resolve_process_group(group_name)
        full = all_reduce(t, reduce_op, group_name)
        return count("reduce_scatter",
                     full.chunk(group_size, 0)[dist.get_rank(pg)].clone())

    def all_to_all_single(t, output_split_sizes, input_split_sizes,
                          group_name):
        pg = _resolve_process_group(group_name)
        n, me = dist.get_world_size(pg), dist.get_rank(pg)
        # every rank's input split sizes, then every rank's input (padded
        # to the longest); this rank keeps the piece each sent it
        sizes = torch.tensor(list(input_split_sizes) or
                             [t.shape[0] // n] * n, dtype=torch.int64,
                             device=t.device)
        all_sizes = torch.stack(gather_parts(sizes, pg)).tolist()
        rows = max(sum(r) for r in all_sizes)
        pad = t.new_zeros((rows, *t.shape[1:]))
        pad[:t.shape[0]] = t
        parts = gather_parts(pad, pg)
        out = []
        for i in range(n):
            start = sum(all_sizes[i][:me])
            out.append(parts[i][start:start + all_sizes[i][me]])
        return count("all_to_all", torch.cat(out, 0))

    def broadcast(t, src, group_name):
        pg = _resolve_process_group(group_name)
        out = t.clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, src=dist.get_global_rank(pg, src), group=pg)
        return count("broadcast", out)

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name, fn in (("all_reduce", all_reduce), ("all_reduce_", all_reduce_),
                     ("all_gather_into_tensor", all_gather_into_tensor),
                     ("reduce_scatter_tensor", reduce_scatter_tensor),
                     ("all_to_all_single", all_to_all_single),
                     ("broadcast", broadcast)):
        lib.impl(name, fn, device_type.upper())
    _list_collectives_on.add(device_type)
    _libs.append(lib)    # a Library's registrations live as long as it


_libs: list = []
