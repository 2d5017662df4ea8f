"""Shared building blocks of the LM substrate on PyTorch.

Port of ``repro/models/common.py`` (l.22-186). Every layer is an (init,
apply) pair; params are nested dicts of tensors with the reference's keys
and layouts: a dense weight is ``(d_in, d_out)``, applied as ``x @ W``, so
the JAX package's parameter trees cross by a copy (``models.bridge``).

``init_*`` draw from an ``Init``: a ``torch.Generator`` on a device and an
optional leading shape (the stacked groups of ``transformer.init_stack``),
so a stack of G layers is drawn as one tensor a leaf, in place, without a
second copy. The draws are ``torch``'s, not ``jax.random``'s; tests hand
both packages the same weights through the bridge.

The numerics follow the reference: norms compute in f32 and cast back
(rmsnorm eps 1e-6, layernorm eps 1e-5, ``rmsnorm_1p`` adds 1 to the
scale), RoPE rotates the two halves of the head (``jnp.split``), ``gelu``
is the tanh approximation and the logits are f32 over the padded vocab.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.utils import sharding as shd


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call context: the compute dtype, the device, and the mesh with
    its logical-axis rules. On a mesh, ``constrain`` redistributes an
    activation to the placements its logical spec resolves to (the
    reference's sharding constraints); without one it is the identity."""
    compute_dtype: torch.dtype = torch.bfloat16
    device: torch.device | str | None = None
    mesh: object = None
    rules: dict | None = None

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def constrain(self, x: torch.Tensor, *logical) -> torch.Tensor:
        return shd.constrain(x, self.mesh, *logical, rules=self.rules)


def problem_specs(tree, lead: int = 0):
    """Logical specs of a KV cache's leaves for its independent (sequence,
    kv head) problems: after ``lead`` leading dims, the batch over ``"dp"``
    and the kv heads over ``"tp"`` (dim 1 of the clustered leaves, dim 2 of
    a dense cache's ``k``, ``v`` and append buffers), every other dim whole;
    a leaf of fewer dims replicated."""
    def one(name, t):
        if t.ndim < lead + 2:
            return (None,) * t.ndim
        head = 2 if name in ("k", "v", "append_k", "append_v") else 1
        spec = [None] * t.ndim
        spec[lead], spec[lead + head] = "dp", "tp"
        return tuple(spec)
    return {k: one(k, t) for k, t in tree.items()}


# the (B, S, heads, head_dim) tensors of an attention core
HEADS = ("dp", None, "tp", None)


def on_problems(fn, ctx: Ctx, args: tuple, specs: tuple, out_specs,
                **sizes):
    """``fn(*args)``; on DTensors, on this rank's own problems
    (``shd.local``): each argument redistributed to the placements of its
    logical spec tree (None: passed as it is) under
    ``shd.problem_split(**sizes)`` (e.g. ``dp=B, tp=KH``), the result
    wrapped back at ``out_specs``' (or a function of the result giving
    them). For an attention core or scan whose
    (sequence, head) problems are independent: the local run is the
    one-device run of those problems, and DTensor's propagation is not
    relied on inside it."""
    from repro_torch.utils.tree import tree_leaves
    if not any(shd.is_dtensor(t) for t in tree_leaves(list(args))
               if isinstance(t, torch.Tensor)):
        return fn(*args)
    split = shd.problem_split(ctx.mesh, ctx.rules, **sizes)

    def pl(specs_):
        if specs_ is None:
            return None
        return shd.map_specs(
            lambda s: shd.problem_placements(s, split, ctx.mesh), specs_)
    out_pl = (lambda out: pl(out_specs(out))) if callable(out_specs) \
        else pl(out_specs)
    return shd.local(fn, args, tuple(pl(s) for s in specs), out_pl,
                     ctx.mesh)


def on_rows(fn, ctx: Ctx, params, *args):
    """``fn(params, *args)``; on DTensors, each rank runs the layer on its
    own batch rows with its weights whole (``shd.local``: the weights
    gathered, their gradients partial sums over the ``"dp"`` axes; every
    tensor argument and result with a batch dim split over ``"dp"``,
    0-dim ones replicated). For a layer whose ops DTensor's propagation
    does not carry (a recurrent scan, MLA's latent attention); ``fn``'s
    ``ctx`` must be a mesh-free one."""
    from repro_torch.utils.tree import tree_map
    if not shd.is_dtensor(args[0]):
        return fn(params, *args)
    mesh = ctx.mesh
    whole = shd.placements((), mesh)
    rows = shd.data_placements(mesh, 0, ctx.rules)

    def row_pl(t):
        return whole if t.ndim == 0 else rows
    p_pl = tree_map(lambda t: whole, params)
    g_pl = tree_map(lambda t: shd.partial_data(mesh, ctx.rules), params)
    a_pl = tuple(None if a is None else tree_map(row_pl, a) for a in args)
    return shd.local(fn, (params, *args), (p_pl, *a_pl),
                     lambda out: tree_map(row_pl, out), mesh,
                     in_grad_pl=(g_pl,) + (None,) * len(args))


@dataclasses.dataclass
class Init:
    """Draws parameters: ``normal(shape, scale)``, ``zeros``, ``ones``, each
    of shape ``lead + shape`` in f32 on the generator's device. Without a
    generator the tensors are shapes on the meta device and nothing is
    drawn (``launch.specs.abstract_state``): a ``torch.Generator`` cannot
    live there."""
    generator: torch.Generator | None
    lead: tuple = ()

    @property
    def device(self) -> torch.device:
        if self.generator is None:
            return torch.device("meta")
        return self.generator.device

    def normal(self, shape: tuple, scale: float) -> torch.Tensor:
        if self.generator is None:
            return torch.empty((*self.lead, *shape), device="meta")
        return torch.randn((*self.lead, *shape), generator=self.generator,
                           device=self.device).mul_(scale)

    def zeros(self, shape: tuple) -> torch.Tensor:
        return torch.zeros((*self.lead, *shape), device=self.device)

    def ones(self, shape: tuple) -> torch.Tensor:
        return torch.ones((*self.lead, *shape), device=self.device)


def dense_init(ini: Init, d_in: int, d_out: int, *,
               scale: float | None = None) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": ini.normal((d_in, d_out), scale)}


def dense_specs(spec=("fsdp", "tp")) -> dict:
    """The logical specs of ``dense_init``'s tree."""
    return {"w": spec}


def dense(params, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return x @ ctx.cast(params["w"])


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rmsnorm_init(ini: Init, d: int) -> dict:
    return {"scale": ini.ones((d,))}


def rmsnorm(params, x: torch.Tensor, ctx: Ctx, *, eps: float = 1e-6,
            plus_one: bool = False) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    s = params["scale"]
    if plus_one:   # gemma-style (1 + scale)
        s = 1.0 + s
    return (y * s).to(x.dtype)


def layernorm_init(ini: Init, d: int) -> dict:
    return {"scale": ini.ones((d,)), "bias": ini.zeros((d,))}


def layernorm(params, x: torch.Tensor, ctx: Ctx, *,
              eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def norm_specs(kind: str) -> dict:
    """The logical specs of ``norm_init``'s tree: replicated."""
    if kind in ("rmsnorm", "rmsnorm_1p"):
        return {"scale": (None,)}
    if kind == "layernorm":
        return {"scale": (None,), "bias": (None,)}
    raise ValueError(kind)


def _rmsnorm_1p(params, x, ctx):
    return rmsnorm(params, x, ctx, plus_one=True)


def norm_apply(kind: str):
    """The apply function of a norm kind."""
    if kind == "rmsnorm":
        return rmsnorm
    if kind == "rmsnorm_1p":
        return _rmsnorm_1p
    if kind == "layernorm":
        return layernorm
    raise ValueError(kind)


def norm_init(kind: str, d: int, ini: Init) -> dict:
    """The params of a norm kind; ``rmsnorm_1p`` starts at scale 0."""
    if kind == "rmsnorm":
        return rmsnorm_init(ini, d)
    if kind == "rmsnorm_1p":
        return {"scale": ini.zeros((d,))}
    if kind == "layernorm":
        return layernorm_init(ini, d)
    raise ValueError(kind)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, head_dim); positions: (..., S) int. The two halves of the
    head rotate together (``jnp.split``), not interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions.unsqueeze(-1).float() * freqs           # (..., S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def mlp_init(ini: Init, d: int, d_ff: int, *, kind: str = "glu") -> dict:
    if kind == "glu":
        return {"w_gate": ini.normal((d, d_ff), d ** -0.5),
                "w_up": ini.normal((d, d_ff), d ** -0.5),
                "w_down": ini.normal((d_ff, d), d_ff ** -0.5)}
    if kind == "plain":
        return {"w_up": ini.normal((d, d_ff), d ** -0.5),
                "b_up": ini.zeros((d_ff,)),
                "w_down": ini.normal((d_ff, d), d_ff ** -0.5),
                "b_down": ini.zeros((d,))}
    raise ValueError(kind)


def mlp_specs(kind: str = "glu") -> dict:
    """The logical specs of ``mlp_init``'s tree (ref. l.127-137)."""
    if kind == "glu":
        return {"w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
                "w_down": ("tp", "fsdp")}
    if kind == "plain":
        return {"w_up": ("fsdp", "tp"), "b_up": ("tp",),
                "w_down": ("tp", "fsdp"), "b_down": (None,)}
    raise ValueError(kind)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name in ("gelu", "gelu_tanh"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


def mlp(params, x: torch.Tensor, ctx: Ctx, *, kind: str = "glu",
        act: str = "silu") -> torch.Tensor:
    if kind == "glu":
        h = _act(act, x @ ctx.cast(params["w_gate"])) \
            * (x @ ctx.cast(params["w_up"]))
        h = ctx.constrain(h, "dp", None, "tp")
        return h @ ctx.cast(params["w_down"])
    h = _act(act, x @ ctx.cast(params["w_up"]) + ctx.cast(params["b_up"]))
    h = ctx.constrain(h, "dp", None, "tp")
    return h @ ctx.cast(params["w_down"]) + ctx.cast(params["b_down"])


# --------------------------------------------------------------------------
# Embeddings / LM head
# --------------------------------------------------------------------------

def embed_init(ini: Init, vocab_padded: int, d: int) -> dict:
    return {"embedding": ini.normal((vocab_padded, d), 0.02)}


def embed_specs() -> dict:
    """The logical specs of ``embed_init``'s tree (ref. l.172)."""
    return {"embedding": ("tp", "fsdp")}


class _GatherRows(torch.autograd.Function):
    """``table[ids]`` whose backward sums each row's gradients in a fixed
    order (``segment_sum_rows``): the gather's own backward accumulates
    repeated ids with atomics on a CUDA device, in no fixed order."""

    @staticmethod
    def forward(fctx, table, ids):
        fctx.save_for_backward(ids)
        fctx.rows = table.shape[0]
        return table.index_select(0, ids.reshape(-1)).reshape(
            *ids.shape, *table.shape[1:])

    @staticmethod
    def backward(fctx, grad):
        (ids,) = fctx.saved_tensors
        if shd.is_dtensor(grad):
            return _gather_rows_grad_on_mesh(grad, ids, fctx.rows), None
        return _gather_rows_grad(grad, ids, fctx.rows), None


def _gather_rows_grad(grad, ids, rows: int):
    g = grad.reshape(ids.numel(), -1)
    out = segment_sum_rows(g, ids.reshape(-1), rows)
    return out.reshape(rows, *grad.shape[ids.ndim:])


def _gather_rows_grad_on_mesh(grad, ids, rows: int):
    """The gather's backward on a mesh: ``segment_sum_rows`` has no DTensor
    rule (a boolean mask), so each rank sums its own tokens' rows
    (``shd.local``, the batch split over ``"dp"``) and the sum over ranks is
    left partial, for the step to reduce into the table's placements."""
    mesh = grad.device_mesh
    pl = shd.data_placements(mesh, 0)
    return shd.local(lambda g, i: _gather_rows_grad(g, i, rows),
                     (grad, ids), (pl, pl), shd.partial_data(mesh), mesh)


def segment_sum_rows(rows: torch.Tensor, ids: torch.Tensor,
                     n: int) -> torch.Tensor:
    """(n, d): out[i] = the sum of ``rows[j]`` over ``ids[j] == i``, the same
    bits from run to run. The rows sorted by id (a stable sort) are summed
    by a float64 prefix sum, each segment's sum the difference of its ends,
    rounded once to ``rows``' dtype; every id is written once.

    Shape-static (no boolean mask, no host read): each sorted row takes its
    prefix minus the prefix before its segment's first row, and writes it
    to its id if it ends a segment, else to a dropped bin ``n``."""
    ids_sorted, order = torch.sort(ids.long(), stable=True)
    cs = torch.cumsum(rows.index_select(0, order).double(), dim=0)
    pos = torch.arange(ids_sorted.numel(), device=ids.device)
    first = torch.ones_like(ids_sorted, dtype=torch.bool)
    first[1:] = ids_sorted[1:] != ids_sorted[:-1]
    last = torch.ones_like(first)
    last[:-1] = first[1:]
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    before = torch.where((start > 0)[:, None],
                         cs.index_select(0, (start - 1).clamp(min=0)), 0.0)
    sums = (cs - before).to(rows.dtype)
    out = rows.new_zeros((n + 1, rows.shape[1]))
    out.index_copy_(0, torch.where(last, ids_sorted, n), sums)
    return out[:n]


def embed(params, tokens: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return ctx.cast(_GatherRows.apply(params["embedding"], tokens.long()))


def unembed(params, x: torch.Tensor, ctx: Ctx, *,
            softcap: float | None = None) -> torch.Tensor:
    """Logits over the padded vocab, f32."""
    logits = (x @ ctx.cast(params["embedding"]).T).float()
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
