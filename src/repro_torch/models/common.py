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


def not_ported(what: str) -> NotImplementedError:
    """The refusal of every part of the LM substrate still to come."""
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               "queue A item 8a)")


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call context: the compute dtype and the device. A mesh (the
    reference's sharding constraints) is refused where it would act."""
    compute_dtype: torch.dtype = torch.bfloat16
    device: torch.device | str | None = None
    mesh: object = None

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def constrain(self, x: torch.Tensor, *logical) -> torch.Tensor:
        if self.mesh is None:
            return x
        raise not_ported("the LM sharding constraints (Ctx with a mesh)")


@dataclasses.dataclass
class Init:
    """Draws parameters: ``normal(shape, scale)``, ``zeros``, ``ones``, each
    of shape ``lead + shape`` in f32 on the generator's device."""
    generator: torch.Generator
    lead: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def normal(self, shape: tuple, scale: float) -> torch.Tensor:
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


def embed(params, tokens: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    return ctx.cast(params["embedding"][tokens.long()])


def unembed(params, x: torch.Tensor, ctx: Ctx, *,
            softcap: float | None = None) -> torch.Tensor:
    """Logits over the padded vocab, f32."""
    logits = (x @ ctx.cast(params["embedding"]).T).float()
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
