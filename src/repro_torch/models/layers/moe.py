"""Mixture-of-Experts: top-k routing with capacity-based einsum dispatch.

Port of ``repro/models/layers/moe.py`` (``moe_init`` l.20, ``moe`` l.36).
The reference's dispatch is plain ``jnp`` (dense one-hot einsums), not a
Pallas kernel, so this is plain PyTorch with the same arithmetic:

- tokens are cut into groups of ``gs = min(group_size, tokens)``; the
  reference asserts ``tokens % gs == 0`` and the port raises likewise (it
  never pads);
- ``lax.top_k`` takes the lower expert index on ties: a stable descending
  ``torch.sort``, never ``torch.topk``;
- a (token, slot) pair's place in its expert is a float32 cumsum over the
  group's tokens, slot by slot, so two slots of different tokens can share
  a place and are summed into it, as in the reference;
- ``jax.nn.one_hot(pos, capacity)`` gives a zero row where ``pos >=
  capacity`` (``F.one_hot`` would raise): the port compares ``pos`` with
  ``arange(capacity)``, which drops those pairs the same way.

Over a mesh the router and the places are DTensor ops; the three einsum
stages (dispatch, the experts' FFN, combine) run on each rank's own
(group, expert) problems (``shd.local``), groups over ``"dp"`` and experts
over ``"tp"``, with the reference's constraints between them.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import Ctx, Init, _act
from repro_torch.utils import sharding as shd


def moe_init(ini: Init, d_model: int, d_ff: int, num_experts: int) -> dict:
    e, d, f = num_experts, d_model, d_ff
    return {"router": ini.normal((d, e), d ** -0.5),
            "w_gate": ini.normal((e, d, f), d ** -0.5),
            "w_up": ini.normal((e, d, f), d ** -0.5),
            "w_down": ini.normal((e, f, d), f ** -0.5)}


def moe_specs() -> dict:
    """The logical specs of ``moe_init``'s tree (ref. l.29-32): the experts
    over ``"expert"``."""
    return {"router": ("fsdp", None),
            "w_gate": ("expert", "fsdp", None),
            "w_up": ("expert", "fsdp", None),
            "w_down": ("expert", None, "fsdp")}


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: rows of ``idx`` outside ``[0, n)`` are zero."""
    return (idx.unsqueeze(-1) == torch.arange(
        n, device=idx.device, dtype=idx.dtype)).float()


def route(logits: torch.Tensor, top_k: int):
    """Softmax over experts and the top ``top_k`` (ties to the lower index):
    (probs, top_p, top_i)."""
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, vals[..., :top_k], idx[..., :top_k]


def places(top_i: torch.Tensor, num_experts: int):
    """Each (token, slot) pair's place in its expert: the count of earlier
    tokens of the group whose same slot chose that expert (a float32
    cumsum). Returns (onehot (g,gs,k,e), pos (g,gs,k)); pairs whose place
    is past the capacity drop."""
    onehot = _one_hot(top_i, num_experts)
    pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
    return onehot, pos


def capacity(group: int, top_k: int, num_experts: int,
             capacity_factor: float = 1.25) -> int:
    """An expert's places in a group of ``group`` tokens (reference l.61);
    pairs past it drop."""
    return int(group * capacity_factor * top_k / num_experts) + 1


def moe(params, x: torch.Tensor, ctx: Ctx, *, num_experts: int, top_k: int,
        act: str = "silu", capacity_factor: float = 1.25,
        group_size: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). x: (B, S, D)."""
    b, s, d = x.shape
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    gs = min(group_size, t)
    if t % gs:
        raise ValueError(f"moe: {t} tokens are not a whole number of groups "
                         f"of {gs} (the reference asserts t % gs == 0)")
    g = t // gs
    xg = ctx.constrain(tokens.reshape(g, gs, d), "dp", None, None)

    logits = (xg @ ctx.cast(params["router"])).float()           # (g,gs,e)
    probs, top_p, top_i = route(logits, top_k)                   # (g,gs,k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch-style)
    me = probs.mean(dim=(0, 1))
    ce = (_one_hot(top_i[..., 0], num_experts).sum(1) / gs).mean(0)
    aux = num_experts * (me * ce).sum()

    cap = capacity(gs, top_k, num_experts, capacity_factor)
    onehot, pos = places(top_i, num_experts)
    fits = (pos < cap).float()
    weight = top_p * fits
    pos_oh = _one_hot(pos, cap)                                  # (g,gs,k,c)

    disp = torch.einsum("gske,gskc->gsec", onehot * fits.unsqueeze(-1),
                        pos_oh)
    comb = torch.einsum("gske,gskc,gsk->gsec", onehot, pos_oh, weight)

    ws = [ctx.cast(params[k]) for k in ("w_gate", "w_up", "w_down")]
    dt = ctx.compute_dtype
    if not shd.is_dtensor(xg):
        xe = _dispatch(disp.to(dt), xg)
        return _combine(comb.to(dt), _experts(xe, *ws, act=act)).reshape(
            b, s, d), aux
    # the einsums' views have no DTensor rule over these splits in every
    # torch: each runs on this rank's own (group, expert) problems
    mesh = ctx.mesh
    split = shd.problem_split(mesh, ctx.rules, dp=g, tp=num_experts)
    pl = lambda spec: shd.problem_placements(spec, split, mesh)  # noqa: E731
    gpl, gepl = pl(("dp",)), pl(("dp", "tp"))
    xe = shd.local(_dispatch, (disp.to(dt), xg), (gpl, gpl), gpl, mesh)
    xe = ctx.constrain(xe, "dp", "tp", None, None)
    # each rank's experts whole: their gradients partial over the split
    # groups' axes
    wpl = pl(("tp",))
    wgrad = shd.partial_over(split["dp"], wpl, mesh)
    ye = shd.local(lambda x_, *w_: _experts(x_, *w_, act=act),
                   (xe, *ws), (gepl, wpl, wpl, wpl), gepl, mesh,
                   in_grad_pl=(None, wgrad, wgrad, wgrad))
    ye = ctx.constrain(ye, "dp", "tp", None, None)
    y = shd.local(_combine, (comb.to(dt), ye), (pl(("dp", None, "tp")),
                                                gepl),
                  shd.partial_over(split["tp"], gpl, mesh), mesh)
    y = shd.to_placements(y, gpl)
    return y.reshape(b, s, d), aux


def _dispatch(disp, xg):
    return torch.einsum("gsec,gsd->gecd", disp, xg)


def _experts(xe, w_gate, w_up, w_down, *, act):
    h = (_act(act, torch.einsum("gecd,edf->gecf", xe, w_gate))
         * torch.einsum("gecd,edf->gecf", xe, w_up))
    return torch.einsum("gecf,efd->gecd", h, w_down)


def _combine(comb, ye):
    return torch.einsum("gsec,gecd->gsd", comb, ye)

