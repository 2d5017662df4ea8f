"""The decoder stack of every architecture family.

Port of ``repro/models/transformer.py``. Layers are organized into groups,
as in the reference:

  dense/moe/vlm/audio : group = [block] × num_layers
  gemma2              : group = [local_attn_block, global_attn_block] × L/2
  xlstm               : group = [mLSTM × (k-1), sLSTM] × L/k
  zamba2              : group = [mamba2, mamba2, shared_attn_block] × L/3
                        (the shared block's params stored once, under
                        ``params["stack"]["shared"]``, and applied at every
                        third position)

Params and caches keep the reference's trees: a group's sub-blocks are
keyed ``f"{i}_{sub}"`` and every leaf is stacked over the G groups (a
leading axis), so the JAX package's trees cross by a copy
(``models.bridge``) and the clustered-cache build batches over the groups.
The recurrent caches hold tuples (``{"mlstm": (C_hat, n_hat, m)}``,
``{"slstm": (c, n, m, h)}``), each member stacked. ``apply_stack`` is a
Python loop over the groups (the reference's ``lax.scan``). A decode step
writes its key and value into the stacked cache tensors in place; a leaf a
layer leaves in place is kept, any other is restacked. A mesh (the
reference's sharding constraints) is refused with ``NotImplementedError``
naming ROADMAP.md queue A item 8a.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import kmeans as _km
from repro_torch.models import common
from repro_torch.models.common import Ctx, Init, not_ported
from repro_torch.models.layers import attention as attn
from repro_torch.models.layers import mamba2 as m2
from repro_torch.models.layers import mla as mla_mod
from repro_torch.models.layers import moe as moe_mod
from repro_torch.models.layers import xlstm as xl
from repro_torch.utils.tree import tree_map

_RECURRENT = ("mlstm", "slstm", "mamba2")
# MLA's fixed geometry (the reference's init_subblock, l.89-91)
MLA = {"q_lora_rank": 768, "kv_lora_rank": 256, "nope_head_dim": 64,
       "rope_head_dim": 32, "v_head_dim": 64}


# ---------------------------------------------------------------------------
# Group structure
# ---------------------------------------------------------------------------

def group_layout(cfg: ArchConfig) -> tuple[list[str], int]:
    """Returns (sub-block kinds within one group, number of groups)."""
    if cfg.family == "ssm":
        k = cfg.slstm_every or cfg.num_layers
        assert cfg.num_layers % k == 0
        return ["mlstm"] * (k - 1) + ["slstm"], cfg.num_layers // k
    if cfg.family == "hybrid":
        e = cfg.hybrid_attn_every
        assert cfg.num_layers % e == 0
        return ["mamba2"] * (e - 1) + ["shared_attn"], cfg.num_layers // e
    if cfg.attention == "local_global":
        assert cfg.num_layers % 2 == 0
        return ["attn_local", "attn_global"], cfg.num_layers // 2
    return ["block"], cfg.num_layers


def check_ported(cfg: ArchConfig, mesh=None) -> None:
    """Every family is served on one device; an LM over a mesh (``Engine(
    mesh=...)``) raises."""
    if mesh is not None:
        raise not_ported(f"serving an LM over a mesh ({cfg.name})")


# ---------------------------------------------------------------------------
# Single sub-block init/apply
# ---------------------------------------------------------------------------

def init_subblock(ini: Init, cfg: ArchConfig, sub: str) -> dict:
    d = cfg.d_model
    if sub in _RECURRENT:
        norm = common.norm_init(cfg.norm, d, ini)
        if sub == "mlstm":
            core = xl.mlstm_init(ini, d, cfg.num_heads,
                                 proj_factor=cfg.mlstm_proj_factor)
        elif sub == "slstm":
            core = xl.slstm_init(ini, d, cfg.num_heads)
        else:
            core = m2.mamba2_init(ini, d, expand=cfg.ssm_expand,
                                  head_dim=cfg.ssm_head_dim,
                                  d_state=cfg.ssm_state,
                                  conv_width=cfg.ssm_conv_width)
        return {"norm": norm, "core": core}

    # attention (+MLP/MoE) transformer block
    params = {"norm_attn": common.norm_init(cfg.norm, d, ini)}
    if cfg.attention == "mla":
        params["attn"] = mla_mod.mla_init(ini, d, cfg.num_heads, **MLA)
    else:
        params["attn"] = attn.attn_init(ini, d, cfg.num_heads,
                                        cfg.num_kv_heads,
                                        cfg.resolved_head_dim,
                                        qkv_bias=cfg.qkv_bias)
    if cfg.post_norm:
        params["postnorm_attn"] = common.norm_init(cfg.norm, d, ini)
        params["postnorm_mlp"] = common.norm_init(cfg.norm, d, ini)
    params["norm_mlp"] = common.norm_init(cfg.norm, d, ini)
    if cfg.num_experts:
        params["mlp"] = moe_mod.moe_init(ini, d, cfg.d_ff, cfg.num_experts)
    elif cfg.mlp_kind != "none":
        params["mlp"] = common.mlp_init(ini, d, cfg.d_ff, kind=cfg.mlp_kind)
    else:
        params["mlp"] = {}
    if cfg.cross_attention:
        params["cross"] = attn.attn_init(ini, d, cfg.num_heads,
                                         cfg.num_kv_heads,
                                         cfg.resolved_head_dim,
                                         qkv_bias=cfg.qkv_bias)
        params["norm_cross"] = common.norm_init(cfg.norm, d, ini)
    return params


def _norm(cfg: ArchConfig, params, x, ctx):
    return common.norm_apply(cfg.norm)(params, x, ctx)


def apply_subblock(params, x: torch.Tensor, ctx: Ctx, cfg: ArchConfig,
                   sub: str, *, positions=None, cache=None, cross_kv=None,
                   causal=True):
    """Returns (x_out, new_cache, aux_loss)."""
    aux = torch.zeros((), device=x.device)
    if sub in _RECURRENT:
        h = _norm(cfg, params["norm"], x, ctx)
        if sub == "mlstm":
            y, nc = xl.mlstm(params["core"], h, ctx, num_heads=cfg.num_heads,
                             chunk=cfg.ssm_chunk, cache=cache)
        elif sub == "slstm":
            y, nc = xl.slstm(params["core"], h, ctx, num_heads=cfg.num_heads,
                             cache=cache)
        else:
            y, nc = m2.mamba2(params["core"], h, ctx,
                              head_dim=cfg.ssm_head_dim,
                              d_state=cfg.ssm_state,
                              conv_width=cfg.ssm_conv_width,
                              chunk=cfg.ssm_chunk, cache=cache)
        return x + y, nc, aux

    # transformer block
    h = _norm(cfg, params["norm_attn"], x, ctx)
    window = cfg.window_size if sub == "attn_local" else None
    rope_theta = None if cfg.learned_pos else cfg.rope_theta
    if cfg.attention == "mla":
        y, nc = mla_mod.mla_attention(
            params["attn"], h, ctx, num_heads=cfg.num_heads,
            nope_head_dim=MLA["nope_head_dim"],
            rope_head_dim=MLA["rope_head_dim"],
            v_head_dim=MLA["v_head_dim"], kv_lora_rank=MLA["kv_lora_rank"],
            rope_theta=cfg.rope_theta, positions=positions, cache=cache)
    elif cfg.kmeans_attn and cache is None and causal:
        y, nc = _routed_train_attention(params["attn"], h, ctx, cfg,
                                        rope_theta, positions)
    elif isinstance(cache, dict) and "centroids" in cache:
        y, nc = _clustered_decode(params["attn"], h, ctx, cfg, cache,
                                  rope_theta)
    elif isinstance(cache, dict) and "blen" in cache:
        y, nc = _split_decode(params["attn"], h, ctx, cfg, cache,
                              rope_theta, window=window)
    elif isinstance(cache, dict) and "ring" in cache:
        y, nc = _ring_decode(params["attn"], h, ctx, cfg, cache,
                             rope_theta, window=cfg.window_size)
    else:
        y, nc = attn.self_attention(
            params["attn"], h, ctx, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            causal=causal, rope_theta=rope_theta, window=window,
            softcap=cfg.attn_softcap, scale=cfg.query_scale,
            positions=positions, cache=cache)
    if cfg.post_norm:
        y = _norm(cfg, params["postnorm_attn"], y, ctx)
    x = x + y
    if cross_kv is not None:
        h = _norm(cfg, params["norm_cross"], x, ctx)
        x = x + attn.cross_attention(params["cross"], h, cross_kv, ctx,
                                     num_heads=cfg.num_heads,
                                     num_kv_heads=cfg.num_kv_heads,
                                     head_dim=cfg.resolved_head_dim)
    h = _norm(cfg, params["norm_mlp"], x, ctx)
    if cfg.num_experts:
        y, aux = moe_mod.moe(params["mlp"], h, ctx,
                             num_experts=cfg.num_experts,
                             top_k=cfg.experts_per_token, act=cfg.act,
                             group_size=cfg.moe_group_size)
    elif cfg.mlp_kind != "none":
        y = common.mlp(params["mlp"], h, ctx, kind=cfg.mlp_kind, act=cfg.act)
    else:
        y = torch.zeros_like(x)
    if cfg.post_norm:
        y = _norm(cfg, params["postnorm_mlp"], y, ctx)
    return x + y, nc, aux


def _rope_at(q, k, pos, rope_theta):
    """RoPE of a one-token step at the device scalar ``pos``."""
    if rope_theta is None:
        return q, k
    b, s = q.shape[0], q.shape[1]
    pq = pos.to(torch.int32).reshape(1, 1).expand(b, s)
    return (attn._rope_bshd(q, pq, rope_theta),
            attn._rope_bshd(k, pq, rope_theta))


def _routed_train_attention(p, h, ctx: Ctx, cfg: ArchConfig, rope_theta,
                            positions):
    """Train-time cluster-routed sparse attention (cfg.kmeans_attn):
    flash-kmeans over keys per head, window + same-cluster coverage,
    differentiable in q, k and v (the clustering detached). On a CUDA
    tensor the fit and the queries' assignment run the kernels
    (``impl="flash"``), on the CPU the plain dataflows (``impl="ref"``)."""
    from repro_torch.models import kmeans_attention as kma
    b, s, _ = h.shape
    q, k, v = attn.project_qkv(p, h, ctx, num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads,
                               head_dim=cfg.resolved_head_dim)
    if positions is None:
        positions = torch.arange(s, device=h.device).unsqueeze(0).expand(b, s)
    if rope_theta is not None:
        q = attn._rope_bshd(q, positions, rope_theta)
        k = attn._rope_bshd(k, positions, rope_theta)
    groups = cfg.num_heads // cfg.num_kv_heads
    k = attn._expand_kv(k, groups)
    v = attn._expand_kv(v, groups)
    impl = "flash" if h.is_cuda else "ref"
    o = kma.kmeans_routed_attention(
        q, k, v, clusters=cfg.kv_cluster_k,
        window=min(cfg.window_size, max(32, s // 8)),
        scale=cfg.query_scale, impl=impl)
    return attn.attn_out(p, o, ctx), None


def _clustered_decode(p, h, ctx: Ctx, cfg: ArchConfig, cache: dict,
                      rope_theta):
    """One-token decode against a flash-kmeans clustered KV cache."""
    from repro_torch.models import kmeans_attention as kma
    q, k, v = attn.project_qkv(p, h, ctx, num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads,
                               head_dim=cfg.resolved_head_dim)
    q, k = _rope_at(q, k, cache["pos"], rope_theta)
    o, nc = kma.clustered_decode_attention(
        q, k, v, cache, top=cfg.kv_cluster_top,
        softcap=cfg.attn_softcap, scale=cfg.query_scale)
    return attn.attn_out(p, o, ctx), nc


def _split_decode(p, h, ctx: Ctx, cfg: ArchConfig, cache: dict, rope_theta,
                  *, window=None):
    """Split-KV decode: the prefix cache is frozen (populated at prefill),
    new tokens append to a small ``append`` buffer; one joint softmax over
    [bulk ++ recent]."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q, k, v = attn.project_qkv(p, h, ctx, num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads, head_dim=hd)
    pos = cache["pos"]
    q, k = _rope_at(q, k, pos, rope_theta)
    rlen = cache["rlen"]
    rk = attn.update_slice(cache["append_k"], k, rlen, 1)
    rv = attn.update_slice(cache["append_v"], v, rlen, 1)

    kh = cfg.num_kv_heads
    g = cfg.num_heads // kh
    scale = cfg.query_scale if cfg.query_scale is not None else hd ** -0.5
    qf = q.reshape(b, kh, g, hd)

    def scores_of(kc):
        sc = torch.einsum("bkgd,bskd->bkgs", qf, kc).float() * scale
        if cfg.attn_softcap is not None:
            sc = torch.tanh(sc / cfg.attn_softcap) * cfg.attn_softcap
        return sc

    sb = scores_of(cache["k"])                       # (B,KH,G,S_bulk)
    sr = scores_of(rk)                               # (B,KH,G,R)
    blen = cache["blen"]
    kpos_b = torch.arange(cache["k"].shape[1], device=h.device)
    valid_b = kpos_b < blen
    valid_r = torch.arange(rk.shape[1], device=h.device) <= rlen
    if window is not None:
        valid_b = valid_b & (kpos_b > pos - window)
    sb = torch.where(valid_b, sb, attn.NEG_INF)
    sr = torch.where(valid_r, sr, attn.NEG_INF)
    m = torch.maximum(sb.amax(-1, keepdim=True), sr.amax(-1, keepdim=True))
    eb, er = torch.exp(sb - m), torch.exp(sr - m)
    denom = eb.sum(-1, keepdim=True) + er.sum(-1, keepdim=True)
    ob = torch.einsum("bkgs,bskd->bkgd", (eb / denom).to(cache["v"].dtype),
                      cache["v"])
    orc = torch.einsum("bkgs,bskd->bkgd", (er / denom).to(rv.dtype), rv)
    o = (ob + orc).reshape(b, 1, cfg.num_heads, hd)
    nc = dict(cache, append_k=rk, append_v=rv, rlen=rlen + 1, pos=pos + s)
    return attn.attn_out(p, o, ctx), nc


def _ring_decode(p, h, ctx: Ctx, cfg: ArchConfig, cache: dict, rope_theta,
                 *, window: int):
    """Sliding-window decode with a ring-buffer cache of ``window`` slots."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q, k, v = attn.project_qkv(p, h, ctx, num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads, head_dim=hd)
    pos = cache["pos"]
    q, k = _rope_at(q, k, pos, rope_theta)
    slot = torch.remainder(pos, window)
    k_c = attn.update_slice(cache["k"], k, slot, 1)
    v_c = attn.update_slice(cache["v"], v, slot, 1)
    kh = cfg.num_kv_heads
    ke = attn._expand_kv(k_c, cfg.num_heads // kh)
    ve = attn._expand_kv(v_c, cfg.num_heads // kh)
    scale = cfg.query_scale if cfg.query_scale is not None else hd ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, ke).float() * scale
    if cfg.attn_softcap is not None:
        scores = torch.tanh(scores / cfg.attn_softcap) * cfg.attn_softcap
    valid = torch.arange(window, device=h.device) <= pos   # filled slots
    scores = torch.where(valid, scores, attn.NEG_INF)
    w = torch.softmax(scores, dim=-1).to(ve.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", w, ve)
    nc = dict(cache, k=k_c, v=v_c, pos=pos + s)
    return attn.attn_out(p, o, ctx), nc


# ---------------------------------------------------------------------------
# Full stack
# ---------------------------------------------------------------------------

def init_stack(ini: Init, cfg: ArchConfig) -> dict:
    """Params of the decoder stack (no embeddings): every leaf of the
    groups drawn once with a leading axis of the G groups; zamba2's shared
    block drawn once, unstacked, under ``"shared"``."""
    subs, n_groups = group_layout(cfg)
    gi = Init(ini.generator, (*ini.lead, n_groups))
    params = {"groups": {f"{i}_{sub}": init_subblock(gi, cfg, sub)
                         for i, sub in enumerate(subs)
                         if sub != "shared_attn"}}
    if "shared_attn" in subs:
        params["shared"] = init_subblock(ini, cfg, "shared_attn")
    return params


def _aliases(new: torch.Tensor, old: torch.Tensor) -> bool:
    return (new.shape == old.shape and new.dtype == old.dtype
            and new.numel() > 0 and new.data_ptr() == old.data_ptr()
            and new.stride() == old.stride())


def _stack_leaf(old, leaves: list):
    """Stack one leaf's per-group values (a tensor, or a tuple of them)
    over the groups. A tensor that every group's layer left in place (a
    view of the stacked ``old``) keeps the stacked tensor; any other is
    stacked anew."""
    if isinstance(leaves[0], tuple):
        return tuple(_stack_leaf(None if old is None else old[j],
                                 [lf[j] for lf in leaves])
                     for j in range(len(leaves[0])))
    if old is not None and all(_aliases(t, old[g])
                               for g, t in enumerate(leaves)):
        return old
    return torch.stack(leaves)


def _restack(old: dict | None, per_group: list[dict]) -> dict:
    """Stack one sub-block's per-group caches over the groups."""
    return {name: _stack_leaf(None if old is None else old.get(name),
                              [c[name] for c in per_group])
            for name in per_group[0]}


def unstack(tree, n_groups: int) -> list:
    """The per-group trees of a stacked tree: every leaf unbound once over
    its leading group axis. Each group's leaves are views, as ``t[g]``
    would give; under autograd the unbind's backward is one ``stack`` of
    the groups' gradients, where a ``t[g]`` per group would add a zero
    tensor the size of the whole stacked leaf for each group."""
    if isinstance(tree, dict):
        per = {k: unstack(v, n_groups) for k, v in tree.items()}
        return [{k: per[k][g] for k in tree} for g in range(n_groups)]
    if isinstance(tree, (tuple, list)):
        per = [unstack(v, n_groups) for v in tree]
        return [type(tree)(p[g] for p in per) for g in range(n_groups)]
    return list(tree.unbind(0))


def apply_stack(params, x: torch.Tensor, ctx: Ctx, cfg: ArchConfig, *,
                positions=None, caches=None, cross_kv=None, causal=True,
                remat: bool = False):
    """Run all groups. ``caches``: the stacked tree (leading group axis),
    with ``{}`` for an attention sub-block to build its cache at prefill,
    or None. ``cross_kv``: whisper's per-group encoder keys and values
    (``{key: {"k", "v"}}``, stacked). ``remat``: each group's forward runs
    under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``
    of the group body), its activations recomputed in the backward with
    the RNG state it saw. Returns (x, new_caches, aux_loss)."""
    subs, n_groups = group_layout(cfg)
    per_group = unstack(params["groups"], n_groups)
    shared = params.get("shared")
    aux = torch.zeros((), device=x.device)
    new: dict[str, list] = {}

    def group_body(g, x, aux):
        at = lambda t: t[g]                                # noqa: E731
        ncs = {}
        for i, sub in enumerate(subs):
            key = f"{i}_{sub}"
            p = shared if sub == "shared_attn" else per_group[g][key]
            c = None
            if caches is not None and key in caches:
                c = tree_map(at, caches[key])
            ck = None
            if cross_kv is not None and key in cross_kv:
                ck = tree_map(at, cross_kv[key])
            x, nc, a = apply_subblock(p, x, ctx, cfg, sub,
                                      positions=positions, cache=c,
                                      cross_kv=ck, causal=causal)
            if nc is not None:
                ncs[key] = nc
            aux = aux + a
        return ctx.constrain(x, "dp", None, None), aux, ncs

    for g in range(n_groups):
        if remat:
            x, aux, ncs = torch.utils.checkpoint.checkpoint(
                group_body, g, x, aux, use_reentrant=False,
                preserve_rng_state=True)
        else:
            x, aux, ncs = group_body(g, x, aux)
        for key, nc in ncs.items():
            new.setdefault(key, []).append(nc)
    new_caches = {key: _restack(None if caches is None else caches.get(key),
                                cs) for key, cs in new.items()}
    return x, (new_caches or None), aux


def subblock_cache(cfg: ArchConfig, sub: str, batch: int, max_seq: int,
                   dtype=torch.bfloat16, *, local_ring: bool = False,
                   split_append: int = 0, device=None) -> dict:
    """One sub-block's zero decode cache (no group axis), the reference's
    ``init_cache.one`` (l.410-464)."""
    hd, kh = cfg.resolved_head_dim, cfg.num_kv_heads

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if sub == "mamba2":
        d_inner = cfg.ssm_expand * cfg.d_model
        nh = d_inner // cfg.ssm_head_dim
        return {"ssm": z(batch, nh, cfg.ssm_head_dim, cfg.ssm_state,
                         dt=torch.float32),
                "conv": z(batch, cfg.ssm_conv_width - 1,
                          d_inner + 2 * cfg.ssm_state)}
    if sub == "mlstm":
        xl_hd = int(cfg.d_model * cfg.mlstm_proj_factor) // cfg.num_heads
        f32 = torch.float32
        return {"mlstm": (z(batch, cfg.num_heads, xl_hd, xl_hd, dt=f32),
                          z(batch, cfg.num_heads, xl_hd, dt=f32),
                          z(batch, cfg.num_heads, dt=f32))}
    if sub == "slstm":
        dh = cfg.d_model // cfg.num_heads
        return {"slstm": tuple(z(batch, cfg.num_heads, dh, dt=torch.float32)
                               for _ in range(4))}
    if sub not in ("block", "attn_local", "attn_global", "shared_attn"):
        raise ValueError(sub)
    if cfg.attention == "mla":
        return {"latent": z(batch, max_seq, MLA["kv_lora_rank"]),
                "k_rope": z(batch, max_seq, MLA["rope_head_dim"]),
                "pos": z(dt=torch.int32)}
    if sub == "attn_local" and local_ring and max_seq > cfg.window_size:
        w = cfg.window_size
        return {"k": z(batch, w, kh, hd), "v": z(batch, w, kh, hd),
                "pos": z(dt=torch.int32),
                "ring": torch.ones((), dtype=torch.bool, device=device)}
    out = {"k": z(batch, max_seq, kh, hd), "v": z(batch, max_seq, kh, hd),
           "pos": z(dt=torch.int32)}
    if split_append:
        out.update(append_k=z(batch, split_append, kh, hd),
                   append_v=z(batch, split_append, kh, hd),
                   rlen=z(dt=torch.int32),
                   blen=torch.full((), max_seq, dtype=torch.int32,
                                   device=device))
    return out


def stack_groups(cache: dict, n_groups: int) -> dict:
    """A sub-block's cache repeated over the G groups (a leading axis)."""
    return tree_map(lambda t: t.expand(n_groups, *t.shape).clone(), cache)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, local_ring: bool = False,
               split_append: int = 0, device=None) -> dict:
    """Stacked decode caches for all groups (the dense layout).

    ``local_ring``: sliding-window layers get a ring buffer of
    ``window_size`` slots instead of a full-length cache (decode only:
    prefill builds full caches). ``split_append``: a frozen bulk plus an
    append buffer of that many slots. The recurrent sub-blocks get their
    zero states. ``device`` defaults to ``"cuda"``."""
    device = _km.resolve_device(device)
    subs, n_groups = group_layout(cfg)
    return {f"{i}_{sub}": stack_groups(subblock_cache(
        cfg, sub, batch, max_seq, dtype, local_ring=local_ring,
        split_append=split_append, device=device), n_groups)
        for i, sub in enumerate(subs)}
