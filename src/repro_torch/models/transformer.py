"""The decoder stack of the dense-attention family.

Port of the attention parts of ``repro/models/transformer.py`` (l.41-469).
Layers are organized into groups, as in the reference:

  dense : group = [block] × num_layers
  gemma2: group = [local_attn_block, global_attn_block] × L/2

Params and caches keep the reference's trees: a group's sub-blocks are
keyed ``f"{i}_{sub}"`` and every leaf is stacked over the G groups (a
leading axis), so the JAX package's trees cross by a copy
(``models.bridge``) and the clustered-cache build batches over the groups.
``apply_stack`` is a Python loop over the groups (the reference's
``lax.scan``). A decode step writes its key and value into the stacked
cache tensors in place; a leaf a layer leaves in place is kept, any other
is restacked.

Not ported yet, and refused with ``NotImplementedError`` naming ROADMAP.md
queue A item 8a: the ``mlstm``, ``slstm``, ``mamba2`` and ``shared_attn``
sub-blocks (xLSTM, zamba2), MLA attention, MoE, and cross-attention.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import kmeans as _km
from repro_torch.models import common
from repro_torch.models.common import Ctx, Init, not_ported
from repro_torch.models.layers import attention as attn

_ATTN_SUBS = ("block", "attn_local", "attn_global")


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


def check_ported(cfg: ArchConfig) -> None:
    """Raise for the families and parts outside the dense-attention
    family."""
    if cfg.family in ("moe", "ssm", "hybrid", "vlm", "audio"):
        raise not_ported(f"the {cfg.family} family ({cfg.name})")
    if cfg.attention == "mla":
        raise not_ported(f"MLA attention ({cfg.name})")
    if cfg.num_experts:
        raise not_ported(f"MoE layers ({cfg.name})")
    if cfg.cross_attention or cfg.frontend or cfg.learned_pos \
            or cfg.encoder_layers:
        raise not_ported(f"encoders, frontends and cross-attention "
                         f"({cfg.name})")


# ---------------------------------------------------------------------------
# Single sub-block init/apply
# ---------------------------------------------------------------------------

def init_subblock(ini: Init, cfg: ArchConfig, sub: str) -> dict:
    check_ported(cfg)
    if sub not in _ATTN_SUBS:
        raise not_ported(f"the {sub} sub-block")
    d = cfg.d_model
    params = {"norm_attn": common.norm_init(cfg.norm, d, ini),
              "attn": attn.attn_init(ini, d, cfg.num_heads, cfg.num_kv_heads,
                                     cfg.resolved_head_dim,
                                     qkv_bias=cfg.qkv_bias)}
    if cfg.post_norm:
        params["postnorm_attn"] = common.norm_init(cfg.norm, d, ini)
        params["postnorm_mlp"] = common.norm_init(cfg.norm, d, ini)
    params["norm_mlp"] = common.norm_init(cfg.norm, d, ini)
    params["mlp"] = (common.mlp_init(ini, d, cfg.d_ff, kind=cfg.mlp_kind)
                     if cfg.mlp_kind != "none" else {})
    return params


def _norm(cfg: ArchConfig, params, x, ctx):
    return common.norm_apply(cfg.norm)(params, x, ctx)


def apply_subblock(params, x: torch.Tensor, ctx: Ctx, cfg: ArchConfig,
                   sub: str, *, positions=None, cache=None, causal=True):
    """Returns (x_out, new_cache, aux_loss)."""
    aux = torch.zeros((), device=x.device)
    h = _norm(cfg, params["norm_attn"], x, ctx)
    window = cfg.window_size if sub == "attn_local" else None
    rope_theta = None if cfg.learned_pos else cfg.rope_theta
    if cfg.kmeans_attn and cache is None and causal:
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
    h = _norm(cfg, params["norm_mlp"], x, ctx)
    if cfg.mlp_kind != "none":
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
    """Train-time cluster-routed sparse attention (cfg.kmeans_attn),
    forward only: flash-kmeans over keys per head, window + same-cluster
    coverage, with the plain dataflows (``impl="ref"``) as the reference."""
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
    o = kma.kmeans_routed_attention(
        q, k, v, clusters=cfg.kv_cluster_k,
        window=min(cfg.window_size, max(32, s // 8)),
        scale=cfg.query_scale, impl="ref")
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

def tree_map(fn, tree):
    """``fn`` on every tensor leaf of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_stack(ini: Init, cfg: ArchConfig) -> dict:
    """Params of the decoder stack (no embeddings): every leaf drawn once
    with a leading axis of the G groups."""
    check_ported(cfg)
    subs, n_groups = group_layout(cfg)
    gi = Init(ini.generator, (*ini.lead, n_groups))
    return {"groups": {f"{i}_{sub}": init_subblock(gi, cfg, sub)
                       for i, sub in enumerate(subs)}}


def _aliases(new: torch.Tensor, old: torch.Tensor) -> bool:
    return (new.shape == old.shape and new.dtype == old.dtype
            and new.numel() > 0 and new.data_ptr() == old.data_ptr()
            and new.stride() == old.stride())


def _restack(old: dict | None, per_group: list[dict]) -> dict:
    """Stack one sub-block's per-group caches over the groups. A leaf that
    every group's layer left in place (a view of the stacked ``old``
    leaf) keeps the stacked tensor; any other leaf is stacked anew."""
    out = {}
    for name in per_group[0]:
        leaves = [c[name] for c in per_group]
        stacked = None if old is None else old.get(name)
        if stacked is not None and all(
                _aliases(t, stacked[g]) for g, t in enumerate(leaves)):
            out[name] = stacked
        else:
            out[name] = torch.stack(leaves)
    return out


def apply_stack(params, x: torch.Tensor, ctx: Ctx, cfg: ArchConfig, *,
                positions=None, caches=None, causal=True):
    """Run all groups. ``caches``: the stacked tree (leading group axis),
    ``{key: {}}`` to build caches at prefill, or None. Returns (x,
    new_caches, aux_loss)."""
    check_ported(cfg)
    subs, n_groups = group_layout(cfg)
    groups = params["groups"]
    aux = torch.zeros((), device=x.device)
    new: dict[str, list] = {}
    for g in range(n_groups):
        for i, sub in enumerate(subs):
            key = f"{i}_{sub}"
            p = tree_map(lambda t: t[g], groups[key])
            c = None
            if caches is not None and key in caches:
                c = {n: t[g] for n, t in caches[key].items()}
            x, nc, a = apply_subblock(p, x, ctx, cfg, sub,
                                      positions=positions, cache=c,
                                      causal=causal)
            if nc is not None:
                new.setdefault(key, []).append(nc)
            aux = aux + a
        x = ctx.constrain(x, "dp", None, None)
    new_caches = {key: _restack(None if caches is None else caches.get(key),
                                cs) for key, cs in new.items()}
    return x, (new_caches or None), aux


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, *, local_ring: bool = False,
               split_append: int = 0, device=None) -> dict:
    """Stacked decode caches for all groups (the dense layout).

    ``local_ring``: sliding-window layers get a ring buffer of
    ``window_size`` slots instead of a full-length cache (decode only:
    prefill builds full caches). ``split_append``: a frozen bulk plus an
    append buffer of that many slots. ``device`` defaults to ``"cuda"``."""
    check_ported(cfg)
    device = _km.resolve_device(device)
    subs, n_groups = group_layout(cfg)
    hd, kh = cfg.resolved_head_dim, cfg.num_kv_heads

    def z(*shape, dt=dtype):
        return torch.zeros((n_groups, *shape), dtype=dt, device=device)

    def one(sub):
        if sub == "attn_local" and local_ring and max_seq > cfg.window_size:
            w = cfg.window_size
            return {"k": z(batch, w, kh, hd), "v": z(batch, w, kh, hd),
                    "pos": z(dt=torch.int32),
                    "ring": torch.ones((n_groups,), dtype=torch.bool,
                                       device=device)}
        out = {"k": z(batch, max_seq, kh, hd), "v": z(batch, max_seq, kh, hd),
               "pos": z(dt=torch.int32)}
        if split_append:
            out.update(append_k=z(batch, split_append, kh, hd),
                       append_v=z(batch, split_append, kh, hd),
                       rlen=z(dt=torch.int32),
                       blen=torch.full((n_groups,), max_seq,
                                       dtype=torch.int32, device=device))
        return out

    return {f"{i}_{sub}": one(sub) for i, sub in enumerate(subs)}
