"""Model facade of every architecture family: embeddings + stack +
prefill/decode, including whisper's encoder and cross-attention and the
stubbed phi-3-vision / audio frontends.

Port of ``repro/models/model.py`` (l.30-324). Decode modes:

  "dense"     — the standard per-layer KV cache
  "clustered" — the flash-kmeans clustered-KV sparse decode
                (``models.kmeans_attention``) for the attention layers;
                MLA keeps its dense latents, the recurrent sub-blocks
                (Mamba2, xLSTM) their dense states

``init_model`` draws the parameters from a ``torch.Generator`` (seeded with
``seed``) on ``device``, ``cuda`` unless the caller asks for the CPU; the
numbers differ from ``jax.random``'s, and ``models.bridge`` carries the JAX
package's trees across. ``prefill`` returns the reference's ``(logits,
caches, cross_kv)``; ``decode_step`` writes into the caches it is given in
place and returns them. ``loss_fn`` is the training objective: the masked
next-token NLL plus ``0.01 *`` the MoE load-balancing loss, with the stack
under ``remat`` (``transformer.apply_stack``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.kmeans import resolve_device
from repro_torch.models import common, transformer
from repro_torch.models import kmeans_attention as kma
from repro_torch.models.common import Ctx, Init
from repro_torch.models.layers import attention as attn_mod
from repro_torch.utils.tree import tree_leaves


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, num_layers=cfg.encoder_layers,
                               cross_attention=False, family="dense",
                               attention="gqa")


def init_model(cfg: ArchConfig, *, seed: int = 0,
               generator: torch.Generator | None = None,
               device=None, max_pos: int = 32768) -> dict:
    """The parameter tree, in f32: ``embed``, ``lm_head`` (untied configs),
    ``pos_embed`` (learned positions: ``max_pos`` rows), ``frontend`` (the
    stub projection), ``stack`` (``transformer.init_stack``), ``encoder``
    and ``enc_pos`` (whisper), ``final_norm``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)
    ini = Init(gen)
    params = {"embed": common.embed_init(ini, cfg.vocab_padded(),
                                         cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = common.embed_init(ini, cfg.vocab_padded(),
                                              cfg.d_model)
    if cfg.learned_pos:
        params["pos_embed"] = ini.normal((max_pos, cfg.d_model), 0.02)
    if cfg.frontend:
        params["frontend"] = common.dense_init(ini, cfg.d_model, cfg.d_model)
    params["stack"] = transformer.init_stack(ini, cfg)
    if cfg.encoder_layers:
        params["encoder"] = transformer.init_stack(ini, _encoder_cfg(cfg))
        params["enc_pos"] = ini.normal((cfg.frontend_seq, cfg.d_model), 0.02)
    params["final_norm"] = common.norm_init(cfg.norm, cfg.d_model, ini)
    return params


def n_elements(params) -> int:
    """Scalars in a parameter tree (the norms included, which
    ``ArchConfig.n_params`` leaves out)."""
    if isinstance(params, dict):
        return sum(n_elements(v) for v in params.values())
    return params.numel()


def _final_norm(cfg, params, x, ctx):
    return common.norm_apply(cfg.norm)(params["final_norm"], x, ctx)


def _embed_tokens(cfg, params, tokens, ctx):
    x = common.embed(params["embed"], tokens, ctx)
    if cfg.norm == "rmsnorm_1p":      # gemma convention
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits(cfg, params, x, ctx):
    head = params.get("lm_head", params["embed"])
    return common.unembed(head, x, ctx, softcap=cfg.final_softcap)


def _positions(x):
    b, s = x.shape[0], x.shape[1]
    return torch.arange(s, dtype=torch.int32,
                        device=x.device).unsqueeze(0).expand(b, s)


def _encoder_ctx(cfg, params, frames, ctx):
    """Whisper: run the (stubbed conv output) frames through the encoder
    and build each decoder group's cross-attention keys and values:
    ``{key: {"k", "v"}}`` stacked over the groups, as the reference's
    ``vmap`` over them."""
    enc_cfg = _encoder_cfg(cfg)
    x = frames + ctx.cast(params["enc_pos"])[None, :frames.shape[1]]
    x, _, _ = transformer.apply_stack(params["encoder"], x, ctx, enc_cfg,
                                      causal=False)
    x = _final_norm(cfg, params, x, ctx)
    subs, n_groups = transformer.group_layout(cfg)
    groups = params["stack"]["groups"]
    out = {}
    for i, sub in enumerate(subs):
        key = f"{i}_{sub}"
        per = [attn_mod.build_cross_kv(
            cross, x, ctx, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim)
            for cross in transformer.unstack(groups[key]["cross"], n_groups)]
        out[key] = {n: torch.stack([c[n] for c in per]) for n in ("k", "v")}
    return out


def _inputs(cfg, params, tokens, ctx, frontend):
    """The stack's input: the embedded tokens, the vlm's projected patches
    prepended, learned positions added; and whisper's cross-KV. Returns (x,
    cross_kv, the number of patches)."""
    x = _embed_tokens(cfg, params, tokens, ctx)
    cross_kv, n_front = None, 0
    if cfg.family == "audio":
        cross_kv = _encoder_ctx(cfg, params, ctx.cast(frontend), ctx)
    elif cfg.frontend and frontend is not None:   # vlm: prepend patches
        patches = common.dense(params["frontend"], ctx.cast(frontend), ctx)
        x = torch.cat([patches, x], dim=1)
        n_front = patches.shape[1]
    if cfg.learned_pos:
        x = x + ctx.cast(params["pos_embed"])[None, :x.shape[1]]
    return x, cross_kv, n_front


def forward(params, tokens: torch.Tensor, ctx: Ctx, cfg: ArchConfig, *,
            frontend: torch.Tensor | None = None) -> torch.Tensor:
    """The full forward (the reference's ``loss_fn`` up to its logits):
    logits (B, S, V_padded) f32 at every text position."""
    x, cross_kv, n_front = _inputs(cfg, params, tokens, ctx, frontend)
    x, _, _ = transformer.apply_stack(
        params["stack"], x, ctx, cfg,
        positions=None if cfg.learned_pos else _positions(x),
        cross_kv=cross_kv)
    x = _final_norm(cfg, params, x, ctx)
    return _logits(cfg, params, x[:, n_front:], ctx)


# ---------------------------------------------------------------------------
# train forward / loss
# ---------------------------------------------------------------------------

def loss_fn(params, batch: dict, ctx: Ctx, cfg: ArchConfig, *,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """batch: tokens (B, S_text) int, labels (B, S_text) int (-1 = pad),
    the frontend (B, F, D) f32 stub embeddings or frames where the config
    has one. Returns (loss, {"nll", "aux", "ntok"}): the NLL averaged over
    the labels >= 0, plus 0.01 times the stack's aux loss."""
    labels = batch["labels"]
    x, cross_kv, n_front = _inputs(cfg, params, batch["tokens"], ctx,
                                   batch.get("frontend"))
    x = ctx.constrain(x, "dp", None, None)
    x, _, aux = transformer.apply_stack(
        params["stack"], x, ctx, cfg,
        positions=None if cfg.learned_pos else _positions(x),
        cross_kv=cross_kv, remat=remat)
    x = _final_norm(cfg, params, x, ctx)
    logits = _logits(cfg, params, x[:, n_front:], ctx)    # (B,S,Vpad) f32

    valid = labels >= 0
    lbl = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lbl.unsqueeze(-1)).squeeze(-1)
    nll = (logz - gold) * valid
    ntok = torch.clamp(valid.sum(dtype=torch.int32), min=1)
    mean_nll = nll.sum() / ntok
    loss = mean_nll + 0.01 * aux
    return loss, {"nll": mean_nll, "aux": aux, "ntok": ntok}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def prefill(params, tokens: torch.Tensor, ctx: Ctx, cfg: ArchConfig, *,
            max_seq: int, frontend: torch.Tensor | None = None):
    """Full forward that also populates a dense decode cache. Returns
    (logits (B, 1, V) of the last position, caches grown to ``max_seq``
    slots, cross_kv: whisper's per-group encoder keys and values, else
    None)."""
    b, s = tokens.shape
    s_total = s + (frontend.shape[1]
                   if (cfg.frontend and cfg.family != "audio"
                       and frontend is not None) else 0)
    assert max_seq >= s_total, (max_seq, s_total)
    x, cross_kv, _ = _inputs(cfg, params, tokens, ctx, frontend)
    x, caches, _ = transformer.apply_stack(
        params["stack"], x, ctx, cfg,
        positions=None if cfg.learned_pos else _positions(x),
        caches=_prefill_caches(cfg, b, ctx.compute_dtype, x.device),
        cross_kv=cross_kv)
    x = _final_norm(cfg, params, x, ctx)
    logits = _logits(cfg, params, x[:, -1:], ctx)
    return logits, _pad_caches(caches, max_seq), cross_kv


def _prefill_caches(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """During prefill the attention layers build their caches from scratch:
    an empty dict asks them for the build. The recurrent sub-blocks start
    from their zero states (the reference's ``init_cache`` with its
    attention caches stripped)."""
    subs, n_groups = transformer.group_layout(cfg)
    return {f"{i}_{sub}": (transformer.stack_groups(
        transformer.subblock_cache(cfg, sub, batch, 1, dtype, device=device),
        n_groups) if sub in transformer._RECURRENT else {})
        for i, sub in enumerate(subs)}


def _grow(t: torch.Tensor, max_seq: int) -> torch.Tensor:
    """(G, B, S, ...) zero-padded to (G, B, max_seq, ...)."""
    if t.shape[2] == max_seq:
        return t
    out = torch.zeros((*t.shape[:2], max_seq, *t.shape[3:]), dtype=t.dtype,
                      device=t.device)
    out[:, :, :t.shape[2]] = t
    return out


def _pad_caches(caches: dict, max_seq: int) -> dict:
    """Grow prefill-built KV caches (G, B, S, KH, hd) and MLA latents (G,
    B, S, R) to max_seq slots."""
    def pad(c):
        if "k" in c and "pos" in c:
            return dict(c, k=_grow(c["k"], max_seq), v=_grow(c["v"], max_seq))
        if "latent" in c:
            return dict(c, latent=_grow(c["latent"], max_seq),
                        k_rope=_grow(c["k_rope"], max_seq))
        return c
    return {key: pad(c) for key, c in caches.items()}


def decode_step(params, token: torch.Tensor, caches: dict, ctx: Ctx,
                cfg: ArchConfig, *, cross_kv: dict | None = None):
    """One decode step. token: (B, 1) int. Returns (logits (B, 1, V),
    caches), the caches' KV tensors written in place."""
    x = _embed_tokens(cfg, params, token, ctx)
    if cfg.learned_pos:
        pe = ctx.cast(params["pos_embed"])
        # dynamic_slice_in_dim clamps the start so one row fits
        pos = torch.clamp(_first_pos(caches).to(torch.long), 0,
                          pe.shape[0] - 1)
        x = x + pe.index_select(0, pos.reshape(1)).unsqueeze(0)
    x, caches, _ = transformer.apply_stack(params["stack"], x, ctx, cfg,
                                           caches=caches, cross_kv=cross_kv)
    x = _final_norm(cfg, params, x, ctx)
    return _logits(cfg, params, x, ctx), caches


def _first_pos(caches) -> torch.Tensor:
    """The reference's ``_first_pos`` (l.256): the first 1-D int32 leaf in
    JAX's leaf order, its first entry. For a split dense cache that leaf is
    ``blen`` (sorted before ``pos``), as in the reference."""
    for leaf in tree_leaves(caches):
        if leaf.ndim == 1 and leaf.dtype == torch.int32:
            return leaf[0]
    return torch.zeros((), dtype=torch.int32)


def init_decode_caches(cfg: ArchConfig, batch: int, max_seq: int, *,
                       mode: str = "dense", dtype=torch.bfloat16,
                       recent: int = 1024, device=None) -> dict:
    """Zero decode caches, "dense" (ring buffers for the local layers, a
    split append buffer of 256 slots) or "clustered" (the clustered layout
    for the global and shared attention layers at ``clustered_geometry``,
    ring buffers for the local ones; MLA keeps its dense latents and the
    recurrent sub-blocks their states). ``device`` defaults to
    ``"cuda"``."""
    device = resolve_device(device)
    if mode == "dense":
        return transformer.init_cache(cfg, batch, max_seq, dtype=dtype,
                                      local_ring=True, split_append=256,
                                      device=device)
    assert mode == "clustered"
    subs, n_groups = transformer.group_layout(cfg)
    hd = cfg.resolved_head_dim
    kc, cap = clustered_geometry(cfg, max_seq)

    def one(sub):
        if sub in ("block", "attn_global", "shared_attn") \
                and cfg.attention != "mla":
            return kma.init_clustered_cache(batch, cfg.num_kv_heads, hd,
                                            kc=kc, capacity=cap,
                                            recent=recent, dtype=dtype,
                                            device=device)
        if sub == "attn_local":    # a ring at any max_seq
            return transformer.subblock_cache(
                cfg, sub, batch, max(max_seq, cfg.window_size + 1), dtype,
                local_ring=True, device=device)
        # MLA's dense latents, the recurrent states
        return transformer.subblock_cache(cfg, sub, batch, max_seq, dtype,
                                          device=device)

    return {f"{i}_{sub}": transformer.stack_groups(one(sub), n_groups)
            for i, sub in enumerate(subs)}


def clustered_geometry(cfg: ArchConfig, max_seq: int) -> tuple[int, int]:
    """(num_clusters, per-cluster capacity) for a given context length."""
    kc = max(cfg.kv_cluster_k, min(1024, max_seq // 512))
    cap = int(max_seq / kc * cfg.kv_cluster_capacity_factor)
    cap = max(16, ((cap + 127) // 128) * 128)
    return kc, cap
