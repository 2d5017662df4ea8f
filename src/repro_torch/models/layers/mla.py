"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

Port of ``repro/models/layers/mla.py`` (``mla_init`` l.20,
``mla_attention`` l.58), plain PyTorch as the reference is plain JAX.
Queries and KV are compressed through low-rank latents; the decode cache
holds only the latent (``kv_lora_rank``) and the decoupled RoPE key
(``rope_head_dim``) a token: ``{"latent": (B, S_max, R), "k_rope": (B,
S_max, rope_hd), "pos"}``, ``pos`` a device scalar (``(G,)`` stacked over
the groups, as the port's other caches). The decode step writes its latent
and key at ``pos`` in place through ``attention.update_slice``, which
clamps the start as ``dynamic_update_slice`` does.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import Ctx, Init, apply_rope
from repro_torch.models.layers.attention import NEG_INF, attn_out, \
    update_slice


def mla_init(ini: Init, d_model: int, num_heads: int, *, q_lora_rank: int,
             kv_lora_rank: int, nope_head_dim: int, rope_head_dim: int,
             v_head_dim: int) -> dict:
    h = num_heads
    sc = d_model ** -0.5
    return {
        "wq_a": ini.normal((d_model, q_lora_rank), sc),
        "q_norm": ini.ones((q_lora_rank,)),
        "wq_b": ini.normal((q_lora_rank, h * (nope_head_dim + rope_head_dim)),
                           q_lora_rank ** -0.5),
        "wkv_a": ini.normal((d_model, kv_lora_rank + rope_head_dim), sc),
        "kv_norm": ini.ones((kv_lora_rank,)),
        "wkv_b": ini.normal((kv_lora_rank, h * (nope_head_dim + v_head_dim)),
                            kv_lora_rank ** -0.5),
        "wo": ini.normal((h * v_head_dim, d_model),
                         (h * v_head_dim) ** -0.5),
    }


def mla_specs() -> dict:
    """The logical specs of ``mla_init``'s tree (ref. l.42-48)."""
    return {"wq_a": ("fsdp", None), "q_norm": (None,),
            "wq_b": (None, "tp"),
            "wkv_a": ("fsdp", None), "kv_norm": (None,),
            "wkv_b": (None, "tp"),
            "wo": ("tp", "fsdp")}


def _rms(x: torch.Tensor, scale: torch.Tensor,
         eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * scale).to(x.dtype)


def _rope_heads(x: torch.Tensor, positions: torch.Tensor,
                theta: float) -> torch.Tensor:
    """RoPE of (B, S, rope_hd) keys shared by the heads, at (B, S)."""
    return apply_rope(x.unsqueeze(1), positions.unsqueeze(1),
                      theta=theta)[:, 0]


def mla_attention(params, x: torch.Tensor, ctx: Ctx, *, num_heads: int,
                  nope_head_dim: int, rope_head_dim: int, v_head_dim: int,
                  kv_lora_rank: int, rope_theta: float = 10000.0,
                  positions: torch.Tensor | None = None,
                  cache: dict | None = None):
    """Returns (out, new_cache). ``cache={}`` asks for the built cache back
    (prefill); a cache holding ``latent`` decodes."""
    b, s, _ = x.shape
    h = num_heads

    # --- queries
    q_lat = _rms(x @ ctx.cast(params["wq_a"]), params["q_norm"])
    q = (q_lat @ ctx.cast(params["wq_b"])).reshape(
        b, s, h, nope_head_dim + rope_head_dim)
    q_nope, q_rope = q[..., :nope_head_dim], q[..., nope_head_dim:]

    # --- kv latent + decoupled rope key
    kv_a = x @ ctx.cast(params["wkv_a"])
    latent = _rms(kv_a[..., :kv_lora_rank], params["kv_norm"])   # (B,S,R)
    k_rope_new = kv_a[..., kv_lora_rank:]                        # (B,S,rhd)

    decode = cache is not None and "latent" in cache
    if decode:
        pos = cache["pos"]
        pq = (pos.to(torch.int32) + torch.arange(
            s, dtype=torch.int32, device=x.device)).unsqueeze(0).expand(b, s)
        latent_c = update_slice(cache["latent"], latent, pos, 1)
        k_rope_c = update_slice(
            cache["k_rope"], _rope_heads(k_rope_new, pq, rope_theta), pos, 1)
        latent_all, k_rope_all = latent_c, k_rope_c
        kpos_limit = pos + s
        new_cache = dict(cache, latent=latent_c, k_rope=k_rope_c,
                         pos=pos + s)
    else:
        if positions is None:
            positions = torch.arange(s, device=x.device).unsqueeze(0) \
                .expand(b, s)
        pq = positions
        k_rope_all = _rope_heads(k_rope_new, positions, rope_theta)
        latent_all = latent
        kpos_limit = None
        new_cache = ({"latent": latent, "k_rope": k_rope_all,
                      "pos": torch.tensor(s, dtype=torch.int32,
                                          device=x.device)}
                     if cache is not None else None)

    q_rope = apply_rope(q_rope.transpose(1, 2), pq.unsqueeze(1),
                        theta=rope_theta).transpose(1, 2)

    # --- expand the latent to per-head keys and values
    skv = latent_all.shape[1]
    kv = (latent_all @ ctx.cast(params["wkv_b"])).reshape(
        b, skv, h, nope_head_dim + v_head_dim)
    k_nope, v = kv[..., :nope_head_dim], kv[..., nope_head_dim:]

    scale = (nope_head_dim + rope_head_dim) ** -0.5
    scores = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope_all)
              ).float() * scale
    qpos = pq[0] if decode else torch.arange(s, device=x.device)
    kpos = torch.arange(skv, device=x.device)
    mask = kpos[None, :] <= qpos[:, None]
    if kpos_limit is not None:
        mask = mask & (kpos[None, :] < kpos_limit)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return attn_out(params, o, ctx), new_cache
