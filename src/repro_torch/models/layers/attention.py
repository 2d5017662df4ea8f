"""Attention: GQA/MHA with RoPE, sliding-window and logit-softcap variants,
KV-cache decode, and a chunked online-softmax path so a long prefill never
materializes the (S, S) score matrix.

Port of ``repro/models/layers/attention.py`` (l.19-253). The reference's
attention is plain JAX outside any Pallas kernel, so this is plain PyTorch:
masked scores hold ``NEG_INF = -1e30`` (not ``-inf``: a row with nothing
valid softmaxes to uniform weights, as the reference's does), and
``scaled_dot_product_attention`` is not used (it has no softcap and masks
with ``-inf``). ``chunked_attention`` keeps the reference's recurrence over
KV chunks (running max, sum and accumulator) and its rule for ``S % chunk
!= 0`` (the largest divisor of S up to ``chunk``; below 64, plain
attention).

The decode path writes the step's key and value into the cache tensors in
place (``index_copy_`` at ``pos``, the start clamped so the update fits, as
``dynamic_update_slice`` clamps it); ``pos`` stays on the device, so a
step reads nothing back to the host. ``cross_attention`` and
``build_cross_kv`` (whisper's decoder against the encoder's output, with
the qkv biases) follow the reference's l.255-276.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import (HEADS, Ctx, Init, apply_rope,
                                       on_problems, problem_specs)
from repro_torch.utils import sharding as shd

NEG_INF = -1e30


def attn_init(ini: Init, d_model: int, num_heads: int, num_kv_heads: int,
              head_dim: int, *, out_dim: int | None = None,
              qkv_bias: bool = False) -> dict:
    out_dim = out_dim or d_model
    sc = d_model ** -0.5
    params = {
        "wq": ini.normal((d_model, num_heads * head_dim), sc),
        "wk": ini.normal((d_model, num_kv_heads * head_dim), sc),
        "wv": ini.normal((d_model, num_kv_heads * head_dim), sc),
        "wo": ini.normal((num_heads * head_dim, out_dim),
                         (num_heads * head_dim) ** -0.5),
    }
    if qkv_bias:
        params.update(bq=ini.zeros((num_heads * head_dim,)),
                      bk=ini.zeros((num_kv_heads * head_dim,)),
                      bv=ini.zeros((num_kv_heads * head_dim,)),
                      bo=ini.zeros((out_dim,)))
    return params


def attn_specs(*, qkv_bias: bool = False) -> dict:
    """The logical specs of ``attn_init``'s tree (ref. l.38-47)."""
    specs = {"wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"),
             "wv": ("fsdp", "tp"), "wo": ("tp", "fsdp")}
    if qkv_bias:
        specs.update(bq=("tp",), bk=("tp",), bv=("tp",), bo=(None,))
    return specs


def project_qkv(params, x: torch.Tensor, ctx: Ctx, *, num_heads: int,
                num_kv_heads: int, head_dim: int):
    """Returns q (B,S,H,hd), k,v (B,S,KH,hd)."""
    q = x @ ctx.cast(params["wq"])
    k = x @ ctx.cast(params["wk"])
    v = x @ ctx.cast(params["wv"])
    if "bq" in params:
        q = q + ctx.cast(params["bq"])
        k = k + ctx.cast(params["bk"])
        v = v + ctx.cast(params["bv"])
    return (shd.split_heads(q, num_heads, head_dim),
            shd.split_heads(k, num_kv_heads, head_dim),
            shd.split_heads(v, num_kv_heads, head_dim))


def _softcap(scores: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return scores
    return torch.tanh(scores / cap) * cap


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KH, hd) -> (B, S, KH*groups, hd) by repeat (GQA)."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int | None = None,
                  softcap: float | None = None, scale: float | None = None,
                  q_offset: int = 0) -> torch.Tensor:
    """Plain attention: fine for short S or decode (S_q small).

    q: (B, Sq, H, hd); k, v: (B, Skv, KH, hd). ``q_offset`` is the absolute
    position of q[0] (for causal masking during decode).
    """
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    k = _expand_kv(k, h // kh)
    v = _expand_kv(v, h // kh)
    scale = scale if scale is not None else hd ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    scores = _softcap(scores, softcap)
    skv = k.shape[1]
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int | None = None,
                      softcap: float | None = None,
                      scale: float | None = None,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks — O(S·chunk) live memory.

    Shapes as in dot_attention with Sq == Skv (self-attention prefill).
    """
    b, s, h, hd = q.shape
    kh = k.shape[2]
    if s <= chunk:
        return dot_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale)
    if s % chunk != 0:
        # largest divisor of s <= chunk (e.g. whisper's 1500 -> 750)
        chunk = next(c for c in range(chunk, 0, -1) if s % c == 0)
        if chunk < 64:  # degenerate split: plain attention is cheaper
            return dot_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)
    n_chunks = s // chunk
    scale = scale if scale is not None else hd ** -0.5
    dev = q.device

    qf = q.float()
    qpos = torch.arange(s, device=dev)
    m_run = torch.full((b, h, s), NEG_INF, device=dev)
    l_run = torch.zeros((b, h, s), device=dev)
    acc = torch.zeros((b, h, s, hd), device=dev)
    for idx in range(n_chunks):
        sl = slice(idx * chunk, (idx + 1) * chunk)
        kc = _expand_kv(k[:, sl], h // kh).float()
        vc = _expand_kv(v[:, sl], h // kh).float()
        scores = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
        scores = _softcap(scores, softcap)
        kpos = idx * chunk + torch.arange(chunk, device=dev)
        mask = torch.ones((s, chunk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m_run, scores.amax(-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new.unsqueeze(-1))
        del scores
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha.unsqueeze(-1) + torch.einsum("bhqk,bkhd->bhqd",
                                                       p, vc)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30).unsqueeze(-1)
    return out.movedim(1, 2).to(q.dtype)                   # (B,S,H,hd)


def attn_out(params, o: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    y = shd.merge_heads(o) @ ctx.cast(params["wo"])
    if "bo" in params:
        y = y + ctx.cast(params["bo"])
    return y


def update_slice(buf: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """``lax.dynamic_update_slice_in_dim`` on ``buf`` in place: ``new``
    written along ``dim`` from ``start`` (a device scalar), the start
    clamped to ``[0, buf.shape[dim] - new.shape[dim]]`` so the update fits,
    as the reference clamps it. Reads nothing back to the host."""
    n = new.shape[dim]
    st = torch.clamp(start.to(torch.long), 0, buf.shape[dim] - n)
    idx = st.reshape(1) + torch.arange(n, device=buf.device)
    return buf.index_copy_(dim, idx, new.to(buf.dtype))


def self_attention(params, x: torch.Tensor, ctx: Ctx, *, num_heads: int,
                   num_kv_heads: int, head_dim: int, causal: bool = True,
                   rope_theta: float | None = 10000.0,
                   window: int | None = None,
                   softcap: float | None = None,
                   scale: float | None = None,
                   positions: torch.Tensor | None = None,
                   chunk: int = 1024,
                   cache: dict | None = None):
    """Full self-attention layer. With ``cache`` (decode): x is (B, 1, D),
    cache holds k/v (B, S_max, KH, hd), written in place, and ``pos`` (a
    device scalar); returns the updated cache. Without cache: prefill/train
    over the whole sequence; ``cache={}`` asks for the built cache back."""
    b, s, _ = x.shape
    q, k, v = project_qkv(params, x, ctx, num_heads=num_heads,
                          num_kv_heads=num_kv_heads, head_dim=head_dim)
    kw = dict(rope_theta=rope_theta, window=window, softcap=softcap,
              scale=scale)
    heads = dict(dp=b, tp=num_kv_heads)
    # the attention core on each rank's own (sequence, kv head) problems:
    # its views and in-place cache writes have no DTensor rule in every torch
    if cache is not None and "k" in cache:                 # decode step
        o, new_cache = on_problems(
            lambda q, k, v, c: _decode_core(q, k, v, c, **kw), ctx,
            (q, k, v, cache), (HEADS, HEADS, HEADS, problem_specs(cache)),
            (HEADS, problem_specs(cache)), **heads)
        return attn_out(params, o, ctx), new_cache

    if positions is None:
        positions = torch.arange(s, device=x.device).unsqueeze(0).expand(b, s)
    built = {"k": HEADS, "v": HEADS, "pos": ()}
    o, kv = on_problems(
        lambda q, k, v, p: _prefill_core(q, k, v, p, causal=causal,
                                         chunk=chunk, **kw), ctx,
        (q, k, v, positions), (HEADS, HEADS, HEADS, ("dp", None)),
        (HEADS, built), **heads)
    y = attn_out(params, o, ctx)
    if cache is not None:                                  # prefill: build cache
        return y, kv
    return y, None


def _decode_core(q, k, v, cache, *, rope_theta, window, softcap, scale):
    """A decode step's attention on plain tensors: rope at ``pos``, the
    new key and value written into the cache in place, attention over the
    filled slots. Returns (o, the cache)."""
    b, s = q.shape[0], q.shape[1]
    pos = cache["pos"]
    if rope_theta is not None:
        pq = pos.to(torch.int32) + torch.arange(
            s, dtype=torch.int32, device=q.device)
        pq = pq.unsqueeze(0).expand(b, s)
        q = _rope_bshd(q, pq, rope_theta)
        k = _rope_bshd(k, pq, rope_theta)
    k_cache = update_slice(cache["k"], k, pos, 1)
    v_cache = update_slice(cache["v"], v, pos, 1)
    o = _decode_attention(q, k_cache, v_cache, pos, window=window,
                          softcap=softcap, scale=scale)
    return o, dict(cache, k=k_cache, v=v_cache, pos=pos + s)


def _prefill_core(q, k, v, positions, *, causal, chunk, rope_theta, window,
                  softcap, scale):
    """Prefill or train attention on plain tensors: rope, then chunked
    attention. Returns (o, the built cache {k, v, pos})."""
    if rope_theta is not None:
        q = _rope_bshd(q, positions, rope_theta)
        k = _rope_bshd(k, positions, rope_theta)
    o = chunked_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap, scale=scale, chunk=chunk)
    return o, {"k": k, "v": v, "pos": torch.tensor(
        q.shape[1], dtype=torch.int32, device=q.device)}


def _rope_bshd(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """RoPE on (B, S, H, hd) given positions (B, S)."""
    xt = x.transpose(1, 2)                                 # (B,H,S,hd)
    xt = apply_rope(xt, positions[:, None, :], theta=theta)
    return xt.transpose(1, 2)


def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: torch.Tensor, *,
                      window: int | None, softcap: float | None,
                      scale: float | None) -> torch.Tensor:
    """q: (B, 1, H, hd) vs cache (B, S_max, KH, hd); valid keys are < pos+1."""
    b, sq, h, hd = q.shape
    kh = k_cache.shape[2]
    k = _expand_kv(k_cache, h // kh)
    v = _expand_kv(v_cache, h // kh)
    scale_ = scale if scale is not None else hd ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale_
    scores = _softcap(scores, softcap)
    kpos = torch.arange(k.shape[1], device=q.device)
    qpos = pos + torch.arange(sq, device=q.device)
    valid = kpos[None, :] <= qpos[:, None]
    if window is not None:
        valid = valid & (kpos[None, :] > qpos[:, None] - window)
    scores = torch.where(valid, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def cross_attention(params, x: torch.Tensor, kv_cache: dict, ctx: Ctx, *,
                    num_heads: int, num_kv_heads: int,
                    head_dim: int) -> torch.Tensor:
    """Encoder-decoder cross attention against precomputed (k, v)."""
    q = x @ ctx.cast(params["wq"])
    if "bq" in params:
        q = q + ctx.cast(params["bq"])
    q = shd.split_heads(q, num_heads, head_dim)
    # the core on each rank's own problems, as in self_attention
    o = on_problems(lambda q, k, v: dot_attention(q, k, v, causal=False),
                    ctx, (q, kv_cache["k"], kv_cache["v"]),
                    (HEADS, HEADS, HEADS), HEADS, dp=q.shape[0],
                    tp=num_kv_heads)
    return attn_out(params, o, ctx)


def build_cross_kv(params, enc_out: torch.Tensor, ctx: Ctx, *,
                   num_kv_heads: int, head_dim: int) -> dict:
    """The cross-attention keys and values (B, S_enc, KH, hd) of one
    decoder layer."""
    k = enc_out @ ctx.cast(params["wk"])
    v = enc_out @ ctx.cast(params["wv"])
    if "bk" in params:
        k = k + ctx.cast(params["bk"])
        v = v + ctx.cast(params["bv"])
    return {"k": shd.split_heads(k, num_kv_heads, head_dim),
            "v": shd.split_heads(v, num_kv_heads, head_dim)}
