"""xLSTM blocks: mLSTM (matrix memory; the chunkwise scan for prefill, the
one-step recurrence for decode) and sLSTM (scalar memory with hidden-state
feedback, a sequential loop over time).

Port of ``repro/models/layers/xlstm.py``, plain PyTorch as the reference
is plain JAX. The gate algebra is in log space with a running stabilizer
``m``; the chunkwise form carries (C_hat, n_hat, m) in f32, the true state
being ``C = C_hat * exp(m)``.

The reference's chunk scan (l.57) rounds q, k, v, the intra-chunk weights
and the state-update weights to bfloat16 and accumulates their products in
f32, whatever the compute dtype: the port rounds the same operands at the
same places (``_bf16``) and multiplies them in f32, where the products of
bfloat16 values are exact. The one-step recurrence is all f32, so a decode
step and the chunkwise forward agree only to bfloat16 rounding (the
reference's own tests hold them at rtol = atol = 2e-2). The caches are
tuples: ``{"mlstm": (C_hat, n_hat, m)}`` and ``{"slstm": (c, n, m, h)}``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Ctx, Init

_LOG_EPS = -1e30


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(bfloat16)`` as an f32 operand (an exact widening)."""
    return x.to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(ini: Init, d_model: int, num_heads: int, *,
               proj_factor: float = 2.0) -> dict:
    d_inner = int(d_model * proj_factor)
    sc = d_model ** -0.5
    si = d_inner ** -0.5
    return {
        "w_up": ini.normal((d_model, d_inner), sc),
        "w_gate": ini.normal((d_model, d_inner), sc),
        "wq": ini.normal((d_inner, d_inner), si),
        "wk": ini.normal((d_inner, d_inner), si),
        "wv": ini.normal((d_inner, d_inner), si),
        "w_i": ini.normal((d_inner, num_heads), 0.01),
        "b_i": ini.zeros((num_heads,)),
        "w_f": ini.normal((d_inner, num_heads), 0.01),
        "b_f": ini.zeros((num_heads,)).add_(3.0),   # open forget gates
        "w_down": ini.normal((d_inner, d_model), si),
        "out_norm": ini.ones((d_inner,)),
    }


def mlstm_chunk_scan(q, k, v, log_i, log_f, *, chunk: int, state=None):
    """Stabilized chunkwise mLSTM. q, k, v: (B,S,H,D); log_i/log_f:
    (B,S,H). Returns (h (B,S,H,D) f32, (C_hat (B,H,D,D), n_hat (B,H,D),
    m (B,H)))."""
    b, s, h, d = q.shape
    if s % chunk:
        raise ValueError(f"mlstm_chunk_scan: length {s} is not a multiple of "
                         f"the chunk {chunk} (the reference asserts it)")
    nc = s // chunk
    scale = d ** -0.5
    dev = q.device
    if state is None:
        state = (torch.zeros((b, h, d, d), device=dev),
                 torch.zeros((b, h, d), device=dev),
                 torch.zeros((b, h), device=dev))
    c_hat, n_hat, m_st = state
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev))[None, :, :, None]
    hs = []
    for i in range(nc):
        sl = slice(i * chunk, (i + 1) * chunk)
        qb, lib, lfb = q[:, sl].float(), log_i[:, sl], log_f[:, sl]
        qh, kh, vh = _bf16(q[:, sl]), _bf16(k[:, sl]), _bf16(v[:, sl])
        bcum = torch.cumsum(lfb, dim=1)                # (B,L,H) inclusive
        # log weight of tau's contribution to row t (tau <= t)
        logw = (bcum[:, :, None, :] - bcum[:, None, :, :]
                + lib[:, None, :, :])                  # (B,t,tau,H)
        logw = torch.where(tri, logw, _LOG_EPS)
        log_inter = m_st[:, None, :] + bcum            # (B,L,H)
        m_row = torch.maximum(logw.amax(2), log_inter)
        m_row = torch.clamp(m_row, min=-60.0)          # no -inf
        w_intra = torch.exp(logw - m_row[:, :, None, :])
        w_inter = torch.exp(log_inter - m_row)
        scores = torch.einsum("blhd,bmhd->blmh", qh, kh) * scale
        sw = _bf16(scores * w_intra)
        num = (torch.einsum("blmh,bmhd->blhd", sw, vh)
               + torch.einsum("blhd,bhde,blh->blhe", qb * scale, c_hat,
                              w_inter))
        nvec = (torch.einsum("blmh,bmhd->blhd", _bf16(w_intra), kh)
                + w_inter[..., None] * n_hat[:, None])
        den = torch.einsum("blhd,blhd->blh", qb * scale, nvec).abs()
        den = torch.maximum(den, torch.exp(-m_row))
        hs.append(num / den[..., None])
        # the state at the chunk's end (f32 carry)
        btot = bcum[:, -1, :]                          # (B,H)
        logw_st = btot[:, None, :] - bcum + lib        # (B,L,H)
        m_new = torch.maximum(m_st + btot, logw_st.amax(1))
        w_st = _bf16(torch.exp(logw_st - m_new[:, None, :]))
        carry = torch.exp(m_st + btot - m_new)         # (B,H)
        c_hat = (carry[:, :, None, None] * c_hat
                 + torch.einsum("blh,blhd,blhe->bhde", w_st, kh, vh))
        n_hat = (carry[..., None] * n_hat
                 + torch.einsum("blh,blhd->bhd", w_st, kh))
        m_st = m_new
    return torch.cat(hs, 1), (c_hat, n_hat, m_st)


def mlstm_step(q, k, v, log_i, log_f, state):
    """One recurrent step, all f32. q, k, v: (B,1,H,D); gates (B,1,H)."""
    c_hat, n_hat, m_st = state
    d = q.shape[-1]
    scale = d ** -0.5
    qb, kb, vb = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    li, lf = log_i[:, 0], log_f[:, 0]                  # (B,H)
    m_new = torch.maximum(lf + m_st, li)
    f_s = torch.exp(lf + m_st - m_new)
    i_s = torch.exp(li - m_new)
    c_new = (f_s[:, :, None, None] * c_hat
             + i_s[:, :, None, None] * torch.einsum("bhd,bhe->bhde", kb, vb))
    n_new = f_s[..., None] * n_hat + i_s[..., None] * kb
    num = torch.einsum("bhd,bhde->bhe", qb * scale, c_new)
    den = torch.maximum(
        torch.einsum("bhd,bhd->bh", qb * scale, n_new).abs(),
        torch.exp(-m_new))
    return (num / den[..., None]).unsqueeze(1), (c_new, n_new, m_new)


def mlstm(params, x: torch.Tensor, ctx: Ctx, *, num_heads: int,
          chunk: int = 256, cache: dict | None = None):
    """mLSTM block. Cache: {"mlstm": (C_hat, n_hat, m)}."""
    b, s, _ = x.shape
    d_inner = params["w_up"].shape[1]
    dh = d_inner // num_heads

    up = x @ ctx.cast(params["w_up"])
    gate = F.silu(x @ ctx.cast(params["w_gate"]))
    q = (up @ ctx.cast(params["wq"])).reshape(b, s, num_heads, dh)
    k = (up @ ctx.cast(params["wk"])).reshape(b, s, num_heads, dh)
    v = (up @ ctx.cast(params["wv"])).reshape(b, s, num_heads, dh)
    log_i = (up @ ctx.cast(params["w_i"]) + ctx.cast(params["b_i"])).float()
    log_f = F.logsigmoid(
        (up @ ctx.cast(params["w_f"]) + ctx.cast(params["b_f"])).float())

    has_state = cache is not None and "mlstm" in cache
    if has_state and s == 1:
        h, state = mlstm_step(q, k, v, log_i, log_f, cache["mlstm"])
        new_cache = dict(cache, mlstm=state)
    else:
        h, state = mlstm_chunk_scan(
            q, k, v, log_i, log_f, chunk=min(chunk, s),
            state=cache["mlstm"] if has_state else None)
        new_cache = {"mlstm": state} if cache is not None else None

    h = h.reshape(b, s, d_inner).to(ctx.compute_dtype)
    h32 = h.float()
    h = (h32 * torch.rsqrt((h32 * h32).mean(-1, keepdim=True) + 1e-6)
         * params["out_norm"]).to(ctx.compute_dtype)
    return (h * gate) @ ctx.cast(params["w_down"]), new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(ini: Init, d_model: int, num_heads: int) -> dict:
    dh = d_model // num_heads
    sc = d_model ** -0.5
    b_gates = ini.zeros((4 * d_model,))
    b_gates[..., 2 * d_model:3 * d_model] = 3.0        # forget gates open
    return {
        # input weights for the (z, i, f, o) gates
        "w_gates": ini.normal((d_model, 4 * d_model), sc),
        "b_gates": b_gates,
        # per-head recurrent weights (block-diagonal R)
        "r_gates": ini.normal((num_heads, dh, 4 * dh), dh ** -0.5),
        "w_out": ini.normal((d_model, d_model), sc),
        "out_norm": ini.ones((d_model,)),
    }


def slstm(params, x: torch.Tensor, ctx: Ctx, *, num_heads: int,
          cache: dict | None = None):
    """sLSTM block, a loop over time (the hidden state feeds back into the
    gates). Cache: {"slstm": (c, n, m, h)} each (B, H, dh) f32."""
    b, s, d = x.shape
    dh = d // num_heads
    pre = (x @ ctx.cast(params["w_gates"])
           + ctx.cast(params["b_gates"])).float()
    pre = pre.reshape(b, s, 4, num_heads, dh)
    # f32 like the carried h; a bfloat16 copy (mixed-precision training)
    # widens, as the reference's einsum promotes it
    r = params["r_gates"].float()                       # (H, dh, 4dh)

    if cache is not None and "slstm" in cache:
        c, n, m, h_prev = cache["slstm"]
    else:
        c = n = m = h_prev = torch.zeros((b, num_heads, dh), device=x.device)
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", h_prev, r)   # (B,H,4dh)
        rec = rec.reshape(b, num_heads, 4, dh).transpose(1, 2)
        g = pre[:, t] + rec                             # (B,4,H,dh)
        z = torch.tanh(g[:, 0])
        li = g[:, 1]
        lf = F.logsigmoid(g[:, 2])
        o = torch.sigmoid(g[:, 3])
        m_new = torch.maximum(lf + m, li)
        i_s = torch.exp(li - m_new)
        f_s = torch.exp(lf + m - m_new)
        c = f_s * c + i_s * z
        n = f_s * n + i_s
        m = m_new
        h_prev = o * c / torch.clamp(n, min=1e-6)
        hs.append(h_prev)
    h = torch.stack(hs, 1).reshape(b, s, d)

    h = (h * torch.rsqrt((h * h).mean(-1, keepdim=True) + 1e-6)
         * params["out_norm"]).to(ctx.compute_dtype)
    out = h @ ctx.cast(params["w_out"])
    new_cache = (dict(cache, slstm=(c, n, m, h_prev))
                 if cache is not None else None)
    return out, new_cache
