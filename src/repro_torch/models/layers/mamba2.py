"""Mamba2 (SSD) block: the chunkwise scan for prefill and the one-step
recurrence for decode.

Port of ``repro/models/layers/mamba2.py``: scalar decay a head, state
(heads, head_dim, d_state) in f32, a depthwise causal conv over the xBC
stream, a gated RMSNorm output. Plain PyTorch, as the reference computes
all of it outside any Pallas kernel; the reference's ``lax.scan`` over
chunks is a Python loop. Its ``-inf`` upper triangle and ``exp(seg)`` stay
as they are. The reference asserts ``s % chunk == 0`` with ``chunk =
min(cfg.ssm_chunk, s)``; the port raises likewise and never pads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Ctx, Init


def mamba2_init(ini: Init, d_model: int, *, expand: int = 2,
                head_dim: int = 64, d_state: int = 64,
                conv_width: int = 4) -> dict:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    sc = d_model ** -0.5
    a_log = torch.log(torch.arange(1, n_heads + 1, dtype=torch.float32,
                                   device=ini.device))
    return {
        "w_z": ini.normal((d_model, d_inner), sc),
        "w_x": ini.normal((d_model, d_inner), sc),
        "w_b": ini.normal((d_model, d_state), sc),
        "w_c": ini.normal((d_model, d_state), sc),
        "w_dt": ini.normal((d_model, n_heads), sc),
        "dt_bias": ini.zeros((n_heads,)),
        "A_log": ini.zeros((n_heads,)).add_(a_log),
        "D": ini.ones((n_heads,)),
        "conv": ini.normal((conv_width, d_inner + 2 * d_state), 0.2),
        "norm_scale": ini.ones((d_inner,)),
        "w_out": ini.normal((d_inner, d_model), d_inner ** -0.5),
    }


def mamba2_specs() -> dict:
    """The logical specs of ``mamba2_init``'s tree (ref. l.37-43)."""
    return {"w_z": ("fsdp", "tp"), "w_x": ("fsdp", "tp"),
            "w_b": ("fsdp", None), "w_c": ("fsdp", None),
            "w_dt": ("fsdp", "tp"), "dt_bias": ("tp",), "A_log": ("tp",),
            "D": ("tp",), "conv": (None, None), "norm_scale": ("tp",),
            "w_out": ("tp", "fsdp")}


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, S, C), w: (W, C). With ``state`` (B,
    W-1, C) the window continues from it; without, zeros pad the left.
    Returns (out, the last W-1 inputs)."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    buf = torch.cat([state.to(x.dtype), x], dim=1)       # (B, W-1+S, C)
    s = x.shape[1]
    out = buf[:, 0:s] * w[0]
    for i in range(1, width):
        out = out + buf[:, i:i + s] * w[i]
    return out, buf[:, -(width - 1):]


def ssd_chunked(xh, b_in, c_in, dt, a, *, chunk: int, h0=None):
    """Chunkwise SSD scan. xh: (B,S,H,P); b_in/c_in: (B,S,N) shared by the
    heads; dt: (B,S,H) after softplus; a: (H,) negative decay rates.
    Returns (y (B,S,H,P) f32, h_final (B,H,P,N) f32)."""
    bsz, s, h, p = xh.shape
    n = b_in.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: length {s} is not a multiple of the "
                         f"chunk {chunk} (the reference asserts it)")
    nc = s // chunk
    xc = xh.reshape(bsz, nc, chunk, h, p)
    bc = b_in.reshape(bsz, nc, chunk, n)
    cc = c_in.reshape(bsz, nc, chunk, n)
    dtc = dt.reshape(bsz, nc, chunk, h)
    cum = torch.cumsum(dtc * a, dim=2)              # inclusive log decay
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xh.device))[None, :, :, None]
    h_prev = (torch.zeros((bsz, h, p, n), device=xh.device) if h0 is None
              else h0.float())
    ys = []
    for i in range(nc):
        # intra: M[t,tau] = (C_t.B_tau) * exp(cum_t - cum_tau) * dt_tau
        # inter: y_t += C_t . (exp(cum_t) h_prev)
        # state: h = exp(cum_L) h_prev + sum_tau exp(cum_L - cum_tau) dt B x
        xb, cumb, dtb = xc[:, i].float(), cum[:, i], dtc[:, i]
        bb, cb = bc[:, i].float(), cc[:, i].float()
        seg = cumb[:, :, None, :] - cumb[:, None, :, :]
        seg = torch.where(tri, seg, -torch.inf)
        scores = torch.einsum("bln,bmn->blm", cb, bb)
        m = scores[..., None] * torch.exp(seg) * dtb[:, None, :, :]
        y_intra = torch.einsum("blmh,bmhp->blhp", m, xb)
        y_inter = torch.einsum("bln,bhpn,blh->blhp", cb, h_prev,
                               torch.exp(cumb))
        tot = cumb[:, -1:, :]
        w = torch.exp(tot - cumb) * dtb
        h_prev = (torch.exp(tot[:, 0])[:, :, None, None] * h_prev
                  + torch.einsum("blh,bln,blhp->bhpn", w, bb, xb))
        ys.append(y_intra + y_inter)
    return torch.stack(ys, 1).reshape(bsz, s, h, p), h_prev


def mamba2(params, x: torch.Tensor, ctx: Ctx, *, head_dim: int = 64,
           d_state: int = 64, conv_width: int = 4, chunk: int = 256,
           cache: dict | None = None):
    """x: (B, S, D). Cache: {"ssm": (B,H,P,N) f32, "conv": (B,W-1,C)}.
    Returns (out, new_cache)."""
    bsz, s, d = x.shape
    d_inner = params["w_z"].shape[1]
    n_heads = d_inner // head_dim

    z = x @ ctx.cast(params["w_z"])                        # gate branch
    xh = x @ ctx.cast(params["w_x"])
    b_in = x @ ctx.cast(params["w_b"])
    c_in = x @ ctx.cast(params["w_c"])
    dt_raw = x @ ctx.cast(params["w_dt"])

    xbc = torch.cat([xh, b_in, c_in], dim=-1)
    has_state = cache is not None and "ssm" in cache
    decode = has_state and s == 1
    conv_state = cache.get("conv") if has_state else None
    xbc, conv_new = _causal_conv(xbc, ctx.cast(params["conv"]), conv_state)
    xbc = F.silu(xbc)
    xh = xbc[..., :d_inner]
    b_in = xbc[..., d_inner:d_inner + d_state]
    c_in = xbc[..., d_inner + d_state:]

    dt = F.softplus(dt_raw.float() + params["dt_bias"])    # (B,S,H)
    a_neg = -torch.exp(params["A_log"])                    # (H,)
    xh_h = xh.reshape(bsz, s, n_heads, head_dim)

    if decode:
        h_prev = cache["ssm"]
        decay = torch.exp(dt[:, 0] * a_neg)                # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, 0], b_in[:, 0].float(),
                           xh_h[:, 0].float())
        h_new = decay[:, :, None, None] * h_prev + upd
        y = torch.einsum("bn,bhpn->bhp", c_in[:, 0].float(),
                         h_new).unsqueeze(1)               # (B,1,H,P)
        new_cache = dict(cache, ssm=h_new, conv=conv_new)
    else:
        h0 = cache["ssm"] if has_state else None
        y, h_fin = ssd_chunked(xh_h, b_in, c_in, dt, a_neg,
                               chunk=min(chunk, s), h0=h0)
        new_cache = ({"ssm": h_fin, "conv": conv_new}
                     if cache is not None else None)

    y = y + params["D"][None, None, :, None] * xh_h.float()
    y = y.reshape(bsz, s, d_inner).to(ctx.compute_dtype)
    # gated RMSNorm (mamba2 style)
    y = y * F.silu(z)
    y32 = y.float()
    y = (y32 * torch.rsqrt((y32 * y32).mean(-1, keepdim=True) + 1e-6)
         * params["norm_scale"]).to(ctx.compute_dtype)
    return y @ ctx.cast(params["w_out"]), new_cache
