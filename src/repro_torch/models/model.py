"""Model facade of the dense-attention family: embeddings + stack +
prefill/decode.

Port of ``repro/models/model.py`` (l.31-86, 161-324). Decode modes:

  "dense"     — the standard per-layer KV cache
  "clustered" — the flash-kmeans clustered-KV sparse decode
                (``models.kmeans_attention``)

``init_model`` draws the parameters from a ``torch.Generator`` (seeded with
``seed``) on ``device``, ``cuda`` unless the caller asks for the CPU; the
numbers differ from ``jax.random``'s, and ``models.bridge`` carries the JAX
package's trees across. ``decode_step`` writes into the caches it is given
in place and returns them. ``loss_fn`` (training, ROADMAP.md queue A item
8c), the encoder and the frontends (item 8a) are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.kmeans import resolve_device
from repro_torch.models import common, transformer
from repro_torch.models import kmeans_attention as kma
from repro_torch.models.common import Ctx, Init


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_model(cfg: ArchConfig, *, seed: int = 0,
               generator: torch.Generator | None = None,
               device=None) -> dict:
    """The parameter tree: ``embed``, ``lm_head`` (untied configs),
    ``stack`` (``transformer.init_stack``) and ``final_norm``, in f32."""
    transformer.check_ported(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)
    ini = Init(gen)
    params = {"embed": common.embed_init(ini, cfg.vocab_padded(),
                                         cfg.d_model)}
    if not cfg.tie_embeddings:
        params["lm_head"] = common.embed_init(ini, cfg.vocab_padded(),
                                              cfg.d_model)
    params["stack"] = transformer.init_stack(ini, cfg)
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


def forward(params, tokens: torch.Tensor, ctx: Ctx,
            cfg: ArchConfig) -> torch.Tensor:
    """The full forward: logits (B, S, V_padded) f32 at every position."""
    x = _embed_tokens(cfg, params, tokens, ctx)
    x, _, _ = transformer.apply_stack(params["stack"], x, ctx, cfg,
                                      positions=_positions(x))
    return _logits(cfg, params, _final_norm(cfg, params, x, ctx), ctx)


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def prefill(params, tokens: torch.Tensor, ctx: Ctx, cfg: ArchConfig, *,
            max_seq: int):
    """Full forward that also populates a dense decode cache. Returns
    (logits (B, 1, V) of the last position, caches grown to ``max_seq``
    slots)."""
    b, s = tokens.shape
    assert max_seq >= s, (max_seq, s)
    x = _embed_tokens(cfg, params, tokens, ctx)
    x, caches, _ = transformer.apply_stack(
        params["stack"], x, ctx, cfg, positions=_positions(x),
        caches=_prefill_caches(cfg))
    x = _final_norm(cfg, params, x, ctx)
    logits = _logits(cfg, params, x[:, -1:], ctx)
    return logits, _pad_caches(caches, max_seq)


def _prefill_caches(cfg: ArchConfig) -> dict:
    """During prefill the attention layers build their caches from scratch:
    an empty dict a sub-block asks ``self_attention`` for the build."""
    subs, _ = transformer.group_layout(cfg)
    return {f"{i}_{sub}": {} for i, sub in enumerate(subs)}


def _pad_caches(caches: dict, max_seq: int) -> dict:
    """Grow prefill-built KV caches (G, B, S, KH, hd) to max_seq slots."""
    def pad(c):
        if "k" not in c or "pos" not in c:
            return c
        k = c["k"]
        if k.shape[2] == max_seq:
            return c
        grown = []
        for t in (c["k"], c["v"]):
            out = torch.zeros((*t.shape[:2], max_seq, *t.shape[3:]),
                              dtype=t.dtype, device=t.device)
            out[:, :, :t.shape[2]] = t
            grown.append(out)
        return dict(c, k=grown[0], v=grown[1])
    return {key: pad(c) for key, c in caches.items()}


def decode_step(params, token: torch.Tensor, caches: dict, ctx: Ctx,
                cfg: ArchConfig):
    """One decode step. token: (B, 1) int. Returns (logits (B, 1, V),
    caches), the caches' KV tensors written in place."""
    x = _embed_tokens(cfg, params, token, ctx)
    x, caches, _ = transformer.apply_stack(params["stack"], x, ctx, cfg,
                                           caches=caches)
    x = _final_norm(cfg, params, x, ctx)
    return _logits(cfg, params, x, ctx), caches


def init_decode_caches(cfg: ArchConfig, batch: int, max_seq: int, *,
                       mode: str = "dense", dtype=torch.bfloat16,
                       recent: int = 1024, device=None) -> dict:
    """Zero decode caches, "dense" (ring buffers for the local layers, a
    split append buffer of 256 slots) or "clustered" (the clustered layout
    for the global layers at ``clustered_geometry``, ring buffers for the
    local ones). ``device`` defaults to ``"cuda"``."""
    device = resolve_device(device)
    if mode == "dense":
        return transformer.init_cache(cfg, batch, max_seq, dtype=dtype,
                                      local_ring=True, split_append=256,
                                      device=device)
    assert mode == "clustered"
    transformer.check_ported(cfg)
    subs, n_groups = transformer.group_layout(cfg)
    hd = cfg.resolved_head_dim
    kc, cap = clustered_geometry(cfg, max_seq)

    def one(sub):
        if sub == "attn_local":
            w = cfg.window_size
            return {"k": torch.zeros((batch, w, cfg.num_kv_heads, hd),
                                     dtype=dtype, device=device),
                    "v": torch.zeros((batch, w, cfg.num_kv_heads, hd),
                                     dtype=dtype, device=device),
                    "pos": torch.zeros((), dtype=torch.int32, device=device),
                    "ring": torch.ones((), dtype=torch.bool, device=device)}
        return kma.init_clustered_cache(batch, cfg.num_kv_heads, hd, kc=kc,
                                        capacity=cap, recent=recent,
                                        dtype=dtype, device=device)

    return {f"{i}_{sub}": {n: t.expand(n_groups, *t.shape).clone()
                           for n, t in one(sub).items()}
            for i, sub in enumerate(subs)}


def clustered_geometry(cfg: ArchConfig, max_seq: int) -> tuple[int, int]:
    """(num_clusters, per-cluster capacity) for a given context length."""
    kc = max(cfg.kv_cluster_k, min(1024, max_seq // 512))
    cap = int(max_seq / kc * cfg.kv_cluster_capacity_factor)
    cap = max(16, ((cap + 127) // 128) * 128)
    return kc, cap
