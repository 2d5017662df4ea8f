"""ArchConfig: one declarative record per assigned architecture.

Port of ``repro/configs/base.py``, record for record. Every config is
selectable via ``--arch <id>`` in the launcher; the ``reduced()`` view
produces a same-family miniature for CPU tests. The port serves every
record on one device (``models``, ``serve.Engine``).
"""
from __future__ import annotations

import dataclasses

_REGISTRY: dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # attention flavour
    attention: str = "gqa"          # gqa | mla | local_global | none
    rope_theta: float = 10000.0
    window_size: int = 4096         # local layers (local_global)
    attn_softcap: float | None = None
    final_softcap: float | None = None
    query_scale: float | None = None  # None -> 1/sqrt(head_dim)
    qkv_bias: bool = False

    # MLP
    mlp_kind: str = "glu"           # glu | plain | none
    act: str = "silu"
    norm: str = "rmsnorm"           # rmsnorm | rmsnorm_1p | layernorm
    post_norm: bool = False         # gemma2 sandwich norms

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_group_size: int = 512

    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    hybrid_attn_every: int = 0      # zamba2: shared attn block every N layers
    slstm_every: int = 0            # xlstm: sLSTM block every N layers
    mlstm_proj_factor: float = 2.0
    ssm_chunk: int = 256            # chunkwise-scan length (mamba2/mLSTM)

    # enc-dec / frontends
    encoder_layers: int = 0
    cross_attention: bool = False
    frontend: str | None = None     # clip_stub | audio_stub
    frontend_seq: int = 0           # patches / frames provided by the stub
    learned_pos: bool = False       # whisper

    tie_embeddings: bool = True

    # k-means integration (the paper's technique as a model feature)
    kv_cluster_k: int = 64          # clusters over cached keys
    kv_cluster_top: int = 8         # clusters gathered per decode step
    kv_cluster_capacity_factor: float = 2.0
    kmeans_attn: bool = False       # cluster-routed sparse attention (train)

    # shapes this arch skips (with reason), e.g. {"long_500k": "..."}
    skip_shapes: tuple = ()

    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def vocab_padded(self, multiple: int = 512) -> int:
        return ((self.vocab_size + multiple - 1) // multiple) * multiple

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_padded() * d * (1 if self.tie_embeddings else 2)
        if self.frontend:
            emb += self.frontend_seq and d * d  # stub projection
        per_layer = 0
        attn = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d
        if self.attention == "mla":
            attn = (d * 768 + 768 * self.num_heads * 96
                    + d * (256 + 32) + 256 * self.num_heads * 128
                    + self.num_heads * 64 * d)
        if self.mlp_kind == "glu":
            mlp = 3 * d * self.d_ff
        elif self.mlp_kind == "plain":
            mlp = 2 * d * self.d_ff
        else:
            mlp = 0
        if self.num_experts:
            mlp = self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        if self.family == "ssm":
            di = int(d * self.mlstm_proj_factor)
            per_layer = 2 * d * di + 3 * di * di + di * d
            total_blocks = self.num_layers * per_layer
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            mamba = (2 * d * di + 2 * d * self.ssm_state
                     + d * (di // self.ssm_head_dim) + di * d)
            n_attn_apps = self.num_layers // max(self.hybrid_attn_every, 1)
            n_mamba = self.num_layers - n_attn_apps
            total_blocks = n_mamba * mamba + (attn + mlp)  # shared attn stored once
        else:
            per_layer = attn + mlp
            total_blocks = self.num_layers * per_layer
        enc = self.encoder_layers * (attn + mlp) if self.encoder_layers else 0
        cross = self.num_layers * attn if self.cross_attention else 0
        return emb + total_blocks + enc + cross

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.n_params()
        d = self.d_model
        dense_moe = self.num_experts * 3 * d * self.d_ff
        active_moe = self.experts_per_token * 3 * d * self.d_ff
        return self.n_params() - self.num_layers * (dense_moe - active_moe)

    def reduced(self) -> "ArchConfig":
        """Same-family miniature for CPU smoke tests."""
        if self.family == "ssm":
            n_layers, slstm_every, hybrid_every = 4, 2, 0
        elif self.family == "hybrid":
            n_layers, slstm_every, hybrid_every = 6, 0, 3
        else:
            n_layers, slstm_every, hybrid_every = 2, 0, 0
        return dataclasses.replace(
            self,
            num_layers=n_layers,
            slstm_every=slstm_every,
            hybrid_attn_every=hybrid_every,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads < self.num_heads else 4,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            head_dim=16 if self.head_dim else 0,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            moe_group_size=64,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_seq=16 if self.frontend else 0,
            window_size=32,
            kv_cluster_k=8,
            kv_cluster_top=2,
        )


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ArchConfig]:
    if not _REGISTRY:
        load_all()
    return dict(_REGISTRY)


def load_all() -> None:
    import importlib
    for mod in ("xlstm_1p3b", "dbrx_132b", "granite_moe_1b", "zamba2_7b",
                "phi3_vision", "starcoder2_3b", "minicpm3_4b", "llama3_8b",
                "gemma2_27b", "whisper_base"):
        importlib.import_module(f"repro_torch.configs.{mod}")


# ---------------------------------------------------------------------------
# Input shapes (assigned): every arch is paired with all four unless skipped.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
