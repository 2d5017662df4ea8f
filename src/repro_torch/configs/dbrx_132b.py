"""DBRX-132B — 16-expert top-4 fine-grained MoE [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ArchConfig, register

DBRX_132B = register(ArchConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    head_dim=128, d_ff=10752, vocab_size=100352,
    num_experts=16, experts_per_token=4,
    attention="gqa", rope_theta=500000.0, act="silu", norm="layernorm",
    source="hf:databricks/dbrx-base",
))
