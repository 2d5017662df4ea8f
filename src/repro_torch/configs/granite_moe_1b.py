"""Granite-3.0 1B-a400m — 32-expert top-8 MoE [hf:ibm-granite]."""
from repro_torch.configs.base import ArchConfig, register

GRANITE_MOE_1B = register(ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    head_dim=64, d_ff=512, vocab_size=49155,
    num_experts=32, experts_per_token=8,
    attention="gqa", rope_theta=10000.0, act="silu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
