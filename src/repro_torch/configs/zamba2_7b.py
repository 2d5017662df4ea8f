"""Zamba2-7B — Mamba2 backbone + shared attention block [arXiv:2411.15242].

81 layers: every 3rd position applies the single *shared* transformer
block (params stored once, 27 applications); the rest are Mamba2.
"""
from repro_torch.configs.base import ArchConfig, register

ZAMBA2_7B = register(ArchConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    head_dim=112, d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    hybrid_attn_every=3,
    attention="gqa", rope_theta=10000.0, act="gelu",
    source="arXiv:2411.15242",
))
