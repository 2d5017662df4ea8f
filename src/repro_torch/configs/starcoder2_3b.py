"""StarCoder2-3B — GQA(kv=2), RoPE, plain-GELU MLP [arXiv:2402.19173]."""
from repro_torch.configs.base import ArchConfig, register

STARCODER2_3B = register(ArchConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2,
    head_dim=128, d_ff=12288, vocab_size=49152,
    attention="gqa", rope_theta=999999.4, mlp_kind="plain", act="gelu",
    norm="layernorm", qkv_bias=True,
    source="arXiv:2402.19173",
))
