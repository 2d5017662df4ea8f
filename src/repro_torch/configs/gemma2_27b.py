"""Gemma2-27B — alternating local/global attention, logit softcaps
[arXiv:2408.00118]."""
from repro_torch.configs.base import ArchConfig, register

GEMMA2_27B = register(ArchConfig(
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
    head_dim=128, d_ff=36864, vocab_size=256000,
    attention="local_global", window_size=4096,
    attn_softcap=50.0, final_softcap=30.0,
    query_scale=(4608 // 32) ** -0.5,     # query_pre_attn_scalar = d/H = 144
    norm="rmsnorm_1p", post_norm=True, act="gelu",
    rope_theta=10000.0,
    source="arXiv:2408.00118",
))
