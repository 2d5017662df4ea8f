"""Phi-3-vision-4.2B — phi3-mini backbone + CLIP frontend (stub)."""
from repro_torch.configs.base import ArchConfig, register

PHI3_VISION = register(ArchConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    head_dim=96, d_ff=8192, vocab_size=32064,
    attention="gqa", rope_theta=10000.0, act="silu",
    frontend="clip_stub", frontend_seq=576,   # 24x24 patches
    source="hf:microsoft/Phi-3-vision-128k-instruct",
))
