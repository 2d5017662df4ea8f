"""MiniCPM3-4B — Multi-head Latent Attention [hf:openbmb/MiniCPM3-4B]."""
from repro_torch.configs.base import ArchConfig, register

MINICPM3_4B = register(ArchConfig(
    name="minicpm3-4b", family="dense",
    num_layers=62, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=6400, vocab_size=73448,
    attention="mla", rope_theta=10000.0, act="silu",
    source="hf:openbmb/MiniCPM3-4B",
))
