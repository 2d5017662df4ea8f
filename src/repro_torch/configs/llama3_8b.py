"""Llama-3-8B — GQA(kv=8), 128k vocab [arXiv:2407.21783]."""
from repro_torch.configs.base import ArchConfig, register

LLAMA3_8B = register(ArchConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=128256,
    attention="gqa", rope_theta=500000.0, act="silu",
    tie_embeddings=False,
    kv_cluster_capacity_factor=1.25,   # §Perf clustered/H3: tighter buckets

    source="arXiv:2407.21783",
))
