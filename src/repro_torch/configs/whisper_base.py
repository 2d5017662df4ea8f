"""Whisper-base — enc-dec with conv audio frontend (stub)
[arXiv:2212.04356]. long_500k skipped: enc-dec published arch has no
sub-quadratic decoder path (see DESIGN.md §Arch-applicability)."""
from repro_torch.configs.base import ArchConfig, register

WHISPER_BASE = register(ArchConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=51865,
    attention="gqa", mlp_kind="plain", act="gelu", norm="layernorm",
    qkv_bias=True, learned_pos=True,
    encoder_layers=6, cross_attention=True,
    frontend="audio_stub", frontend_seq=1500,
    skip_shapes=(("long_500k", "enc-dec: no sub-quadratic decoder path in "
                  "published arch"),),
    source="arXiv:2212.04356",
))
