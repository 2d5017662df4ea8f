"""xLSTM-1.3B — sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import ArchConfig, register

XLSTM_1P3B = register(ArchConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    attention="none", mlp_kind="none", norm="layernorm",
    slstm_every=8,               # xLSTM[7:1]: 1 sLSTM per 8 blocks
    mlstm_proj_factor=2.0,
    ssm_chunk=1024,              # §Perf xlstm/H2: fewer state-op rounds

    source="arXiv:2405.04517",
))
