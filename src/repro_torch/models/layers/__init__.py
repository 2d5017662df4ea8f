"""repro_torch.models.layers — attention (port of ``repro/models/layers``;
MLA, MoE, Mamba2 and xLSTM wait for ROADMAP.md queue A item 8a)."""
