"""repro_torch.models.layers — attention (with whisper's cross-attention),
MLA, MoE, Mamba2 and xLSTM (port of ``repro/models/layers``)."""
