"""repro_torch.data — the deterministic synthetic training data
(``data.pipeline``)."""
