"""repro_torch.train — the training step factories (``train.train_step``)
and the fault-tolerant loop (``train.trainer``)."""
