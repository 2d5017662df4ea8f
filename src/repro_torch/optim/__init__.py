"""repro_torch.optim — AdamW (``optim.adamw``) and the compression of the
statistics and gradients the parallel layer reduces over slow links
(``optim.compression``)."""
