"""repro_torch.optim — compression of the statistics the parallel layer
reduces over slow links (``optim.compression``)."""
