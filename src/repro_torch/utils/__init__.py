"""repro_torch.utils — logical-axis rules of the parallel layer
(``utils.sharding``) and the tree helpers (``utils.tree``)."""
