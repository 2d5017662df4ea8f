"""repro_torch.utils — logical-axis rules of the parallel layer
(``utils.sharding``), the tree helpers (``utils.tree``) and arrays on the
host as the reference's files hold them (``utils.host``)."""
