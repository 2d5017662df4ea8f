"""repro_torch.launch — entry points of the port: ``launch/serve.py``
(FlashIVF search and LM serving), ``launch/train.py`` (training) and
``launch/dryrun.py`` (the multi-pod dry-run, with ``op_cost`` and
``roofline``)."""
