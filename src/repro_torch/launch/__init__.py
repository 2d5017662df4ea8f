"""repro_torch.launch — entry points of the port: ``launch/serve.py``
(FlashIVF search and LM serving) and ``launch/train.py`` (training)."""
