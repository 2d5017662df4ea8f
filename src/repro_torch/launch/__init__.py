"""repro_torch.launch — entry points of the port (``launch/serve.py``:
FlashIVF search serving)."""
