"""repro_torch.checkpoint — async checkpoints of nested tensor state, in the
JAX package's npz + manifest format (``checkpoint/checkpointer.py``)."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, array_manifest,
                                                 validate_arrays)

__all__ = ["Checkpointer", "array_manifest", "validate_arrays"]
