"""repro_torch — the PyTorch + CUDA (Hopper) port of flash-kmeans.

Laid out module for module like ``repro``: ``repro_torch.kernels`` holds
the hand-written CUDA kernels (``csrc/*.cu``, built with ``nvcc`` at first
use), their plain PyTorch versions and the ``ops`` wrappers;
``repro_torch.core`` the planner, init, ``KMeans`` and the numpy bridge to
the JAX package. Imports ``torch`` only, never ``jax`` or ``repro``.
"""
