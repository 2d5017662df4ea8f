"""Kernels of the port: FlashAssign, sort-inverse update and FlashLloyd as
CUDA C++ for sm_90a (``csrc/``), each beside its plain PyTorch version,
plus the ``ops`` wrappers and the ``ref`` oracles."""
