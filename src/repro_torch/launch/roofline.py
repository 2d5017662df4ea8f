"""Collective wire bytes and roofline terms of one rank's step.

Port of ``repro/launch/hlo_analysis.py``'s model (l.1-12, l.99). The
reference parses the collectives out of optimized HLO text; the port counts
them as the step runs (``launch.op_cost``), so this module keeps only the
model: the wire bytes of one collective of each of the reference's five
kinds, and the per-rank roofline seconds. With P the group size and S the
collective's result bytes:

  all-reduce        : 2 * S * (P-1)/P      (ring: reduce-scatter + all-gather)
  all-gather        : S * (P-1)/P          (S = full gathered result)
  reduce-scatter    : S * (P-1)            (S = scattered result shard)
  all-to-all        : S * (P-1)/P
  collective-permute: S

The peaks default to the NVIDIA H100 SXM5 datasheet (not measured here):
989 TFLOP/s dense bf16 tensor-core math, 3.35 TB/s HBM3, and 450 GB/s of
NVLink 4 a direction (its 900 GB/s counts both directions). One link
figure for every collective is the reference's simplification (one ICI
rate): a production mesh of 256 ranks spans 32 nodes of 8 cards, and a
collective whose group leaves a node runs at the inter-node network's
rate, not NVLink's.
"""
from __future__ import annotations

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# NVIDIA H100 SXM5 datasheet figures
H100_BF16_FLOPS = 989e12     # dense bf16, tensor cores
H100_HBM_BW = 3.35e12        # HBM3, bytes/s
H100_NVLINK_BW = 450e9       # NVLink 4, bytes/s a direction (900 GB/s both)


def wire_bytes(kind: str, size: float, group: int) -> float:
    """The bytes one rank sends for one collective of ``kind`` whose result
    holds ``size`` bytes, over a group of ``group`` ranks."""
    p = group
    if kind == "all-reduce":
        return 2.0 * size * (p - 1) / p
    if kind in ("all-gather", "all-to-all"):
        return size * (p - 1) / p
    if kind == "reduce-scatter":
        return float(size * (p - 1))
    if kind == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective kind {kind!r}; one of {KINDS}")


def roofline_terms(flops: float, hbm_bytes: float, wire_bytes: float,
                   chips: int, *, flops_peak: float = H100_BF16_FLOPS,
                   hbm_bw: float = H100_HBM_BW,
                   ici_bw: float = H100_NVLINK_BW) -> dict:
    """Per-rank roofline seconds. ``flops`` and the bytes are one rank's
    (the step each rank runs), so ``chips`` is not divided out; it is kept
    for the reference's signature."""
    del chips
    terms = {"compute_s": flops / flops_peak,
             "memory_s": hbm_bytes / hbm_bw,
             "collective_s": wire_bytes / ici_bw}
    terms["bound"] = max(("compute_s", "memory_s", "collective_s"),
                         key=lambda k: terms[k])
    return terms
