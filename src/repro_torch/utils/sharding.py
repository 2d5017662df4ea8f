"""Logical-axis rules: k-means programs speak logical axes, the mesh names
physical ones.

Port of ``DEFAULT_RULES`` and ``rules_for_mesh`` of
``repro/utils/sharding.py`` (l.30-54). The k-means logical axes are
``"points"`` (data parallelism over N: the Lloyd, streaming and IVF-build
reductions) and ``"cells"`` (the centroid axis K: the two-stage argmin and
the sharded FlashIVF), resolved onto a ``torch.distributed`` ``DeviceMesh``
by ``core.parallel.ParallelContext.for_mesh``. The other names are the
reference's LM rules, kept so that one table serves both; their resolvers
(``resolve_spec``, ``named_tree``, ``constrain``) come with the trainer.
"""
from __future__ import annotations

# logical -> tuple of physical mesh axis names (order matters)
DEFAULT_RULES = {
    "fsdp": ("data",),
    "tp": ("model",),
    "dp": ("pod", "data"),
    "sp": ("data",),
    "mdl": ("model",),     # explicit model-axis placement (e.g. KV seq split)
    "expert": ("model",),
    # k-means logical axes: points ride the data-parallel axes, cells the
    # model axis
    "points": ("pod", "data"),
    "cells": ("model",),
}


def mesh_axis_names(mesh) -> tuple[str, ...]:
    """The named dims of a ``DeviceMesh`` (``mesh_dim_names``)."""
    return tuple(mesh.mesh_dim_names or ())


def rules_for_mesh(mesh) -> dict:
    """``DEFAULT_RULES`` adapted to ``mesh``: with a ``"pod"`` axis the
    data-parallel names span pods too, else they take ``"data"`` alone."""
    rules = dict(DEFAULT_RULES)
    if "pod" in mesh_axis_names(mesh):
        rules["fsdp"] = ("pod", "data")   # FSDP spans pods too
        rules["dp"] = ("pod", "data")
        rules["points"] = ("pod", "data")
    else:
        rules["dp"] = ("data",)
        rules["points"] = ("data",)
    return rules
