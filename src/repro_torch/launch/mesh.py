"""Mesh factory of the launchers — a thin delegation to ``core.parallel``.

Port of ``repro/launch/mesh.py``: every mesh of the port is built by
``core.parallel.build_mesh``; these names only keep the launchers' import
path. Functions, not module-level meshes, so importing this module touches
no device or process group.
"""
from __future__ import annotations

from repro_torch.core.parallel import (build_mesh, make_host_mesh,  # noqa: F401
                                       make_production_mesh, parse_mesh_flag)
