"""repro_torch.configs — the architecture records (port of ``repro/configs``).

``get_config(name)``, ``all_configs()``, ``ArchConfig`` and the input
``SHAPES``; one module a record, registered on import.
"""
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeSpec,
                                      all_configs, get_config, load_all,
                                      register)

__all__ = ["SHAPES", "ArchConfig", "ShapeSpec", "all_configs", "get_config",
           "load_all", "register"]
