"""Architecture configs of the LM stack (port of `repro.configs`): plain
dataclasses, copied, with each config module's `smoke_config()`."""
from .base import (ArchConfig, ShapeConfig, SHAPES, supports_long_context,
                   valid_cells)
from .registry import ARCHS, all_archs, get_arch, get_smoke

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "supports_long_context",
           "valid_cells", "ARCHS", "all_archs", "get_arch", "get_smoke"]
