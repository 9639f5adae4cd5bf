"""Architecture configs served by the port: ``get_config(name)`` returns the
full published config, ``smoke_config(name)`` its reduced CPU-test twin;
``SHAPES`` and ``cells()`` are the dry run's shape registry."""
from repro_torch.configs.base import (
    ARCH_IDS,
    PAPER_IDS,
    REFERENCE_ARCH_IDS,
    SHAPES,
    ArchConfig,
    ShapeSpec,
    cells,
    get_config,
    list_archs,
    smoke_config,
)

__all__ = ["ArchConfig", "ARCH_IDS", "PAPER_IDS", "REFERENCE_ARCH_IDS",
           "SHAPES", "ShapeSpec", "cells", "get_config", "list_archs",
           "smoke_config"]
