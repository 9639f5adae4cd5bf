"""Architecture configs served by the port: ``get_config(name)`` returns the
full published config, ``smoke_config(name)`` its reduced CPU-test twin."""
from repro_torch.configs.base import (
    ARCH_IDS,
    ArchConfig,
    get_config,
    smoke_config,
)

__all__ = ["ArchConfig", "ARCH_IDS", "get_config", "smoke_config"]
