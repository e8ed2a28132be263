"""Architecture configs the port serves (dense slice: smollm-360m)."""

from repro_torch.configs.base import ArchConfig, get_config, reduce_config, register
from repro_torch.configs import smollm_360m  # noqa: F401 — registration side effect

__all__ = ["ArchConfig", "get_config", "reduce_config", "register"]
