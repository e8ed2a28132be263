"""Architecture configs the port serves (smollm-360m dense, granite-moe-3b-a800m MoE)."""

from repro_torch.configs.base import ArchConfig, MoEConfig, get_config, reduce_config, register
from repro_torch.configs import granite_moe_3b_a800m, smollm_360m  # noqa: F401 — registration side effect

__all__ = ["ArchConfig", "MoEConfig", "get_config", "reduce_config", "register"]
