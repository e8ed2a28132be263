"""Architecture configs the port serves (smollm-360m dense, granite-moe-3b-a800m MoE, mamba2-2.7b SSM)."""

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, get_config, reduce_config, register
from repro_torch.configs import granite_moe_3b_a800m, mamba2_2p7b, smollm_360m  # noqa: F401 — registration side effect

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "get_config", "reduce_config", "register"]
