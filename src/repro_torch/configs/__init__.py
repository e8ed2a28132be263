"""Architecture configs the port serves (smollm-360m dense; granite-moe-3b-a800m and deepseek-moe-16b MoE;
mamba2-2.7b SSM)."""

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, get_config, reduce_config, register
from repro_torch.configs import (  # noqa: F401 — registration side effect
    deepseek_moe_16b,
    granite_moe_3b_a800m,
    mamba2_2p7b,
    smollm_360m,
)

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "get_config", "reduce_config", "register"]
