"""Architecture configs the port serves and trains (smollm-360m, qwen2-72b, starcoder2-7b and gemma3-27b
dense; granite-moe-3b-a800m and deepseek-moe-16b MoE; mamba2-2.7b SSM; zamba2-2.7b hybrid;
seamless-m4t-medium encoder-decoder; paligemma-3b VLM)."""

from repro_torch.configs.base import SHAPES, ArchConfig, MoEConfig, Shape, SSMConfig, get_config, reduce_config, register
from repro_torch.configs import (  # noqa: F401 — registration side effect
    deepseek_moe_16b,
    gemma3_27b,
    granite_moe_3b_a800m,
    mamba2_2p7b,
    paligemma_3b,
    qwen2_72b,
    seamless_m4t_medium,
    smollm_360m,
    starcoder2_7b,
    zamba2_2p7b,
)

from repro_torch.configs.base import _REGISTRY as REGISTRY

ARCH_NAMES = sorted(REGISTRY)

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "Shape", "SHAPES", "get_config", "reduce_config", "register",
           "REGISTRY", "ARCH_NAMES"]  # fmt: skip
