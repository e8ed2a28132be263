"""Architecture configuration schema (dense fields) and the config registry.

The port's copy of ``repro/configs/base.py`` for the dense decoder slice:
one :class:`ArchConfig` per architecture, registered by name.  The field
names and defaults match the JAX package's, so a config built here and one
built there describe the same model.  ``reduce_config`` is the same-family
shrink of ``repro/launch/train.py`` used by the CPU tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "register", "get_config", "reduce_config"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_theta_local: float = 1e4  # theta for attn_local layers
    local_window: Optional[int] = None  # sliding-window size for local layers
    pattern: Tuple[str, ...] = ("attn",)  # layer-kind pattern, tiled over depth
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        from repro_torch import configs as _c  # populates the registry

        del _c
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def reduce_config(cfg: ArchConfig, d_model: int = 128, vocab: int = 512) -> ArchConfig:
    """Reduced same-family config for CPU runs (the dense branch of the
    JAX package's ``launch/train.reduce_config``)."""
    kw = dict(n_layers=len(cfg.pattern) * 2, d_model=d_model, vocab_size=vocab)
    if cfg.n_heads:
        kw.update(n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 4), head_dim=16)
    if cfg.d_ff:
        kw.update(d_ff=d_model * 2)
    return dataclasses.replace(cfg, **kw)
