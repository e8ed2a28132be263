"""Architecture configuration schema and the config registry.

The port's copy of ``repro/configs/base.py`` (dense, MoE, Mamba-2, the
encoder-decoder and the stub-frontend models): one :class:`ArchConfig` per architecture, registered by
name.  The field names and defaults match the JAX package's, so a config
built here and one built there describe the same model.  ``reduce_config`` is the
same-family shrink of ``repro/launch/train.py`` used by the CPU tests.
``SHAPES`` is the JAX package's input-shape set (the dry-run's cells:
``launch/dryrun``), names, lengths, batches and kinds unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "MoEConfig", "SSMConfig", "Shape", "SHAPES", "PORT_FIELDS", "register", "get_config",
           "reduce_config"]  # fmt: skip


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int  # routed experts (pre-padding)
    top_k: int
    d_expert: int  # expert intermediate size
    num_shared: int = 0  # shared experts (DeepSeek-style)
    first_k_dense: int = 0  # leading layers that use a dense MLP
    dense_d_ff: int = 0  # d_ff of those dense layers
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int  # N
    headdim: int = 64  # P
    n_groups: int = 1  # G (B/C groups)
    d_conv: int = 4
    expand: int = 2  # d_inner = expand * d_model
    chunk: int = 64  # SSD chunk length


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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encoder_layers: int = 0  # >0 -> encoder-decoder (models/encdec)
    frontend: Optional[str] = None  # "vision" | "audio" stub frontends (models/frontends)
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    sub_quadratic: bool = False  # eligible for long-context decode
    enc_len: int = 4096  # stub encoder length for enc-dec decode
    # the port's own field (``PORT_FIELDS``): scale the embedding by sqrt(d_model),
    # which the JAX package decides by ``family == "vlm"`` or a "gemma" name
    embed_scale: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    def layer_kind(self, i: int) -> str:
        if self.moe and i < self.moe.first_k_dense:
            return "attn_dense"  # leading dense-MLP layers (DeepSeek)
        return self.pattern[i % len(self.pattern)]

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND model-FLOPs accounting), the JAX package's formula."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in ("attn", "attn_local", "attn_dense", "shared_attn"):
                total += attn
            if kind == "mamba" and self.ssm is not None:
                di = self.ssm.expand * d
                h = di // self.ssm.headdim
                total += d * (2 * di + h + 2 * self.ssm.n_groups * self.ssm.d_state)
                total += di * d + self.ssm.d_conv * di
            if self.moe is not None and kind != "mamba":
                if kind == "attn_dense":
                    total += 3 * d * self.moe.dense_d_ff
                else:
                    e = self.moe.num_experts + self.moe.num_shared
                    total += e * 3 * d * self.moe.d_expert + d * self.moe.num_experts
            elif kind in ("attn", "attn_local", "shared_attn") and self.d_ff:
                total += 3 * d * self.d_ff
        if self.encoder_layers:
            total += self.encoder_layers * (attn + 3 * d * self.d_ff + attn)
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: the top-k and shared experts only)."""
        if self.moe is None:
            return self.param_count()
        e_idle = self.moe.num_experts - self.moe.top_k
        n_moe = sum(1 for i in range(self.n_layers) if self.layer_kind(i) not in ("attn_dense", "mamba"))
        return self.param_count() - n_moe * e_idle * 3 * self.d_model * self.moe.d_expert


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}

# fields of ArchConfig that the JAX package's config does not have
PORT_FIELDS = ("embed_scale",)

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
    """Reduced same-family config for CPU runs (the JAX package's
    ``launch/train.reduce_config``, its encoder branch included); every
    field it does not set (``pattern``, ``local_window``,
    ``rope_theta_local``, ``qkv_bias``, ``act``, ``tie_embeddings``) is
    kept, as there."""
    k0 = cfg.moe.first_k_dense if cfg.moe else 0
    kw = dict(n_layers=len(cfg.pattern) * 2 + k0, d_model=d_model, vocab_size=vocab)
    if cfg.n_heads:
        kw.update(n_heads=8, n_kv_heads=min(cfg.n_kv_heads, 4), head_dim=16)
    if cfg.d_ff:
        kw.update(d_ff=d_model * 2)
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(2, cfg.moe.top_k), d_expert=64, dense_d_ff=d_model * 2
        )
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, headdim=16, chunk=16)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, enc_len=32)
    return dataclasses.replace(cfg, **kw)
