"""Decoder-only dense LM — the port of ``repro/models/lm.py`` for the dense
serve path (``"attn"`` layers with a dense MLP).

A Python loop over a list of layers replaces the JAX package's ``lax.scan``
over stacked parameters.  Parameters are rank-stacked (``convert.py``):

  embed     [W, V_pad/W, D]   vocab rows sharded over the ranks
  head      [D, V_pad]        the LM head (the embedding transposed when tied)
  final_ln  [D]
  layers    [{"mixer": {ln, wqkv [W, D, (h_loc+2 kv_loc)*hd], wo [W, h_loc*hd, D]},
              "ffn":   {ln, w_gu [W, D, 2 f_loc], w_down [W, f_loc, D]}}, ...]

``prefill`` runs every layer's TP forward (the fused kernels on the card)
and fills the KV caches; ``decode_step`` then advances every slot by up to
C tokens.  The LM head runs on the tile-GEMM kernel when
``pc.backend == "fused"``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.kernels.matmul import matmul, matmul_plain
from repro_torch.nn import attention, ffn
from repro_torch.nn.layers import emb_init, rms_norm
from repro_torch.parallel.context import ParallelContext

__all__ = [
    "LayerDef",
    "layer_plan",
    "init",
    "padded_vocab",
    "embed_tokens",
    "logits",
    "forward",
    "prefill",
    "init_caches",
    "decode_step",
]


@dataclasses.dataclass(frozen=True)
class LayerDef:
    kind: str  # attn | attn_local
    ffn_kind: Optional[str]  # mlp | None
    window: Optional[int]
    theta: float

    def apply_seq(self, params, x, pc, cfg):
        x = attention.apply_seq(params["mixer"], x, pc, cfg, causal=True, window=self.window, rope_theta=self.theta)
        return ffn.apply_seq(params["ffn"], x, pc, cfg) if self.ffn_kind == "mlp" else x

    def apply_prefill(self, params, x, pc, cfg, max_len: int):
        """Like apply_seq, but also returns this layer's decode cache with the
        sequence dimension padded to ``max_len`` (a ring for window layers)."""
        x, kv = attention.apply_seq(
            params["mixer"], x, pc, cfg, causal=True, window=self.window, rope_theta=self.theta, return_kv=True
        )
        s_len = kv["k"].shape[3]
        if self.window is not None and self.window < max_len:
            w = self.window
            if s_len >= w:
                kv = {n: torch.roll(a[:, :, :, s_len - w :], s_len % w, dims=3) for n, a in kv.items()}
            else:
                kv = {n: _pad_seq(a, w) for n, a in kv.items()}
        else:
            kv = {n: _pad_seq(a, max_len) for n, a in kv.items()}
        if self.ffn_kind == "mlp":
            x = ffn.apply_seq(params["ffn"], x, pc, cfg)
        return x, kv

    def init_cache(self, cfg, pc, batch, max_len, dtype):
        return attention.init_cache(cfg, pc.tp, batch, max_len, dtype, pc.device, window=self.window)

    def apply_decode(self, params, x, cache, cache_len, pc, cfg, q_valid=None):
        x, cache = attention.apply_decode(
            params["mixer"], x, cache, cache_len, pc, cfg, window=self.window, rope_theta=self.theta, q_valid=q_valid
        )
        if self.ffn_kind == "mlp":
            x = ffn.apply_decode(params["ffn"], x, pc, cfg)
        return x, cache


def _pad_seq(a: torch.Tensor, length: int) -> torch.Tensor:
    out = torch.zeros(a.shape[:3] + (length,) + a.shape[4:], dtype=a.dtype, device=a.device)
    out[:, :, :, : a.shape[3]] = a
    return out


def _layer_def(cfg, kind: str) -> LayerDef:
    if kind not in ("attn", "attn_local"):
        raise NotImplementedError(f"repro_torch: layer kind {kind!r} is not ported (dense attn layers only)")
    window = cfg.local_window if kind == "attn_local" else None
    theta = cfg.rope_theta_local if kind == "attn_local" else cfg.rope_theta
    return LayerDef(kind, "mlp" if cfg.d_ff else None, window, theta)


def layer_plan(cfg) -> List[LayerDef]:
    """One LayerDef per layer, in depth order."""
    return [_layer_def(cfg, cfg.layer_kind(i)) for i in range(cfg.n_layers)]


def padded_vocab(cfg, tp: int) -> int:
    """Vocab rows padded to the TP degree."""
    return -(-cfg.vocab_size // tp) * tp


def init(cfg, world, generator: torch.Generator, dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Seeded random parameters at the config's size, built on ``device``
    (default: the world's) with the JAX package's init rules and layout."""
    from repro_torch.convert import shard_params

    device = torch.device(device) if device is not None else world.device
    tp = world.size
    glob = {
        "embed": emb_init((padded_vocab(cfg, tp), cfg.d_model), generator, dtype, device),
        "final_ln": torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        glob["lm_head"] = emb_init((cfg.d_model, padded_vocab(cfg, tp)), generator, dtype, device)
    for d in layer_plan(cfg):
        layer = {"mixer": attention.init(cfg, tp, generator, dtype, device)}
        if d.ffn_kind == "mlp":
            layer["ffn"] = ffn.init(cfg, generator, dtype, device)
        glob["layers"].append(layer)
    return shard_params(glob, cfg, world)


def embed_tokens(params: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] -> [B, S, D] (global)."""
    table = params["embed"].reshape(-1, params["embed"].shape[-1])
    return table[tokens]


def logits(params: dict, cfg, pc: ParallelContext, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head: x [B, S, D] (global) -> [B, S, vocab]."""
    x = rms_norm(x, params["final_ln"], cfg.norm_eps)
    gemm = matmul if pc.fused else matmul_plain
    out = gemm(x.reshape(-1, x.shape[-1]).contiguous(), params["head"])
    return out.reshape(x.shape[:-1] + (out.shape[-1],))[..., : cfg.vocab_size]


def _check_seq(pc: ParallelContext, s: int):
    if s % pc.tp:
        raise ValueError(f"sequence length {s} must divide over the {pc.tp} ranks (sequence-parallel residual)")


def forward(params: dict, cfg, pc: ParallelContext, tokens: torch.Tensor) -> torch.Tensor:
    """Teacher-forced logits [B, S, vocab]."""
    _check_seq(pc, tokens.shape[1])
    x = pc.world.shard(embed_tokens(params, cfg, tokens), dim=1)  # [W, B, s_loc, D]
    for d, p in zip(layer_plan(cfg), params["layers"]):
        x = d.apply_seq(p, x, pc, cfg)
    return logits(params, cfg, pc, pc.world.unshard(x, dim=1))


def prefill(params: dict, cfg, pc: ParallelContext, tokens: torch.Tensor, *, max_len: int):
    """Forward pass that also fills the decode caches.

    Returns (logits [B, S, vocab], caches) — decode continues at position S.
    """
    _check_seq(pc, tokens.shape[1])
    x = pc.world.shard(embed_tokens(params, cfg, tokens), dim=1)
    caches = []
    for d, p in zip(layer_plan(cfg), params["layers"]):
        x, c = d.apply_prefill(p, x, pc, cfg, max_len)
        caches.append(c)
    return logits(params, cfg, pc, pc.world.unshard(x, dim=1)), caches


def init_caches(cfg, pc: ParallelContext, batch: int, max_len: int, dtype=torch.bfloat16) -> list:
    return [d.init_cache(cfg, pc, batch, max_len, dtype) for d in layer_plan(cfg)]


def decode_step(params: dict, caches: list, cfg, pc: ParallelContext, tokens: torch.Tensor, cache_len, q_valid=None):
    """One decode step advancing every slot by up to C tokens.

    tokens: [B, C]; ``cache_len``: int or [B]; ``q_valid`` (optional [B]):
    real rows per slot.  Returns (logits [B, C, vocab], caches), the caches
    updated in place.
    """
    x = embed_tokens(params, cfg, tokens)
    for d, p, c in zip(layer_plan(cfg), params["layers"], caches):
        x, _ = d.apply_decode(p, x, c, cache_len, pc, cfg, q_valid=q_valid)
    return logits(params, cfg, pc, x), caches
