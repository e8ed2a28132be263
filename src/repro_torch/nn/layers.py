"""Primitive layers and the TP head layout — the port of ``repro/nn/layers.py``.

``rms_norm`` scales by ``1 + scale`` (the JAX package stores the norm gain
as an offset from one), and ``rope`` rotates *interleaved* even/odd pairs
(not the half-split form).  ``he_init`` / ``emb_init`` draw from an explicit
``torch.Generator``; they do not reproduce ``jax.random``'s numbers, so the
tests carry JAX weights across with ``convert.from_jax_params``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope", "he_init", "emb_init", "GQALayout", "gqa_layout", "sync_kv_grad", "cdiv", "ACTS"]

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, theta: float = 1e4):
    """Rotary embedding on interleaved pairs. q/k: [..., S, n_heads, hd];
    positions: [S] or [B, S] (broadcast against the trailing dims)."""
    hd = q.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=q.device) / hd))
    ang = positions.float()[..., None] * freqs  # [..., S, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]

    def rot(x):
        x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
        xr = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return xr.reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)


def he_init(
    shape: Sequence[int],
    generator: torch.Generator,
    dtype: torch.dtype,
    device: torch.device,
    fan_in: Optional[int] = None,
) -> torch.Tensor:
    if torch.device(device).type == "meta":  # abstract evaluation: the shape alone, nothing drawn
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    fan = (fan_in or shape[-2]) if len(shape) >= 2 else shape[-1]
    w = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return (w * (1.0 / math.sqrt(fan))).to(dtype)


def emb_init(shape: Sequence[int], generator: torch.Generator, dtype: torch.dtype, device: torch.device):
    if torch.device(device).type == "meta":  # abstract evaluation: the shape alone, nothing drawn
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    w = torch.randn(tuple(shape), generator=generator, device=device, dtype=torch.float32)
    return (w * 0.02).to(dtype)


@dataclasses.dataclass(frozen=True)
class GQALayout:
    """TP layout for (possibly awkward) GQA head counts on a fixed TP degree.

    h_pad:    q heads padded to a multiple of tp (pad heads held at zero)
    h_loc:    q heads per rank
    kv_pad:   kv heads padded to a divisor-or-multiple alignment of tp
    kv_loc:   kv heads per rank
    rep:      ranks sharing one kv head (kv weights stored expanded)
    kv_store: stored kv head count
    """

    n_heads: int
    n_kv: int
    tp: int
    h_pad: int
    h_loc: int
    kv_pad: int
    kv_loc: int
    rep: int
    kv_store: int


def gqa_layout(n_heads: int, n_kv: int, tp: int) -> GQALayout:
    if n_kv >= tp:
        kv_pad = cdiv(n_kv, tp) * tp
        kv_loc = kv_pad // tp
        rep = 1
        kv_store = kv_pad
    else:
        # smallest divisor of tp that is >= n_kv
        kv_pad = next(d for d in range(n_kv, tp + 1) if tp % d == 0)
        rep = tp // kv_pad
        kv_loc = 1
        kv_store = tp
    h_pad = cdiv(n_heads, tp * kv_loc) * tp * kv_loc
    h_loc = h_pad // tp
    return GQALayout(n_heads, n_kv, tp, h_pad, h_loc, kv_pad, kv_loc, rep, kv_store)


def sync_kv_grad(g: torch.Tensor, layout: GQALayout) -> torch.Tensor:
    """Average the ``rep`` copies of each kv head's gradient: the port of
    ``repro/nn/layers.sync_kv_grad`` for a rank-stacked kv gradient
    ``[W, ..., kv_loc * 2 hd]``.  With ``rep > 1`` each rank holds one
    stored kv head (``kv_loc == 1``), and the copies of kv head j sit on
    ranks ``j * rep .. j * rep + rep - 1``."""
    if layout.rep == 1:
        return g
    grouped = g.reshape((layout.kv_pad, layout.rep) + tuple(g.shape[1:]))
    return grouped.mean(1, keepdim=True).expand_as(grouped).reshape(g.shape)
