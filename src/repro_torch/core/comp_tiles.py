"""Compute-tile utilities — the CompSpec (tm, tn, tk) half, for the port.

The port's copy of ``repro/core/comp_tiles.py``:

  * :func:`largest_divisor` / :func:`resolve_tile` clamp a requested tile
    against the operand extents it must divide — the same rule
    ``mapping.effective_channels`` applies to the comm half;
  * :func:`fma_n_tile` widens the n tile of the fused kernels' float32
    route until their cooperative grid is resident;
  * :func:`blocked_dot` computes a (possibly batched) GEMM in (tm, tn, tk)
    blocks accumulated in the accum dtype — the eager executor honors a
    non-default tile through it, and a
    :class:`~repro_torch.core.quant.PackedWeight` ``b`` is dequantized per
    block at the point of use.

``DEFAULT_TILE`` (128, 128, 128) means "let the backend choose": the eager
executor does one ``torch.matmul``, the fused kernels use their native
blocking.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quant import PackedWeight, dequantize_weight

__all__ = ["DEFAULT_TILE", "largest_divisor", "resolve_tile", "fma_n_tile", "blocked_dot"]

DEFAULT_TILE = (128, 128, 128)


def largest_divisor(extent: int, cap: int) -> int:
    """Largest divisor of ``extent`` that is <= ``cap`` (>= 1), in O(sqrt(extent))."""
    extent = max(1, int(extent))
    cap = min(max(1, int(cap)), extent)
    best = 1
    d = 1
    while d * d <= extent:
        if extent % d == 0:
            if best < d <= cap:
                best = d
            pair = extent // d
            if best < pair <= cap:
                best = pair
        d += 1
    return best


def resolve_tile(tile: Tuple[int, int, int], m: int, n: int, k: int) -> Tuple[int, int, int]:
    """Clamp a requested (tm, tn, tk) to divisors of the GEMM dims (m, n, k)."""
    tm, tn, tk = tile
    return (largest_divisor(m, tm), largest_divisor(n, tn), largest_divisor(k, tk))


def fma_n_tile(n: int, bn: int, blocks: int, sms: int) -> int:
    """The float32 (FMA) route's n tile of the fused kernels: ``bn``
    clamped to a divisor of ``n``, then widened to the smallest divisor whose
    grid of ``n / tile x blocks`` blocks holds at most one block per SM.
    Every block spins on flags that others set, so the cooperative launch
    needs all of them resident, and one block per SM is what any launch of
    these kernels is sure of; a block walks its tile's columns in 128-wide
    steps, so the tile's width changes no output bit."""
    tile = largest_divisor(n, bn)
    if blocks > sms:
        raise ValueError(f"fused FMA kernels: {blocks} (channel, rank) blocks exceed the {sms} SMs of the card")
    while (n // tile) * blocks > sms:
        tile = next(d for d in range(tile + 1, n + 1) if n % d == 0)
    return tile


def blocked_dot(
    a: torch.Tensor,
    b,
    tile: Tuple[int, int, int],
    accum: torch.dtype = torch.float32,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``a @ b`` computed in (tm, tn, tk) blocks, accumulated in ``accum``.

    ``a``: [..., m, k]; ``b``: [..., k, n] (broadcast over the leading dims),
    or a :class:`~repro_torch.core.quant.PackedWeight` of that shape whose
    (tk, tn) blocks are dequantized (``(q - zero) * scale`` in float32, cast
    to ``accum``) at the point of use.  A tile covering the whole problem is
    one matmul.
    """
    packed = isinstance(b, PackedWeight)
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    tm, tn, tk = resolve_tile(tile, m, n, k)
    a = a.to(accum)

    def b_block(ks: slice, ns: slice) -> torch.Tensor:
        if not packed:
            return b[..., ks, ns].to(accum)
        zero = None if b.zero is None else b.zero[..., ns]
        return dequantize_weight(b.q[..., ks, ns], b.scale[..., ns], zero, accum)

    if (tm, tn, tk) == (m, n, k):
        out = torch.matmul(a, b_block(slice(None), slice(None)))
    else:
        lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        out = torch.zeros(lead + (m, n), dtype=accum, device=a.device)
        for mi in range(0, m, tm):
            for ni in range(0, n, tn):
                blk = out[..., mi : mi + tm, ni : ni + tn]
                for ki in range(0, k, tk):
                    b_blk = b_block(slice(ki, ki + tk), slice(ni, ni + tn))
                    blk += torch.matmul(a[..., mi : mi + tm, ki : ki + tk], b_blk)
    return out.to(out_dtype) if out_dtype is not None else out
