"""Compute-tile utilities — the CompSpec (tm, tn, tk) half, for the port.

The port's copy of ``repro/core/comp_tiles.py``:

  * :func:`largest_divisor` / :func:`resolve_tile` clamp a requested tile
    against the operand extents it must divide — the same rule
    ``mapping.effective_channels`` applies to the comm half;
  * :func:`blocked_dot` computes a (possibly batched) GEMM in (tm, tn, tk)
    blocks accumulated in the accum dtype — the eager executor honors a
    non-default tile through it.

``DEFAULT_TILE`` (128, 128, 128) means "let the backend choose": the eager
executor does one ``torch.matmul``, the fused kernels use their native
blocking.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["DEFAULT_TILE", "largest_divisor", "resolve_tile", "blocked_dot"]

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


def blocked_dot(
    a: torch.Tensor,
    b: torch.Tensor,
    tile: Tuple[int, int, int],
    accum: torch.dtype = torch.float32,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``a @ b`` computed in (tm, tn, tk) blocks, accumulated in ``accum``.

    ``a``: [..., m, k]; ``b``: [..., k, n] (broadcast over the leading dims).
    A tile covering the whole problem is one matmul.
    """
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    tm, tn, tk = resolve_tile(tile, m, n, k)
    a = a.to(accum)
    b = b.to(accum)
    if (tm, tn, tk) == (m, n, k):
        out = torch.matmul(a, b)
    else:
        lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
        out = torch.zeros(lead + (m, n), dtype=accum, device=a.device)
        for mi in range(0, m, tm):
            for ni in range(0, n, tn):
                blk = out[..., mi : mi + tm, ni : ni + tn]
                for ki in range(0, k, tk):
                    blk += torch.matmul(a[..., mi : mi + tm, ki : ki + tk], b[..., ki : ki + tk, ni : ni + tn])
    return out.to(out_dtype) if out_dtype is not None else out
