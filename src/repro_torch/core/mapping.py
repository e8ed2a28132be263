"""Tile-centric mappings (paper §4.1) — the static helpers the port needs.

The port's copy of ``cdiv`` and ``effective_channels`` from
``repro/core/mapping.py``: the f_C feasibility rule (a channel count that
does not divide the chunked extent falls back to the largest divisor, with
one warning per unique clamp).
"""

from __future__ import annotations

import warnings

from repro_torch.core.comp_tiles import largest_divisor

__all__ = ["cdiv", "effective_channels"]


def cdiv(a: int, b: int) -> int:
    """Ceiling division (host-side)."""
    return -(-a // b)


# fallbacks already reported, keyed (kind, extent, requested): one line per
# unique clamp, not one per call
_WARNED_CLAMPS = set()


def effective_channels(extent: int, requested: int, *, kind: str = "", warn: bool = True) -> int:
    """f_C feasibility: largest channel count <= ``requested`` dividing ``extent``.

    Warns once per unique (kind, extent, requested) clamp; ``warn=False`` is
    for feasibility probes that expect clamping.
    """
    req = max(1, int(requested))
    c = largest_divisor(extent, req)
    if c != req and warn:
        key = (kind, int(extent), req)
        if key not in _WARNED_CLAMPS:
            _WARNED_CLAMPS.add(key)
            warnings.warn(
                f"{kind or 'tile plan'}: num_channels={requested} does not divide "
                f"extent {extent}; using largest divisor {c}",
                stacklevel=2,
            )
    return c
