"""QuantSpec — the wire half of the dtype axis, split from accumulation.

The port's copy of ``repro/core/quant.py``.  :class:`QuantSpec` rides
:class:`~repro_torch.core.channels.BlockChannel` beside the comm and compute
halves and says only what travels:

  ``wire_dtype``   what tiles and flowing partials travel in; ``None``
                   inherits ``CompSpec.accum_dtype`` (encode / decode are
                   the identity, so the path is bitwise the pre-split one).
                   A float wire ("bfloat16") is a cast at the send edge; a
                   quantized wire ("int8", "float8_e4m3fn") sends codes with
                   their scales riding the same permute (:class:`WirePayload`).
  ``granularity``  "per_tile": one scale per flowing tile, each tile quantized
                   once at its send edge; "per_channel": one scale per
                   trailing output channel.
  ``weight_dtype`` weight-only quantization ("int8" | "int4"): weights packed
                   once (:func:`pack_weight`) and dequantized per block inside
                   the consumer GEMM (``core/comp_tiles.blocked_dot``; inside
                   the fused kernels on the card).
  ``zero_point``   asymmetric weight codes (per-column zero points).

**Rank-stacked values.**  The port's operands carry every rank on dim 0
(``[W, ...]``, ``backend/mesh.World``), where the JAX package's are one
rank's shard.  So every reduction that makes a scale skips dim 0: a
"per_tile" scale is one scalar per rank (shape ``[W]``), a "per_channel"
scale ``[W, n]``, and :func:`pack_weight` of a rank-stacked ``w [W, k, n]``
reduces over ``k`` only (``scale [W, n]``).  Rank r's codes and scale are
then bitwise the reference's for rank r's shard, and no rank's codes depend
on another's (AG tiles are quantized once at their origin, so the error does
not grow with the world size).  A plain ``[k, n]`` weight packs as in the
reference (``scale [n]``).

This module is the port's one quantization codepath:
``training/compression.py`` re-exports :func:`quantize_int8` /
:func:`dequantize_int8` from here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

__all__ = [
    "QuantSpec",
    "WirePayload",
    "PackedWeight",
    "WIRE_DTYPES",
    "GRANULARITIES",
    "WEIGHT_DTYPES",
    "quantize_int8",
    "dequantize_int8",
    "quantize",
    "dequantize",
    "encode_tree",
    "decode_tree",
    "pack_weight",
    "dequantize_weight",
    "wire_itemsize",
    "dtype_name",
    "as_dtype",
]

_FLOAT_WIRES = ("float32", "bfloat16", "float16")
_QUANT_WIRES = ("int8", "float8_e4m3fn")
WIRE_DTYPES = _FLOAT_WIRES + _QUANT_WIRES
GRANULARITIES = ("per_tile", "per_channel")
WEIGHT_DTYPES = ("int8", "int4")

# symmetric ranges: int8 +/-127 (the gradient-compression contract); fp8 e4m3 saturates at 448
_QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0}
_WEIGHT_QMAX = {"int8": 127.0, "int4": 7.0}

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
    "int8": torch.int8,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the JAX package's dtype strings)."""
    return str(dtype).removeprefix("torch.")


def as_dtype(value: Union[str, torch.dtype]) -> torch.dtype:
    """A ``torch.dtype`` from itself or its name."""
    if isinstance(value, torch.dtype):
        return value
    if isinstance(value, str) and value in _DTYPES:
        return _DTYPES[value]
    raise ValueError(f"unsupported dtype {value!r}")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Wire / flow dtype descriptor, validated at construction (the JAX
    package's rules and messages)."""

    wire_dtype: Optional[str] = None
    granularity: str = "per_tile"
    weight_dtype: Optional[str] = None
    zero_point: bool = False

    def __post_init__(self):
        if self.wire_dtype is not None and self.wire_dtype not in WIRE_DTYPES:
            raise ValueError(
                f"unsupported wire_dtype {self.wire_dtype!r}; supported: {WIRE_DTYPES} (None inherits accum_dtype)"
            )
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"unsupported quant granularity {self.granularity!r}; supported: {GRANULARITIES}")
        if self.weight_dtype is not None and self.weight_dtype not in WEIGHT_DTYPES:
            raise ValueError(
                f"unsupported weight_dtype {self.weight_dtype!r}; supported: {WEIGHT_DTYPES} "
                "(None = full-precision weights)"
            )
        if self.zero_point and self.weight_dtype is None:
            raise ValueError(
                "zero_point=True is only meaningful with weight_dtype set (asymmetric weight-only quantization)"
            )

    @property
    def is_quantized(self) -> bool:
        """True when the wire carries scaled integer / fp8 payloads."""
        return self.wire_dtype in _QUANT_WIRES

    def resolve_wire(self, accum_dtype) -> str:
        """The dtype name that actually travels, given the reduction dtype."""
        return self.wire_dtype if self.wire_dtype is not None else dtype_name(as_dtype(accum_dtype))

    def is_identity(self, accum_dtype) -> bool:
        """True when encode / decode are no-ops (the bitwise-identical path)."""
        return self.resolve_wire(accum_dtype) == dtype_name(as_dtype(accum_dtype))

    def scale_slots(self, flow: str, world: int, num_channels: int, steps: int) -> int:
        """Scale-table coverage of a quantized wire: "ag" tiles are quantized
        once at their origin (world x C), flowing reductions at every send
        edge ((steps - 1) x C), "ag_rs" / "a2a_rs" both."""
        if not self.is_quantized:
            return 0
        if flow == "ag":
            return world * num_channels
        if flow in ("rs", "a2a"):
            return max(0, steps - 1) * num_channels
        if flow in ("ag_rs", "a2a_rs"):
            return world * num_channels + max(0, steps - 1) * num_channels
        raise ValueError(f"unknown flow kind {flow!r}")


# ---- wire payloads and packed weights ---------------------------------------


@dataclasses.dataclass
class WirePayload:
    """A quantized tile on the wire: codes ``q`` [W, ...] and their scale
    (``[W]`` per tile, ``[W, n]`` per channel), permuted together."""

    q: torch.Tensor
    scale: torch.Tensor


@dataclasses.dataclass
class PackedWeight:
    """A weight packed for weight-only dequant-GEMM.

    ``q``: int8 codes (int4 codes in an int8 container) of the weight's
    shape, rank-stacked ``[W, k, n]`` or plain ``[k, n]``; ``scale`` and
    ``zero`` (asymmetric, else None): float32 per output column, of ``q``'s
    shape without ``k`` (``[W, n]`` / ``[n]``); ``dtype`` the logical code
    width ("int8" | "int4")."""

    q: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor] = None
    dtype: str = "int8"

    @property
    def shape(self):
        return self.q.shape

    @property
    def device(self) -> torch.device:
        return self.q.device

    def col_slice(self, lo: int, hi: int) -> "PackedWeight":
        """The packed view of ``w[..., lo:hi]`` (scales and zeros are per column)."""
        zero = None if self.zero is None else self.zero[..., lo:hi]
        return PackedWeight(self.q[..., lo:hi], self.scale[..., lo:hi], zero, self.dtype)

    def map(self, fn) -> "PackedWeight":
        """``fn`` applied to every tensor of the packing (e.g. ``.to(device)``, ``.contiguous()``)."""
        return PackedWeight(fn(self.q), fn(self.scale), None if self.zero is None else fn(self.zero), self.dtype)

    def lead(self, n: int) -> "PackedWeight":
        """[W, k, n] -> [W, 1 (x n), k, n]: broadcast over ``n`` batch dims."""
        if n == 0:
            return self
        return self.map(lambda t: t.reshape((t.shape[0],) + (1,) * n + tuple(t.shape[1:])))


# ---- the one quantization codepath -------------------------------------------


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (codes, float32 scale); scale floor 1e-12, +/-127 clip."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _scale_view(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    """A [W] or [W, n] scale shaped to broadcast against a [W, ..., n] payload."""
    if scale.dim() == 1:
        return scale.reshape((scale.shape[0],) + (1,) * (ndim - 1))
    return scale.reshape((scale.shape[0],) + (1,) * (ndim - 2) + (scale.shape[-1],))


def quantize(x: torch.Tensor, wire_dtype: str, granularity: str = "per_tile") -> WirePayload:
    """Symmetric absmax quantization of one rank-stacked flowing tile ``x [W, ...]``.

    "per_tile": one scale per rank, over every dim but 0 (``[W]``);
    "per_channel": one per rank and trailing channel, over every dim but 0
    and -1 (``[W, n]``)."""
    qmax = _QMAX[wire_dtype]
    x32 = x.to(torch.float32)
    if granularity == "per_channel" and x.dim() >= 2:
        absmax = x32.abs().amax(dim=tuple(range(1, x.dim() - 1))) if x.dim() > 2 else x32.abs()
    else:
        absmax = x32.abs().reshape(x.shape[0], -1).amax(dim=1)
    scale = (torch.clamp(absmax, min=1e-12) / qmax).to(torch.float32)
    y = x32 / _scale_view(scale, x.dim())
    if wire_dtype == "int8":
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:  # fp8: the cast rounds; the scale keeps the payload in range
        q = y.to(torch.float8_e4m3fn)
    return WirePayload(q, scale)


def dequantize(payload: WirePayload, dtype: torch.dtype) -> torch.Tensor:
    q = payload.q
    return (q.to(torch.float32) * _scale_view(payload.scale, q.dim())).to(dtype)


def _map_tree(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, t) for t in tree)
    return fn(tree)


def encode_tree(tree, spec: QuantSpec, accum_dtype):
    """Encode a tree (a tensor, or tuples / lists of them) of flowing values for the wire:
    the identity when the wire inherits ``accum_dtype``, a cast for a float
    wire, :class:`WirePayload` leaves for int8 / fp8.  Non-float leaves (the
    a2a routing tables riding the token tiles) pass through."""
    if spec.is_identity(accum_dtype):
        return tree
    wire = None if spec.is_quantized else as_dtype(spec.resolve_wire(accum_dtype))

    def enc(a):
        if not (isinstance(a, torch.Tensor) and a.is_floating_point()):
            return a
        if spec.is_quantized:
            return quantize(a, spec.wire_dtype, spec.granularity)
        return a.to(wire)

    return _map_tree(enc, tree)


def decode_tree(tree, spec: QuantSpec, accum_dtype):
    """Inverse of :func:`encode_tree`, back to the reduction dtype."""
    if spec.is_identity(accum_dtype):
        return tree
    dt = as_dtype(accum_dtype)

    def dec(v):
        if isinstance(v, WirePayload):
            return dequantize(v, dt)
        if not (isinstance(v, torch.Tensor) and v.is_floating_point()):
            return v
        return v.to(dt)

    return _map_tree(dec, tree)


# ---- weight-only packing -------------------------------------------------------


def pack_weight(w: torch.Tensor, spec: QuantSpec) -> PackedWeight:
    """Pack a ``[k, n]`` or rank-stacked ``[W, k, n]`` weight per output column,
    reducing over ``k`` only (module docstring).  Symmetric, or with
    ``spec.zero_point`` the full asymmetric range (min / max affine); codes
    in an int8 container either way."""
    if spec.weight_dtype is None:
        raise ValueError("pack_weight requires QuantSpec.weight_dtype")
    qmax = _WEIGHT_QMAX[spec.weight_dtype]
    w32 = w.to(torch.float32)
    if spec.zero_point:
        lo, hi = w32.amin(dim=-2), w32.amax(dim=-2)
        scale = torch.clamp(hi - lo, min=1e-12) / (2.0 * qmax)
        zero = torch.round(-qmax - lo / scale)
        q = torch.clamp(torch.round(w32 / scale.unsqueeze(-2)) + zero.unsqueeze(-2), -qmax - 1, qmax)
    else:
        scale = torch.clamp(w32.abs().amax(dim=-2), min=1e-12) / qmax
        zero = None
        q = torch.clamp(torch.round(w32 / scale.unsqueeze(-2)), -qmax, qmax)
    return PackedWeight(
        q.to(torch.int8).contiguous(), scale.to(torch.float32).contiguous(),
        None if zero is None else zero.to(torch.float32).contiguous(), spec.weight_dtype,
    )  # fmt: skip


def dequantize_weight(q, scale, zero=None, dtype=torch.float32) -> torch.Tensor:
    """Dequantize weight codes (or any [k-slice, n-slice] block of them):
    ``(q - zero) * scale`` in float32, ``scale`` / ``zero`` of ``q``'s shape
    without its k dim.  ``blocked_dot`` runs it per block."""
    w = q.to(torch.float32)
    if zero is not None:
        w = w - zero.unsqueeze(-2)
    return (w * scale.unsqueeze(-2)).to(dtype)


def wire_itemsize(wire_dtype: str) -> int:
    """Bytes per element on the wire — what a cost model prices."""
    return torch.empty((), dtype=as_dtype(wire_dtype)).element_size()
