"""Gradient compression: int8 quantization with error feedback.

The port's copy of ``repro/training/compression.py``.  A gradient is
quantized to int8 with a per-tensor scale, the quantization error is carried
into the next step (error feedback), and the all-reduce moves a quarter of
the bytes.  The codec is ``core/quant``'s (re-exported here), with its
semantics unchanged: symmetric per-tensor scale, 1e-12 floor, +/-127 clip.

:func:`psum_compressed` all-reduces over a world: on the emulated
:class:`~repro_torch.backend.mesh.World` ``g`` and ``err`` are rank-stacked
``[W, ...]`` (one gradient shard per rank); over a
:class:`~repro_torch.backend.mesh.DistWorld` (the data axes, one replica a
process) they are this replica's own.  Either way each rank quantizes its
own gradient, the codes are summed in int32 (exact), the scale is the
largest of the ranks' (a ``MAX`` all-reduce over a DistWorld:
conservative), and the mean divides by the world's size, as the JAX
package's does over a mesh axis.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.backend.mesh import DistWorld, World
from repro_torch.core.quant import dequantize_int8, quantize_int8

__all__ = ["quantize_int8", "dequantize_int8", "compress_with_feedback", "psum_compressed"]


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback int8 compression of one gradient tensor: ``(q, scale,
    new_err)`` with ``g + err == dequantize_int8(q, scale) + new_err``."""
    g32 = g.to(torch.float32) + err
    q, scale = quantize_int8(g32)
    return q, scale, g32 - dequantize_int8(q, scale)


def psum_compressed(g: torch.Tensor, err: torch.Tensor, world) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce ``g`` with int8 error-feedback compression.  On a
    :class:`World`: rank-stacked ``g [W, ...]`` -> ``(mean [W, ...]
    replicated, new_err [W, ...])``; on a :class:`DistWorld`: this
    replica's ``g`` -> ``(mean, new_err)`` of its shape."""
    if isinstance(world, DistWorld):
        if err.shape != g.shape:
            raise ValueError(f"psum_compressed: err {tuple(err.shape)} is not g's {tuple(g.shape)}")
        q, scale, new_err = compress_with_feedback(g, err)
        total = world.psum(q.to(torch.int32))  # exact integer sum
        scale_max = world.pmax(scale.reshape(1))[0]
        return dequantize_int8(total, scale_max) / world.size, new_err
    if not isinstance(world, World):
        raise TypeError(f"psum_compressed: a World or a DistWorld, got {type(world).__name__}")
    if g.shape[0] != world.size or err.shape != g.shape:
        raise ValueError(f"psum_compressed: expected g and err [W={world.size}, ...], got {tuple(g.shape)}")
    qs, scales, errs = zip(*(compress_with_feedback(g[r], err[r]) for r in range(world.size)))
    total = world.psum(torch.stack(qs).to(torch.int32))  # exact integer sum
    scale_max = torch.stack(scales).max()
    mean = dequantize_int8(total, scale_max) / world.size
    return mean.unsqueeze(0).expand_as(g), torch.stack(errs)
