"""TileLink frontend: compile ``(kind, BlockChannel)`` tile programs.

The port's counterpart of ``repro/core/compiler.py`` for the single-kind
forms of the dense slice.  ``compile_overlap`` validates the (kind, backend)
pair and returns a callable over rank-stacked operands; both backends
execute the same :class:`~repro_torch.core.plan.TilePlan`:

  backend="eager"  the eager schedule executor (``core/overlap.run_plan``),
                   a permute per step on the world's rank dimension — the
                   counterpart of the JAX package's ``"xla"`` backend;
  backend="fused"  the fused Hopper kernels (``kernels/ag_gemm.py``,
                   ``kernels/gemm_rs.py``) reading the plan's tables — the
                   counterpart of ``"pallas"``.  On CPU tensors the kernel
                   wrappers run their plain versions.

``overlapped=False`` selects the non-overlapped baselines (eager only, as
in the JAX package).  Any other kind, and the fused backend without
overlap, raise the one structured ``NotImplementedError`` of
:func:`unsupported_error`.
"""

from __future__ import annotations

import functools
from typing import Callable

from repro_torch.backend.mesh import World
from repro_torch.core import overlap as _eager
from repro_torch.core.channels import BlockChannel

__all__ = ["compile_overlap", "unsupported_error", "KINDS", "BACKENDS"]

KINDS = ("ag_matmul", "matmul_rs")  # on both backends
BACKENDS = ("eager", "fused")


def unsupported_error(kind: str, backend: str, overlapped: bool = True) -> NotImplementedError:
    """The one structured error for every unsupported (kind, backend, overlapped) case."""
    return NotImplementedError(
        f"compile_overlap: kind={kind!r} with overlapped={overlapped} is not supported on "
        f"backend={backend!r} (supported: kinds {KINDS} on every backend; overlapped=False on 'eager' only)"
    )


def compile_overlap(
    kind: str,
    channel: BlockChannel,
    *,
    world: World,
    backend: str = "eager",
    overlapped: bool = True,
    **kw,
) -> Callable:
    """Compile a tile program for ``world``; returns ``fn(x, w) -> out``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if not isinstance(channel, BlockChannel):
        raise TypeError(f"channel must be a BlockChannel, got {type(channel)}")
    if kind not in KINDS or (backend == "fused" and not overlapped):
        raise unsupported_error(kind, backend, overlapped)

    if backend == "eager":
        table = {
            ("ag_matmul", True): _eager.ag_matmul,
            ("ag_matmul", False): _eager.ag_matmul_baseline,
            ("matmul_rs", True): _eager.matmul_rs,
            ("matmul_rs", False): _eager.matmul_rs_baseline,
        }
        return functools.partial(table[(kind, overlapped)], world=world, channel=channel, **kw)

    from repro_torch import kernels as _k

    fused = {"ag_matmul": _k.ag_gemm, "matmul_rs": _k.gemm_rs}[kind]
    return functools.partial(_fused_call, fused, world, channel, kw)


def _fused_call(fn, world: World, channel: BlockChannel, kw: dict, x, w, out_dtype=None):
    """Run a fused kernel wrapper with the executor's call signature."""
    if x.shape[0] != world.size:
        raise ValueError(f"expected a rank-stacked [W={world.size}, ...] operand, got {tuple(x.shape)}")
    out = fn(x, w, channel=channel, **kw)
    return out if out_dtype is None else out.to(out_dtype)
