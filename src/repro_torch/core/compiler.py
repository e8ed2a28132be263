"""TileLink frontend: compile ``(kind, BlockChannel)`` tile programs.

The port's counterpart of ``repro/core/compiler.py`` for the single-kind
forms ``ag_matmul``, ``matmul_rs``, ``ag_attention`` and ``ag_moe``.  ``compile_overlap``
validates the (kind, backend) pair and returns a callable over
rank-stacked operands; both backends execute the same :class:`~repro_torch.core.plan.TilePlan`:

  backend="eager"  the eager schedule executor (``core/overlap.run_plan``),
                   a permute per step on the world's rank dimension — the
                   counterpart of the JAX package's ``"xla"`` backend;
  backend="fused"  the fused Hopper kernels (``kernels/ag_gemm.py``,
                   ``kernels/gemm_rs.py``) reading the plan's tables — the
                   counterpart of ``"pallas"``.  ``ag_moe`` has no fused
                   communication kernel (nor has the JAX package's "pallas"
                   table): its permutes stay the eager executor's, and the
                   expert GEMMs run on the grouped kernel
                   (``kernels/grouped_matmul.py``).  Under autograd
                   ``ag_matmul`` / ``matmul_rs`` run through one
                   ``torch.autograd.Function`` each whose backward is the
                   other fused kernel (the transpose of an all-gather is a
                   reduce-scatter): dx of AG+GEMM is a GEMM+RS, dx of
                   GEMM+RS an AG+GEMM, and each weight gradient one
                   ``torch.matmul`` on the rows an AG+GEMM launch gathered.
                   ``ag_attention``
                   likewise: the JAX package's "pallas" table has no such
                   kind (its AG-KV maps to the TPU's copy engine), so the
                   port's fused form is the xla form with a hand-written
                   consumer — the eager permutes of ``ring_attention``, and
                   flash attention (``kernels/flash_attention.py``)
                   consuming each arrived KV tile for every rank in one
                   launch per step and channel, its state carried between
                   launches.  On CPU tensors the kernel wrappers run their
                   plain versions.

``overlapped=False`` selects the non-overlapped baselines (eager only, as
in the JAX package; ``ParallelContext(mode="baseline")`` compiles every op
there whatever its backend).  The ``ag_matmul`` / ``matmul_rs``
baselines run through one ``torch.autograd.Function`` each whose backward is the other baseline (on the card a bf16 baseline GEMM is
``torch.bmm`` with ``out_dtype=float32``, which has no derivative): dx of
gather-then-GEMM is GEMM-then-reduce-scatter and the other way round.  Any
other kind, and the fused backend without overlap, raise the one
structured ``NotImplementedError`` of :func:`unsupported_error`.

The list form compiles a two-op sequence (``SEQ_KINDS``; entries are kind
names or ``(kind, channel)`` pairs, ``channel`` the shared default):

  ["matmul_rs", "ag_matmul"]     the RS -> AG layer seam,
                                 ``fn(x, w1, w2, *, residual=None, glue=None)
                                 -> (y, ag_out)`` (``core/overlap.matmul_rs_ag``).
                                 Eager only: the JAX package's seq form
                                 raises on "pallas", so "fused" raises here
                                 (``ParallelContext.matmul_rs_ag`` compiles
                                 it on "eager" whatever its backend).  If the
                                 two halves cannot share one channel split
                                 (diverging clamps, other axes), the call
                                 warns once per signature
                                 (:class:`SeamFallbackWarning`) and runs the
                                 unfused pair.
  ["a2a_dispatch", "combine_rs"] the expert-parallel MoE pair,
                                 ``fn(x, ids, wts, w_gu, w_down, *,
                                 capacity_factor, act) -> out``
                                 (``core/moe_overlap.a2a_moe``).  "eager" as
                                 the JAX package's "xla"; "fused" keeps the
                                 eager exchanges and runs each landed tile's
                                 expert GEMMs on the grouped kernel, as
                                 ``ag_moe`` does.

``overlapped=False`` gives the unfused pair (``a2a_moe_baseline`` with the
overlapped path's per-sub-chunk capacity), eager only.

``channel="auto"`` tunes instead of naming a design point: the returned
callable resolves the best ``BlockChannel`` for its operands' per-rank shapes
and dtype through ``repro_torch.tune`` (a cache hit, the cost model, or, on
the card by default, CUDA-event timings of the candidates on this backend's
kernels), then compiles through the normal path.  The list form resolves
the pair jointly: the seam prices fused against the two halves' own
winners (``tune.resolve_seq``; an unfused verdict is the tuner's choice,
not a fallback, and warns nothing), the a2a pair fused against its baseline
(``tune.resolve_a2a``).  ``comp=`` is the compute half: ``"auto"`` adds the
tile lattice to the search (the comm half held at an explicit channel's
point, or searched with it under ``channel="auto"``), a ``CompSpec`` pins
tile and accum dtype, a bare ``(tm, tn, tk)`` the tile only.

``quant=`` pins a :class:`~repro_torch.core.quant.QuantSpec` on the channel
(on both channels of the list form), as in the JAX package: the eager
executor encodes each send edge and decodes at the consumer (int8 / fp8
payloads with their scales, or a float cast).  ``quant="auto"`` / ``True``
opens the wire axis to the tuner (with an explicit channel, the wire alone
is searched); the a2a pair's MoE kinds have no wire axis, so there it
changes nothing.  On ``backend="fused"`` a quantized activation wire
(int8 / fp8) raises ``NotImplementedError`` when the kernel is called, as
the JAX package's Pallas kernels do, so the tuner never offers one there;
``gemm_rs`` carries a float wire (e.g. bf16 partials under
float32 accumulation) and ``ag_gemm`` gathers ``x`` in its own dtype.  The
fused ``ag_attention`` / ``ag_moe`` / a2a forms take the identity wire only.
Both fused GEMM kernels take a :class:`~repro_torch.core.quant.PackedWeight`
``w`` (int8 / int4 codes dequantized inside the kernel); under autograd a
packed weight raises (packed weights are frozen).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable, Optional

import torch

from repro_torch.backend.mesh import World
from repro_torch.core import moe_overlap as _moe
from repro_torch.core import overlap as _eager
from repro_torch.core.channels import BlockChannel, CompSpec
from repro_torch.core.mapping import effective_channels
from repro_torch.core.quant import PackedWeight, QuantSpec, dtype_name

__all__ = [
    "compile_overlap",
    "unsupported_error",
    "SeamFallbackWarning",
    "KINDS",
    "SEQ_KINDS",
    "BACKENDS",
]

KINDS = ("ag_matmul", "matmul_rs", "ag_attention", "ag_moe")  # on both backends
BACKENDS = ("eager", "fused")
SEAM_SEQ = ("matmul_rs", "ag_matmul")  # eager only
A2A_SEQ = ("a2a_dispatch", "combine_rs")  # on both backends
SEQ_KINDS = (SEAM_SEQ, A2A_SEQ)


def unsupported_error(kind, backend: str, overlapped: bool = True) -> NotImplementedError:
    """The one structured error for every unsupported (kind or sequence, backend, overlapped) case."""
    return NotImplementedError(
        f"compile_overlap: kind={kind!r} with overlapped={overlapped} is not supported on "
        f"backend={backend!r} (supported: kinds {KINDS} on every backend; sequences {A2A_SEQ} on every "
        f"backend and {SEAM_SEQ} on 'eager'; overlapped=False on 'eager' only)"
    )


class SeamFallbackWarning(UserWarning):
    """A requested fused seam ran as the unfused op pair instead.

    Warned once per (axes, world, extents, channel requests): the unfused
    pair gives the same numbers, but the seam's collective time is exposed.
    """


_WARNED_SEAMS = set()


def _seam_incompatibility(ch_rs: BlockChannel, ch_ag: BlockChannel, world: int, m_glob: int, n_mid: int):
    """Why this seam cannot fuse (None when it can): both halves must share
    one effective channel count, but RS chunks the N columns and AG the M / W
    rows, and the two extents can clamp one request differently."""
    if ch_rs.axis != ch_ag.axis:
        return f"producer runs over axis {ch_rs.axis!r} but consumer over {ch_ag.axis!r} (mismatched worlds)"
    if m_glob % world:
        return f"RS rows {m_glob} are not divisible by world {world}"
    nch_rs = effective_channels(n_mid, ch_rs.num_channels, kind="matmul_rs", warn=False)
    nch_ag = effective_channels(m_glob // world, ch_ag.num_channels, kind="ag_matmul", warn=False)
    if nch_rs != nch_ag:
        return (
            f"effective channel counts diverge: RS extent {n_mid} gives C={nch_rs} (requested "
            f"{ch_rs.num_channels}) but AG extent {m_glob // world} gives C={nch_ag} (requested {ch_ag.num_channels})"
        )
    return None


def _warn_seam_fallback(reason: str, key) -> None:
    if key not in _WARNED_SEAMS:
        _WARNED_SEAMS.add(key)
        warnings.warn(
            SeamFallbackWarning(
                f"compile_overlap: seam is schedule-incompatible - {reason}; degrading to the unfused "
                "matmul_rs + ag_matmul pair (numerically identical, but the seam collective time is exposed)"
            ),
            stacklevel=3,
        )


def _seq_unfused(ch_rs: BlockChannel, ch_ag: BlockChannel, world: World, overlapped: bool, kw: dict) -> Callable:
    """The unfused pair with the seam's ``(y, ag_out)`` contract."""
    rs = compile_overlap("matmul_rs", ch_rs, world=world, overlapped=overlapped, **kw)
    ag = compile_overlap("ag_matmul", ch_ag, world=world, overlapped=overlapped, **kw)

    def pair_fn(x, w1, w2, *, residual=None, glue=None, **call_kw):
        out = rs(x, w1, **call_kw)
        y = out if residual is None else residual + out
        h = y if glue is None else glue(y)
        return y, ag(h, w2, **call_kw)

    return pair_fn


def _normalize_quant(quant):
    """None | QuantSpec | "auto" (``True`` is shorthand for ``"auto"``)."""
    if quant is None or isinstance(quant, QuantSpec):
        return quant
    if quant is True or quant == "auto":
        return "auto"
    raise ValueError(f"quant must be None, 'auto'/True, or a QuantSpec, got {quant!r}")


def _check_fused_wire(kind, channel: BlockChannel, backend: str, overlapped: bool):
    """The fused forms that keep eager permutes (``ag_attention``, ``ag_moe``,
    the a2a pair) take the identity wire only; the fused GEMM kernels refuse
    a quantized wire themselves (``kernels/ag_gemm.refuse_quantized_wire``)."""
    if backend == "fused" and kind not in ("ag_matmul", "matmul_rs") and not channel.quant.is_identity(
        channel.comp.accum_dtype
    ):
        raise unsupported_error(kind, backend, overlapped)


def _normalize_comp(comp):
    """None | "auto" | CompSpec | (tm, tn, tk): a bare tuple pins the tile
    only, a CompSpec the whole compute half (tile and accum dtype)."""
    if comp is None or comp == "auto" or isinstance(comp, CompSpec):
        return comp
    if isinstance(comp, (tuple, list)) and len(comp) == 3:
        tile = tuple(int(t) for t in comp)
        if any(t < 1 for t in tile):
            raise ValueError(f"comp tile must be 3 positive ints, got {comp!r}")
        return tile
    raise ValueError(f"comp must be None, 'auto', a CompSpec, or a (tm, tn, tk) tuple, got {comp!r}")


def _widen_flows(space):
    """``space`` (default ``DEFAULT_SPACE``) with the int8 wire axis opened."""
    from repro_torch.tune import DEFAULT_SPACE

    return dataclasses.replace(space or DEFAULT_SPACE, flows=(None, "int8"))


def _pinned_space(ch: BlockChannel, **kw):
    """A space holding ``ch``'s comm and compute point, widened by ``kw``."""
    from repro_torch.tune import Space

    fields = dict(
        orders=(ch.comm.order,),
        channel_counts=(ch.num_channels,),
        accum_dtypes=(dtype_name(ch.comp.accum_dtype),),
        comp_tiles=(tuple(ch.comp.tile),),
    )
    return Space(**{**fields, **kw})


def _compile_seq(
    ops, channel, world: World, backend: str, overlapped: bool, quant, kw: dict, *, axis, tune_ranker, tune_base,
    tune_space,
):  # fmt: skip
    """The list form (see the module docstring)."""
    kinds, chans = [], []
    for op in ops:
        k, ch = op if isinstance(op, (tuple, list)) else (op, channel)
        kinds.append(k)
        chans.append(BlockChannel(axis=axis) if ch is None else ch)
    kinds = tuple(kinds)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if kinds not in SEQ_KINDS or (backend == "fused" and (kinds == SEAM_SEQ or not overlapped)):
        raise unsupported_error(kinds, backend, overlapped)
    for ch in chans:
        if not (ch == "auto" or isinstance(ch, BlockChannel)):
            raise TypeError(f"channel must be a BlockChannel or 'auto', got {ch!r}")
    tune = dict(world=world, ranker=tune_ranker, overlapped=overlapped, kw=kw)
    if "auto" in chans:
        base = next((ch for ch in chans if isinstance(ch, BlockChannel)), tune_base)
        if isinstance(quant, QuantSpec):
            base = (base or BlockChannel(axis=axis)).with_(quant=quant)
        axis = base.axis if base is not None else axis
        if kinds == A2A_SEQ:  # the MoE kinds have no wire axis: quant="auto" changes nothing
            return _auto_overlap_a2a(axis=axis, backend=backend, base=base, space=tune_space, **tune)
        space = _widen_flows(tune_space) if quant == "auto" else tune_space
        return _auto_overlap_seq(axis=axis, base=base, space=space, **tune)
    if isinstance(quant, QuantSpec):
        chans = [ch.with_(quant=quant) for ch in chans]
    for ch in chans:
        _check_fused_wire(kinds, ch, backend, overlapped)
    ch0, ch1 = chans
    if kinds == A2A_SEQ:
        if not overlapped:
            return functools.partial(_moe.a2a_moe_baseline, world=world, num_channels=ch0.num_channels, **kw)
        return functools.partial(_moe.a2a_moe, world=world, channel=ch0, channel2=ch1, grouped=backend == "fused", **kw)
    if quant == "auto":  # the wire alone is searched, the producer's comm and compute point held
        space = _pinned_space(ch0, flows=(None, "int8"))
        return _auto_overlap_seq(axis=ch0.axis, base=ch0, space=space, **tune)
    if not overlapped:
        return _seq_unfused(ch0, ch1, world, False, kw)

    def seq_fn(x, w1, w2, *, residual=None, glue=None, **call_kw):
        m_glob, n_mid = x.shape[-2], w1.shape[-1]
        reason = _seam_incompatibility(ch0, ch1, world.size, m_glob, n_mid)
        if reason is not None:
            key = (ch0.axis, ch1.axis, world.size, m_glob, n_mid, ch0.num_channels, ch1.num_channels)
            _warn_seam_fallback(reason, key)
            return _seq_unfused(ch0, ch1, world, True, kw)(x, w1, w2, residual=residual, glue=glue, **call_kw)
        return _eager.matmul_rs_ag(
            x, w1, w2, world=world, channel=ch0, channel2=ch1, residual=residual, glue=glue, **kw, **call_kw
        )

    return seq_fn


def _rank_shapes(args):
    """Per-rank operand shapes (a rank-stacked operand without its leading W)."""
    return [tuple(a.shape[1:]) for a in args]


def _auto_overlap_a2a(*, world: World, axis: str, backend: str, base, space, ranker, overlapped: bool, kw: dict):
    """The a2a pair resolved per shape (``tune.resolve_a2a``): the
    overlapped pipeline with the shared winner, or the baseline when no
    shared candidate builds."""

    def auto_fn(x, topk_ids, topk_w, w_gu, w_down, **call_kw):
        from repro_torch.tune import resolve_a2a

        fused, ch_d, ch_c = resolve_a2a(
            shapes=_rank_shapes((x, topk_ids, topk_w, w_gu, w_down)), world=world, axis=axis, backend=backend,
            dtype=x.dtype, base=base, ranker=ranker, capacity_factor=call_kw.get("capacity_factor"),
            **({} if space is None else {"space": space}),
        )  # fmt: skip
        if fused and overlapped:
            fn = functools.partial(
                _moe.a2a_moe, world=world, channel=ch_d, channel2=ch_c, grouped=backend == "fused", **kw
            )
        else:
            fn = functools.partial(_moe.a2a_moe_baseline, world=world, num_channels=ch_d.num_channels, **kw)
        return fn(x, topk_ids, topk_w, w_gu, w_down, **call_kw)

    return auto_fn


def _auto_overlap_seq(*, world: World, axis: str, base, space, ranker, overlapped: bool, kw: dict):
    """The RS -> AG seam resolved per shape (``tune.resolve_seq``): fused
    with the shared winner, or the two halves' own winners unfused — the
    tuner's verdict, so no :class:`SeamFallbackWarning`."""

    def auto_fn(x, w1, w2, *, residual=None, glue=None, **call_kw):
        from repro_torch.tune import resolve_seq

        fused, ch_rs, ch_ag = resolve_seq(
            shapes=_rank_shapes((x, w1, w2)), world=world, axis=axis, dtype=x.dtype, base=base, ranker=ranker,
            **({} if space is None else {"space": space}),
        )  # fmt: skip
        if fused:
            fn = _compile_seq(
                [("matmul_rs", ch_rs), ("ag_matmul", ch_ag)], None, world, "eager", overlapped, None, kw, axis=axis,
                tune_ranker=None, tune_base=None, tune_space=None,
            )  # fmt: skip
        else:
            fn = _seq_unfused(ch_rs, ch_ag, world, overlapped, kw)
        return fn(x, w1, w2, residual=residual, glue=glue, **call_kw)

    return auto_fn


def _auto_overlap(kind: str, *, world: World, backend: str, overlapped: bool, axis: str, ranker, comp, quant, base, kw):
    """One kind resolved per call from its operands' per-rank shapes and
    dtype (``tune.resolve_channel``), then compiled as an explicit channel.

    The space: a pinned ``CompSpec`` or tile with the comm half searched;
    ``comp="auto"`` the tile lattice, jointly with the comm half (no base)
    or with the base channel's comm point held; ``quant="auto"`` with a
    base channel and nothing else tuned the wire alone; the wire axis opened
    on top of any of these under ``quant="auto"``."""
    from repro_torch.tune import COMP_TILE_LATTICE, DEFAULT_SPACE, JOINT_SPACE, Space

    if isinstance(comp, CompSpec):
        space = Space(accum_dtypes=(dtype_name(comp.accum_dtype),), comp_tiles=(tuple(comp.tile),))
    elif isinstance(comp, tuple):
        space = Space(comp_tiles=(comp,))
    elif comp == "auto" and base is not None:
        space = _pinned_space(base, comp_tiles=COMP_TILE_LATTICE)
    elif comp == "auto":
        space = JOINT_SPACE
    elif quant == "auto" and base is not None:
        space = _pinned_space(base)
    else:
        space = DEFAULT_SPACE
    if quant == "auto":
        space = dataclasses.replace(space, flows=(None, "int8"))

    def auto_fn(*args, **call_kw):
        from repro_torch.tune import resolve_channel

        channel = resolve_channel(
            kind, shapes=_rank_shapes(args), world=world, axis=axis, backend=backend, dtype=args[0].dtype, base=base,
            ranker=ranker, space=space,
        )  # fmt: skip
        fn = compile_overlap(kind, channel, world=world, backend=backend, overlapped=overlapped, **kw)
        return fn(*args, **call_kw)

    return auto_fn


def compile_overlap(
    kind,
    channel=None,
    *,
    world: World,
    backend: str = "eager",
    overlapped: bool = True,
    quant=None,
    comp=None,
    axis: str = "model",
    tune_ranker: Optional[str] = None,
    tune_base: Optional[BlockChannel] = None,
    tune_space=None,
    **kw,
) -> Callable:
    """Compile a tile program for ``world``; returns ``fn(x, w) -> out``
    (``fn(q, k, v) -> out`` for ``ag_attention``, ``fn(x, ids, wts, w_gu,
    w_down) -> out`` for ``ag_moe``).  A list or tuple ``kind`` is the list
    form (module docstring).  ``channel``: a :class:`BlockChannel` or
    ``"auto"``; ``quant``: None (the channel's QuantSpec), a QuantSpec pinned
    on the channel, or ``"auto"`` / ``True`` (the tuner's wire axis);
    ``comp``: None, ``"auto"``, a CompSpec or a ``(tm, tn, tk)`` tile.
    ``axis`` names the tuned channel's axis under ``"auto"``;
    ``tune_ranker`` is the tuner's ranker ("auto", "measure", "model");
    ``tune_base`` / ``tune_space`` (list form) the base channel and space."""
    quant = _normalize_quant(quant)
    if isinstance(kind, (list, tuple)):
        if comp is not None:
            raise ValueError("compile_overlap: comp applies to single-kind programs only")
        return _compile_seq(
            kind, channel, world, backend, overlapped, quant, kw, axis=axis, tune_ranker=tune_ranker,
            tune_base=tune_base, tune_space=tune_space,
        )  # fmt: skip
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if kind not in KINDS or (backend == "fused" and not overlapped):
        raise unsupported_error(kind, backend, overlapped)
    comp = _normalize_comp(comp)
    auto = dict(world=world, backend=backend, overlapped=overlapped, ranker=tune_ranker, kw=kw)
    if channel == "auto":
        base = BlockChannel(axis=axis, comp=comp) if isinstance(comp, CompSpec) else None
        if isinstance(quant, QuantSpec):
            base = (base or BlockChannel(axis=axis)).with_(quant=quant)
        return _auto_overlap(kind, axis=axis, comp=comp, quant=quant if quant == "auto" else None, base=base, **auto)
    if not isinstance(channel, BlockChannel):
        raise TypeError(f"channel must be a BlockChannel or 'auto', got {type(channel)}")
    if isinstance(quant, QuantSpec):
        channel = channel.with_(quant=quant)
    if isinstance(comp, CompSpec):
        channel = channel.with_(comp=comp)
    elif isinstance(comp, tuple):
        channel = channel.with_(comp=dataclasses.replace(channel.comp, tile=comp))
    if comp == "auto" or quant == "auto":
        return _auto_overlap(
            kind, axis=channel.axis, comp="auto" if comp == "auto" else None, quant=quant, base=channel, **auto
        )
    _check_fused_wire(kind, channel, backend, overlapped)

    if backend == "eager":
        if not overlapped and kind in _BASELINE_GRADS:
            return functools.partial(_baseline_call, kind, world, **kw)
        table = {
            ("ag_matmul", True): _eager.ag_matmul,
            ("matmul_rs", True): _eager.matmul_rs,
            ("ag_attention", True): _eager.ring_attention,
            ("ag_attention", False): _eager.ag_attention_baseline,
            ("ag_moe", True): _moe.ag_moe,
            ("ag_moe", False): _moe.ag_moe_baseline,
        }
        return functools.partial(table[(kind, overlapped)], world=world, channel=channel, **kw)
    if kind == "ag_moe":
        return functools.partial(_moe.ag_moe, world=world, channel=channel, grouped=True, **kw)
    if kind == "ag_attention":
        return functools.partial(_eager.ring_attention, world=world, channel=channel, fused=True, **kw)

    from repro_torch import kernels as _k

    fused, grad = {"ag_matmul": (_k.ag_gemm, _AgMatmul), "matmul_rs": (_k.gemm_rs, _MatmulRs)}[kind]
    return functools.partial(_fused_call, fused, grad, world, channel, kw)


def _fused_call(fn, grad, world: World, channel: BlockChannel, kw: dict, x, w, out_dtype=None):
    """Run a fused kernel wrapper with the executor's call signature; under
    autograd (grad mode on and an operand that requires grad) through the
    kind's :class:`torch.autograd.Function` ``grad``; a
    :class:`~repro_torch.core.quant.PackedWeight` (frozen codes) raises
    there rather than differentiate through codes."""
    if x.shape[0] != world.held:
        raise ValueError(f"expected a rank-stacked [W={world.held}, ...] operand, got {tuple(x.shape)}")
    if world.nprocs > 1:  # the peer route: the kernels push into the other processes' cards
        kw = {**kw, "world": world}
    packed = isinstance(w, PackedWeight)
    if torch.is_grad_enabled() and (x.requires_grad or (not packed and w.requires_grad)):
        if packed:
            raise NotImplementedError(
                "compile_overlap: the fused ops do not differentiate through packed weights (they are frozen); "
                "run the forward under torch.no_grad()"
            )
        out = grad.apply(x, w, channel, kw)
    else:
        out = fn(x, w, channel=channel, **kw)
    return out if out_dtype is None else out.to(out_dtype)


def _baseline_call(kind: str, world: World, x, w, out_dtype=None):
    """A baseline GEMM collective with the executor's call signature,
    through its :class:`torch.autograd.Function` (with no operand that
    requires grad, ``apply`` runs only the forward)."""
    _eager._check_ranked(x, w, world, kind + "_baseline")
    return _BASELINE_GRADS[kind].apply(x, w, world, out_dtype or x.dtype)


class _AgMatmulBaseline(torch.autograd.Function):
    """Gather-then-GEMM under autograd.  dx is the transpose's baseline, one
    GEMM per rank into float32 partials then the reduce-scatter
    (``matmul_rs_baseline`` of dy and w^T); dw = AG(x)^T dy from the rows
    the forward gathered."""

    @staticmethod
    def forward(ctx, x, w, world, out_dtype):
        gathered = world.all_gather(x, dim=x.dim() - 3)
        ctx.save_for_backward(gathered, w)
        ctx.world, ctx.x_dtype = world, x.dtype
        return _eager._baseline_dot(gathered, w, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        gathered, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _eager.matmul_rs_baseline(dy, w.transpose(1, 2), world=ctx.world, out_dtype=ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(gathered.to(dy.dtype), dy).to(w.dtype)
        return dx, dw, None, None


class _MatmulRsBaseline(torch.autograd.Function):
    """GEMM-then-reduce-scatter under autograd.  dx is the transpose's
    baseline, every rank's dy gathered then one GEMM per rank with w^T;
    dw = x^T AG(dy) from the same gathered rows."""

    @staticmethod
    def forward(ctx, x, w, world, out_dtype):
        ctx.save_for_backward(x, w)
        ctx.world = world
        return _eager.matmul_rs_baseline(x, w, world=world, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        gathered = ctx.world.all_gather(dy, dim=dy.dim() - 3)
        dx = _eager._baseline_dot(gathered, w.transpose(1, 2), x.dtype) if ctx.needs_input_grad[0] else None
        dw = _weight_grad(x.to(dy.dtype), gathered).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


_BASELINE_GRADS = {"ag_matmul": _AgMatmulBaseline, "matmul_rs": _MatmulRsBaseline}


def _transposed(w):
    """[W, a, b] -> a contiguous [W, b, a] (the bf16 routes read weights by TMA)."""
    return w.transpose(1, 2).contiguous()


def _weight_grad(a, b):
    """Per rank a^T b over every leading row: a [W, *, R, K], b [W, *, R, N] -> [W, K, N]."""
    world = a.shape[0]
    return torch.matmul(a.reshape(world, -1, a.shape[-1]).transpose(1, 2), b.reshape(world, -1, b.shape[-1]))


class _AgMatmul(torch.autograd.Function):
    """AG+GEMM under autograd.  dx is the transpose's collective, a GEMM+RS
    (the fused kernel: rank r's rows of sum_q dy[q] w[q]^T); dw = AG(x)^T dy
    from the rows the forward launch gathered (no second all-gather).  A
    world over processes (``kw["world"]``) runs both passes on the peer
    route over the same world."""

    @staticmethod
    def forward(ctx, x, w, channel, kw):
        from repro_torch.kernels import ag_gemm

        out, gathered = ag_gemm(x, w, channel=channel, return_gathered=True, **kw)
        ctx.save_for_backward(gathered, w)
        ctx.channel, ctx.world = channel, kw.get("world")
        return out

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels import gemm_rs

        gathered, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = gemm_rs(dy, _transposed(w), channel=ctx.channel, world=ctx.world) if ctx.needs_input_grad[0] else None
        dw = _weight_grad(gathered, dy) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None


class _MatmulRs(torch.autograd.Function):
    """GEMM+RS under autograd.  dx is the transpose's collective, an AG+GEMM
    (the fused kernel: every rank's dy gathered, times w[r]^T); dw = x^T
    AG(dy) from the rows that launch gathered.  A world over processes
    runs both passes on the peer route, as :class:`_AgMatmul`."""

    @staticmethod
    def forward(ctx, x, w, channel, kw):
        from repro_torch.kernels import gemm_rs

        ctx.save_for_backward(x, w)
        ctx.channel, ctx.world = channel, kw.get("world")
        return gemm_rs(x, w, channel=channel, **kw)

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels import ag_gemm

        x, w = ctx.saved_tensors
        dx, gathered = ag_gemm(dy.contiguous(), _transposed(w), channel=ctx.channel, return_gathered=True,
                               world=ctx.world)  # fmt: skip
        dw = _weight_grad(x, gathered) if ctx.needs_input_grad[1] else None
        return (dx if ctx.needs_input_grad[0] else None), dw, None, None

