"""Candidate enumeration — one design-space walk for both rankers.

The port's counterpart of ``repro/tune/candidates.py``.  The tunable space
is the decoupled ``CommSpec x CompSpec x QuantSpec`` surface (paper §3.1):
tile order x channel count (f_C) x accum dtype on the comm half, the
(tm, tn, tk) consumer tile on the compute half, and the wire dtype.  Both
the measured ranker and the cost model iterate the tuple returned by
:func:`enumerate_candidates`; a cache entry's key hashes the same
:class:`Space`.

The comm half enumerates as the JAX package's does: nested loops over the
Space's ordered fields, each channel count clamped through
``mapping.effective_channels`` against the kind's chunked extent, each
(order, C) statically verified (``analysis.check_candidate`` and its seam /
a2a twins: the plan is built and proven, the fused kernels' flag protocol
included, so no budget is spent on a point the executor would refuse),
duplicates dropped.

The compute and wire halves enumerate only what the port's code on the
chosen :class:`Target` (backend, device, operand dtype) honours, so the
measured ranker never times two launches that are the same program:

  * ``backend="fused"``: the bf16 wgmma route of ``ag_gemm`` / ``gemm_rs``
    has a fixed 128 x 128 output tile, flash attention its own 64 x 64
    blocking, the grouped expert GEMM its own row tiles, and on the CPU the
    fused wrappers replay the wgmma route's items: all of these take the
    default tile only.  The float32 FMA route of the two GEMM kernels reads
    ``tile[1]`` alone, clamped and widened until its cooperative grid is
    resident (``comp_tiles.fma_n_tile``, which needs the card's SM count):
    its candidates are the distinct n tiles that rule gives, as
    ``(128, tn, 128)``.  A quantized (int8 / fp8) activation wire raises in
    the fused GEMM kernels, and the fused attention / MoE forms take the
    identity wire only, so those wires are not enumerated; ``gemm_rs``
    takes a float wire (float32 / bfloat16 recv slots), ``ag_gemm`` gathers
    ``x`` in its own dtype whatever the wire.  ``gemm_rs``'s bf16 route
    stores column pairs, so a C that leaves N / C odd is not enumerated.
  * ``backend="eager"``: ``_consume_dot`` blocks the GEMM by the whole
    tile, the eager ring attention by (tm, tk) as (block_q, block_kv) and
    the eager expert GEMMs by the whole tile.  Each lattice point is clamped
    to divisors of the extents (``resolve_tile``); a point that clamps to
    the whole problem is the default's single product and is dropped; a
    clamped dim must be the whole extent or a multiple of ``ALIGN``
    elements; on a CUDA device the tile's working set must also fit the
    shared memory a block may use (``backend/hw.HopperInfo``), the TPU's
    VMEM prune's counterpart.  On the CPU the lattice is enumerated for the
    CPU (the target names the device), with the alignment rule alone.
  * The accum axis.  An accum dtype narrower than the operands (bf16
    partials of a float32 GEMM) makes the travelling partials a lossy wire,
    so, like a quantized wire, it is offered only when the space opens the
    wire axis (``QUANT_SPACE``, ``quant="auto"``): a tuned float32 model
    keeps float32 numbers up to summation order.  An ``ag_matmul`` on
    16-bit operands rounds its output once whichever accum dtype it names
    (float32 -> bf16 and bf16 -> bf16 are the same rounding), so there the
    axis collapses to its first entry.  A one-dtype space is an explicit
    request and passes unchanged.  Without a target, the space's dtypes
    pass as in the JAX package.

``DEFAULT_SPACE`` sweeps the comm half; ``JOINT_SPACE`` adds the tile
lattice; ``QUANT_SPACE`` also opens the wire axis (``None`` first, so a
cost tie keeps the identity wire).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.analysis import check_a2a_candidate, check_candidate, check_seq_candidate
from repro_torch.core.channels import ORDERS, BlockChannel
from repro_torch.core.comp_tiles import DEFAULT_TILE, fma_n_tile, largest_divisor, resolve_tile
from repro_torch.core.mapping import effective_channels
from repro_torch.core.quant import WIRE_DTYPES

__all__ = [
    "Space",
    "Candidate",
    "Target",
    "DEFAULT_SPACE",
    "JOINT_SPACE",
    "QUANT_SPACE",
    "COMP_TILE_LATTICE",
    "QUANT_WIRE_KINDS",
    "GEMM_TILE_KINDS",
    "TUNABLE_KINDS",
    "SEQ_KIND",
    "A2A_SEQ_KIND",
    "MOE_SIG_KINDS",
    "ALIGN",
    "enumerate_candidates",
    "enumerate_seq_candidates",
    "enumerate_a2a_candidates",
    "comp_tile_candidates",
    "wire_candidates",
    "signature",
    "seq_sigs",
    "a2a_sigs",
    "chunk_extent",
]

TUNABLE_KINDS = ("ag_matmul", "matmul_rs", "ag_attention", "ag_moe")
SEQ_KIND = "seq_rs_ag"  # the RS -> AG layer seam (compile_overlap list form)
A2A_SEQ_KIND = "seq_a2a_moe"  # the expert-parallel dispatch -> combine pair
MOE_SIG_KINDS = ("ag_moe", A2A_SEQ_KIND)  # signatures that may carry (imbalance, capacity)
GEMM_TILE_KINDS = ("ag_matmul", "matmul_rs")
QUANT_WIRE_KINDS = ("ag_matmul", "matmul_rs", "ag_attention")

# the requested (tm, tn, tk) lattice, the default tile first so a cost tie keeps the default blocking
COMP_TILE_LATTICE = (DEFAULT_TILE,) + tuple(
    (tm, tn, tk)
    for tm in (64, 128, 256)
    for tn in (128, 256, 512)
    for tk in (128, 256, 512)
    if (tm, tn, tk) != DEFAULT_TILE
)

ALIGN = 8  # elements: a clamped tile dim is the whole extent or a multiple of this (16-byte bf16 rows)
_FLOAT_WIRES = ("float32", "bfloat16")  # the wires gemm_rs's recv slots take
_IN_BYTES = 2  # operand bytes per element in the working-set prune (bf16 activations)


@dataclasses.dataclass(frozen=True)
class Space:
    """The swept portion of the design space (ordered -> deterministic)."""

    orders: Tuple[str, ...] = ORDERS
    channel_counts: Tuple[int, ...] = (1, 2, 4)
    accum_dtypes: Tuple[str, ...] = ("float32", "bfloat16")
    comp_tiles: Tuple[Tuple[int, int, int], ...] = (DEFAULT_TILE,)
    flows: Tuple[Optional[str], ...] = (None,)  # wire dtypes; None inherits the channel's QuantSpec

    def __post_init__(self):
        for o in self.orders:
            if o not in ORDERS:
                raise ValueError(f"unknown order {o!r}; one of {ORDERS}")
        if any(c < 1 for c in self.channel_counts):
            raise ValueError(f"channel counts must be >= 1: {self.channel_counts}")
        for t in self.comp_tiles:
            if len(t) != 3 or any(int(d) < 1 for d in t):
                raise ValueError(f"comp tiles must be 3 positive ints, got {t}")
        for f in self.flows:
            if f is not None and f not in WIRE_DTYPES:
                raise ValueError(f"unknown flow dtype {f!r}; one of {WIRE_DTYPES}")

    def digest(self) -> str:
        blob = repr((self.orders, self.channel_counts, self.accum_dtypes, self.comp_tiles, self.flows))
        return hashlib.sha256(blob.encode()).hexdigest()[:8]


DEFAULT_SPACE = Space()
JOINT_SPACE = Space(comp_tiles=COMP_TILE_LATTICE)
QUANT_SPACE = Space(comp_tiles=COMP_TILE_LATTICE, flows=(None, "int8"))


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One design point; ``num_channels`` and ``comp_tile`` are the effective values."""

    order: str
    num_channels: int
    accum_dtype: str
    comp_tile: Tuple[int, int, int] = DEFAULT_TILE
    flow: Optional[str] = None  # tuned wire dtype; None keeps the base channel's QuantSpec

    def channel(self, axis: str, base: Optional[BlockChannel] = None) -> BlockChannel:
        """Realize as a BlockChannel, inheriting the non-tuned fields of ``base``."""
        base = base or BlockChannel(axis=axis)
        kw = {}
        if self.flow is not None:
            kw["quant"] = dataclasses.replace(base.quant, wire_dtype=self.flow)
        return base.with_(
            axis=axis,
            num_channels=self.num_channels,
            comm=dataclasses.replace(base.comm, order=self.order),
            comp=dataclasses.replace(base.comp, accum_dtype=self.accum_dtype, tile=tuple(self.comp_tile)),
            **kw,
        )

    def label(self) -> str:
        tag = f"{self.order}/C={self.num_channels}/{self.accum_dtype}"
        if tuple(self.comp_tile) != DEFAULT_TILE:
            tm, tn, tk = self.comp_tile
            tag += f"/tile={tm}x{tn}x{tk}"
        if self.flow is not None:
            tag += f"/wire={self.flow}"
        return tag


@dataclasses.dataclass(frozen=True)
class Target:
    """Where the candidates run: the backend, the device the world lives on
    and the operand dtype (which picks the fused GEMM kernels' route)."""

    backend: str
    device: torch.device
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        object.__setattr__(self, "device", torch.device(self.device))

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def gemm_route(self) -> str:
        """The fused GEMM kernels' route: "wgmma" / "fma" on the card, "plain"
        on the CPU (the wrappers replay the wgmma route's items there)."""
        if not self.cuda:
            return "plain"
        from repro_torch.kernels.build import ROUTES

        return ROUTES[self.dtype]

    def sm_count(self) -> int:
        return _hopper(self.device).sm_count

    def smem_bytes(self) -> int:
        return _hopper(self.device).smem_per_block_optin


@functools.lru_cache(maxsize=8)
def _hopper(device: torch.device):
    from repro_torch.backend.hw import probe

    return probe(device)


def _tile_dims(kind: str, sig: Sequence[int], world: Optional[int], nch: int) -> Optional[Tuple[int, int, int]]:
    """Per-step per-channel consumer extents (m, n, k) the tile blocks (the
    JAX package's rule): the GEMM kinds' step GEMM; ``ag_attention``
    queries x head dim x per-channel KV rows; the MoE kinds' expert rows x
    the gate|up width x d_model."""
    nch = max(1, nch)
    if kind == "ag_matmul":
        _, m_loc, k, n_loc = sig
        return max(1, m_loc // nch), n_loc, k
    if kind == "matmul_rs":
        _, m_glob, k_loc, n = sig
        m = max(1, m_glob // world) if world else m_glob
        return m, max(1, n // nch), k_loc
    if kind == "ag_attention":
        _b, _h, _hkv, s_loc, d = sig
        return s_loc, d, max(1, s_loc // nch)
    if kind in ("ag_moe", "a2a_dispatch"):
        m_loc, d_model, _top_k, _e_loc, d_exp = sig[:5]
        return max(1, m_loc // nch), 2 * d_exp, d_model
    return None


def _footprint(tile, acc_bytes: int) -> int:
    """Bytes of one tile's working set: the A and B blocks and the accumulator."""
    tm, tn, tk = tile
    return (tm * tk + tk * tn) * _IN_BYTES + tm * tn * acc_bytes


def _fma_tiles(kind, sig, world, nch, space, target) -> Tuple[Tuple[int, int, int], ...]:
    """The float32 route's distinct n tiles: ``fma_n_tile`` of every
    requested tn over the n extent the kernel tiles (``n_loc`` for AG+GEMM,
    ``N / C`` for GEMM+RS); the default tile first."""
    n = sig[3] if kind == "ag_matmul" else sig[3] // nch
    sms = target.sm_count()
    default = fma_n_tile(n, DEFAULT_TILE[1], nch * world, sms)
    out = [DEFAULT_TILE]
    seen = {default}
    for req in space.comp_tiles:
        tn = fma_n_tile(n, int(req[1]), nch * world, sms)
        if tn not in seen:
            seen.add(tn)
            out.append((DEFAULT_TILE[0], tn, DEFAULT_TILE[2]))
    return tuple(out)


def comp_tile_candidates(
    kind: str,
    sig: Optional[Sequence[int]],
    *,
    world: Optional[int] = None,
    nch: int = 1,
    accum_dtype: str = "float32",
    space: Space = DEFAULT_SPACE,
    target: Optional[Target] = None,
) -> Tuple[Tuple[int, int, int], ...]:
    """The (tm, tn, tk) points of one comm-half point that change what runs
    on ``target`` (module docstring), the default tile first.

    A single-tile space is an explicit request (``compile_overlap(...,
    comp=<tile>)``): its point is clamped and never pruned.  Without a
    target or a signature the space's tiles pass through unchanged."""
    if sig is None or target is None:
        return tuple(dict.fromkeys(tuple(int(d) for d in t) for t in space.comp_tiles))
    sig = tuple(int(s) for s in sig)
    dims = _tile_dims(kind, sig, world, nch)
    if dims is None:
        return (DEFAULT_TILE,)
    m, n, k = dims
    if len(space.comp_tiles) == 1:
        req = tuple(int(d) for d in space.comp_tiles[0])
        return (req if req == DEFAULT_TILE else resolve_tile(req, m, n, k),)
    if target.backend == "fused":
        if kind in GEMM_TILE_KINDS and target.gemm_route() == "fma":
            return _fma_tiles(kind, sig, world, nch, space, target)
        return (DEFAULT_TILE,)
    acc_bytes = _itemsize(accum_dtype)
    out, seen = [DEFAULT_TILE], {DEFAULT_TILE, (m, n, k)}  # the sentinel and the whole problem run as the default
    for req in space.comp_tiles:
        req = tuple(int(d) for d in req)
        if req == DEFAULT_TILE:
            continue
        if kind == "ag_attention":  # (block_q, ., block_kv): tn is not read
            tile = (largest_divisor(m, req[0]), n, largest_divisor(k, req[2]))
        else:
            tile = resolve_tile(req, m, n, k)
        if tile in seen or any(t != e and t % ALIGN for t, e in zip(tile, (m, n, k))):
            continue
        if target.cuda and _footprint(tile, acc_bytes) > target.smem_bytes():
            continue
        seen.add(tile)
        out.append(tile)
    return tuple(out)


def wire_candidates(kind: str, space: Space, target: Optional[Target] = None) -> Tuple[Optional[str], ...]:
    """The wire dtypes of ``space.flows`` that ``target`` runs (module docstring)."""
    if kind not in QUANT_WIRE_KINDS:
        return (None,)
    if target is None or target.backend == "eager":
        return tuple(space.flows)
    if kind == "matmul_rs":
        return tuple(f for f in space.flows if f is None or f in _FLOAT_WIRES)
    return (None,)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=getattr(torch, dtype) if isinstance(dtype, str) else dtype).element_size()


def _accum_candidates(kind: str, space: Space, target: Optional[Target]) -> Tuple[str, ...]:
    """The accum dtypes that change what runs on ``target`` without narrowing
    its numbers unasked (module docstring); a one-dtype space is an explicit
    request and passes."""
    accums = tuple(space.accum_dtypes)
    if target is None or len(accums) == 1:
        return accums
    if not any(f is not None for f in space.flows):  # the wire axis is closed: no lossy partials either
        accums = tuple(a for a in accums if _itemsize(a) >= _itemsize(target.dtype)) or accums[:1]
    if kind == "ag_matmul" and _itemsize(target.dtype) == 2:
        return accums[:1]
    return accums


def _legal(kinds: Tuple[str, ...], order: str, world: int, nch: int) -> bool:
    """Whether ``order`` over ``world`` ranks at ``nch`` channels builds a
    verified plan (one kind) or a verified chained plan (two kinds): the
    analysis package's cached probes, None when legal."""
    if len(kinds) == 1:
        return check_candidate(kinds[0], order, world, nch) is None
    probe = check_a2a_candidate if kinds == ("a2a_dispatch", "combine_rs") else check_seq_candidate
    return probe(order, world, nch) is None


def _route_refuses(kind: str, sig, nch: int, target: Optional[Target]) -> bool:
    """A (kind, C) the fused kernel of ``target``'s dtype would refuse:
    ``gemm_rs``'s bf16 route stores column pairs, so N / C must be even."""
    return (
        target is not None
        and target.backend == "fused"
        and kind == "matmul_rs"
        and target.dtype == torch.bfloat16
        and sig is not None
        and (int(sig[3]) // nch) % 2 == 1
    )


def enumerate_candidates(
    kind: str,
    *,
    extent: Optional[int] = None,
    space: Space = DEFAULT_SPACE,
    sig: Optional[Sequence[int]] = None,
    world: Optional[int] = None,
    target: Optional[Target] = None,
) -> Tuple[Candidate, ...]:
    """Deterministic feasible design points for ``kind``.

    ``extent`` is the chunked extent ``num_channels`` must divide
    (:func:`chunk_extent`); with ``world`` each (order, C) must build a
    plan; with ``sig`` and ``target`` the tile and wire axes enumerate what
    the target honours (module docstring)."""
    if kind not in TUNABLE_KINDS:
        raise ValueError(f"kind {kind!r} is not tunable; one of {TUNABLE_KINDS}")
    flows = wire_candidates(kind, space, target)
    out, seen = [], set()
    for order in space.orders:
        for req in space.channel_counts:
            nch = effective_channels(extent, req, kind=kind, warn=False) if extent is not None else req
            if world is not None and not _legal((kind,), order, world, nch):
                continue
            if _route_refuses(kind, sig, nch, target):
                continue
            for accum in _accum_candidates(kind, space, target):
                tiles = comp_tile_candidates(
                    kind, sig, world=world, nch=nch, accum_dtype=accum, space=space, target=target
                )
                for tile in tiles:
                    for flow in flows:
                        cand = Candidate(order=order, num_channels=nch, accum_dtype=accum, comp_tile=tile, flow=flow)
                        if cand not in seen:
                            seen.add(cand)
                            out.append(cand)
    return tuple(out)


def _moe_axes(imbalance, capacity) -> Tuple[int, ...]:
    """The optional MoE workload axes: imbalance in quarter units, capacity
    rounded up to 8 rows (the JAX package's quantization)."""
    if imbalance is None and capacity is None:
        return ()
    axes = (max(4, int(round(4.0 * float(1.0 if imbalance is None else imbalance)))),)
    if capacity is not None:
        axes += (max(8, -(-int(capacity) // 8) * 8),)
    return axes


def signature(kind: str, shapes: Sequence[Tuple[int, ...]], decode: bool = False, *, imbalance=None, capacity=None):
    """Canonical shape signature from *per-rank* operand shapes (a
    rank-stacked operand without its leading W), as the JAX package's ops
    see them inside ``shard_map``; leading batch dims collapse into one.

    ``decode=True`` marks a GEMM-kind decode shape: the lead is negated, so
    decode shapes key their own cache entries.  The MoE kinds may append
    the quantized (imbalance, capacity) axes."""
    if decode and kind not in GEMM_TILE_KINDS:
        raise ValueError(f"decode signatures are defined for the GEMM kinds {GEMM_TILE_KINDS}, not {kind!r}")
    if (imbalance is not None or capacity is not None) and kind not in MOE_SIG_KINDS:
        raise ValueError(
            f"imbalance/capacity signature axes are defined for the MoE kinds {MOE_SIG_KINDS}, not {kind!r}"
        )

    def _lead(x):
        lead = math.prod(x[:-2]) if len(x) > 2 else 1
        return -lead if decode else lead

    if kind == SEQ_KIND:
        x, w1, w2 = shapes[0], shapes[1], shapes[2]
        return (_lead(x), x[-2], x[-1], w1[-1], w2[-1])  # (lead, m_glob, k_loc, n_mid, n2_loc)
    if kind in GEMM_TILE_KINDS:
        x, w = shapes[0], shapes[1]
        return (_lead(x), x[-2], x[-1], w[-1])  # ag (lead, m_loc, k, n_loc); rs (lead, m_glob, k_loc, n)
    if kind == "ag_attention":
        q, k = shapes[0], shapes[1]
        return (q[0], q[1], k[1], k[2], q[3])  # (b, h, hkv, s_loc, d); s_loc from K
    if kind in MOE_SIG_KINDS:
        x, ids, w_gu = shapes[0], shapes[1], shapes[3]
        return (x[-2], x[-1], ids[-1], w_gu[0], w_gu[-1] // 2) + _moe_axes(imbalance, capacity)
    raise ValueError(f"kind {kind!r} is not tunable; one of {TUNABLE_KINDS}")


def seq_sigs(sig: Tuple[int, ...], world: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """A seam signature split into its RS half's and its AG half's."""
    lead, m_glob, k_loc, n_mid, n2_loc = sig
    return (lead, m_glob, k_loc, n_mid), (lead, m_glob // world, n_mid, n2_loc)


def enumerate_seq_candidates(*, sig: Sequence[int], world: int, space: Space = DEFAULT_SPACE, target=None):
    """Shared-channel design points of an RS -> AG seam: only requests that
    clamp to the same C on both extents, whose chained plan builds; tiles
    on the RS half's GEMM; the wire axis as both halves'."""
    sig = tuple(int(s) for s in sig)
    _lead, m_glob, _k_loc, n_mid, _n2_loc = sig
    if world < 1 or m_glob % world:
        return ()
    m_loc = m_glob // world
    sig_rs, _ = seq_sigs(sig, world)
    flows = wire_candidates("matmul_rs", space, target)
    out, seen = [], set()
    for order in space.orders:
        for req in space.channel_counts:
            nch = effective_channels(n_mid, req, kind="matmul_rs", warn=False)
            if nch != effective_channels(m_loc, req, kind="ag_matmul", warn=False):
                continue
            if not _legal(("matmul_rs", "ag_matmul"), order, world, nch):
                continue
            for accum in _accum_candidates("matmul_rs", space, target):
                tiles = comp_tile_candidates(
                    "matmul_rs", sig_rs, world=world, nch=nch, accum_dtype=accum, space=space, target=target
                )
                for tile in tiles:
                    for flow in flows:
                        cand = Candidate(order=order, num_channels=nch, accum_dtype=accum, comp_tile=tile, flow=flow)
                        if cand not in seen:
                            seen.add(cand)
                            out.append(cand)
    return tuple(out)


def a2a_sigs(sig: Tuple[int, ...], world: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Both halves of the MoE exchange chunk the same tokens: the full signature each."""
    sig = tuple(sig)
    return sig, sig


def enumerate_a2a_candidates(*, sig: Sequence[int], world: int, space: Space = DEFAULT_SPACE, target=None):
    """Shared-channel design points of the dispatch -> combine pair (both
    halves chunk the same m_loc tokens), whose chained plan builds; tiles
    on the dispatch half's expert GEMM; the identity wire (MoE kinds)."""
    sig = tuple(int(s) for s in sig)
    if world < 1:
        return ()
    out, seen = [], set()
    for order in space.orders:
        for req in space.channel_counts:
            nch = effective_channels(sig[0], req, kind="a2a_dispatch", warn=False)
            if not _legal(("a2a_dispatch", "combine_rs"), order, world, nch):
                continue
            for accum in _accum_candidates("ag_moe", space, target):
                tiles = comp_tile_candidates(
                    "a2a_dispatch", sig, world=world, nch=nch, accum_dtype=accum, space=space, target=target
                )
                for tile in tiles:
                    cand = Candidate(order=order, num_channels=nch, accum_dtype=accum, comp_tile=tile)
                    if cand not in seen:
                        seen.add(cand)
                        out.append(cand)
    return tuple(out)


def chunk_extent(kind: str, sig: Tuple[int, ...]) -> int:
    """The extent ``num_channels`` chunks for ``kind`` (what C must divide)."""
    if kind == "ag_matmul":
        return sig[1]  # m_loc rows of the local shard
    if kind == "matmul_rs":
        return sig[3]  # n columns of the partial
    if kind == "ag_attention":
        return sig[3]  # s_loc KV rows of the local shard
    if kind in ("ag_moe", "a2a_dispatch", "combine_rs"):
        return sig[0]  # m_loc token rows of the local chunk
    raise ValueError(f"kind {kind!r} is not tunable; one of {TUNABLE_KINDS}")
