"""Fused AllGather + GEMM kernel (``csrc/ag_gemm.cu``), plan-driven.

Replaces ``repro/kernels/ag_gemm.py::ag_gemm_shard`` (``_ag_gemm_kernel``).
The held ranks run in one cooperative launch (every rank when one process
emulates the world; a world over processes launches one grid per card and
the kernels push into the peer cards' receive regions: ``kernels/peer``,
``csrc/tile_sync.cuh``); the plan's ``src_tables()`` /
``flow_dst_tables()`` are device int32 tables.  Two routes, chosen by
dtype before the launch (never by a fallback):

  * bfloat16 (the serve dtype): ``ag_gemm_wgmma_kernel``, a persistent grid
    of 128 x 128 output tiles (:func:`work_items`, stage-major) over all
    SMs, each through the TMA -> shared-memory ring -> ``wgmma`` body of
    ``csrc/wgmma_tile.cuh``; one ready flag per (rank, step, channel,
    m-tile).  Its tile is fixed (``TILE``): ``bn`` and the CompSpec tile do
    not apply.  K and n_loc must be multiples of 8 (16-byte TMA strides).
  * float32: ``ag_gemm_kernel``, the ``csrc/tile_gemm.cuh`` FMA loop on a
    grid (n-tile, channel, rank) with flags per (rank, step, channel); the
    n tile is ``bn`` / the CompSpec tn, widened where the grid would not be
    resident (:func:`~repro_torch.core.comp_tiles.fma_n_tile`).  Products stay exact float32 (on
    tensor cores they would be TF32).

Both routes count in ``ag_gemm.launches`` (``ag_gemm.packed_launches`` the
launches that took a PackedWeight); ``ag_gemm.last_launch`` says
which route the last launch took, its grid and its item count.  The
protocol, the bound and the design are noted in ``csrc/ag_gemm.cu``.

:func:`ag_gemm_plain` is the plain PyTorch version: it replays the bf16
route's work items in order, with the same tables, the same gather slots,
the same seed copy, the same per-m-tile pushes and the same flag keys,
through the host form of the tile primitives (``core/primitives``: a wait
on a flag no earlier item set raises).

``w`` may be a :class:`~repro_torch.core.quant.PackedWeight` (weight-only
int8 / int4 codes ``[W, K, n_loc]``, per-column scale and zero point
``[W, n_loc]``), dequantized inside the kernel on both routes, as the
reference's kernel dequantizes in VMEM: the float32 route forms ``(q - zero)
* scale`` as it stages each weight block; the bf16 route loads the codes by
TMA, converts ``q - zero`` to bf16 in shared memory and multiplies the
float32 sum by the scale in its epilogue (n_loc a multiple of 16, else
ValueError).  The plain version replays each route's formula
(:func:`plain_weight`).  A quantized activation wire
(``channel.quant.wire_dtype`` int8 / fp8) raises ``NotImplementedError``, as
the reference's kernel does; any wire leaves ``x`` gathered in its own
dtype, as the reference's gather scratch holds it.

Each rank's gather slots, ready flags and entry words are its receive
region of a pool (``kernels/peer``): made for the call on one card, kept
for the process and counted in epochs instead of zeroed on the peer route
(``csrc/tile_sync.cuh``); ``ag_gemm.last_launch`` names the pool's form.

``return_gathered=True`` (both versions, every route) also returns each
held rank's gathered operand, ``[held, *lead, W*m_loc, K]`` in rank-major
row order, read from the gather slots the launch filled (the float32 route
reads a rank's own rows in place, so those come from x): the backward of
AG+GEMM takes its weight gradient from it without a second all-gather.
The one-allocation route's slots are made for the call, so it is a view of
them.  A pool's slots are kept for the process, and the next launch of the
shape overwrites them (from this card and from the peers), so on the peer
route the held ranks' slots are copied out after the launch, on its stream
(``kernels/peer.Pool.copy_slots``, one device copy of ``held x W x m_loc x
K`` elements): a peer pushes into them again only after this card's next
launch of the shape has set its entry word, which is stream-ordered after
the copy.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.channels import BlockChannel
from repro_torch.backend.hw import probe
from repro_torch.core.comp_tiles import fma_n_tile
from repro_torch.core.mapping import effective_channels
from repro_torch.core.plan import TilePlan, build_plan
from repro_torch.core.primitives import (
    FlagBoard,
    consumer_tile_wait,
    peer_tile_notify,
    peer_tile_wait,
    producer_tile_notify,
    tile_push_data,
)
from repro_torch.core.quant import PackedWeight
from repro_torch.kernels import build, peer

__all__ = [
    "ag_gemm", "ag_gemm_plain", "work_items", "launch_items", "launch_plan", "AgItem", "TILE", "ROUTES", "device_table",
    "plain_weight", "refuse_quantized_wire", "entry_keys",
]  # fmt: skip

TILE = build.WGMMA_TILE  # the bf16 route's output tile (BM, BN)
ROUTES = build.ROUTES


@functools.lru_cache(maxsize=256)
def device_table(plan: TilePlan, which: str, device: torch.device) -> torch.Tensor:
    """A plan table (``src`` / ``flow_dst`` / ``rs_seg`` / ``rs_dst``) as a flat
    int32 tensor on ``device``, indexed ``(c * W + s) * W + r``; cached per plan."""
    table = getattr(plan, f"{which}_tables")()
    return torch.tensor(table, dtype=torch.int32).reshape(-1).to(device)


class AgItem(NamedTuple):
    """One work item of the bf16 route: output tile (m-tile ``mt``, n-tile
    ``nt``) of rank ``r`` at step ``s``, channel ``c``.  Flags are
    ``("ready", rank, step, c, mt)`` in ``rank``'s region; slot tiles
    ``(rank, origin, c, mt)``; a pushing item first waits on ``entry``,
    ``("entry", r, dst)``: its own region's copy of the receiver's entry
    word (the launch prologue, :func:`entry_keys`, sets them).  With an
    ``epoch`` every key ends with it."""

    index: int
    s: int
    r: int
    c: int
    mt: int
    nt: int
    origin: int  # origin rank of the held slot (src table)
    dst: int  # rank the held slot is pushed to (flow_dst table)
    copy: Optional[str]  # "seed" (from x) | "push" (from the held slot) | None
    wait: Optional[tuple]  # flag waited on before the copy / GEMM (None: the seed item fills it itself)
    sets: Tuple[tuple, ...]  # flags set after the copy
    reads: Tuple[tuple, ...]  # slot tiles read (copy source, GEMM operand)
    writes: Tuple[tuple, ...]  # slot tiles written by the copy
    entry: Optional[tuple] = None  # the receiver's entry word waited on before the push (None: no push)


def entry_keys(world: int, ranks, epoch: Optional[int] = None) -> Tuple[tuple, ...]:
    """The flags a launch of ``ranks`` sets before any item (both fused
    kernels): each held rank's entry word on every rank's region,
    ``("entry", q, r)`` (``+ (epoch,)``)."""
    tail = () if epoch is None else (epoch,)
    return tuple(("entry", q, r) + tail for r in ranks for q in range(world))


def work_items(plan: TilePlan, shape, tile=TILE, *, ranks=None, epoch: Optional[int] = None) -> list:
    """The bf16 route's work items, stage-major: numbered by (s, r, c, nt, mt)
    with mt fastest, as ``ag_gemm_wgmma_kernel`` decodes its item index
    (``wg_item``): the blocks that run together share a weight strip.

    ``shape`` is ``(B, m_loc, K, n_loc)`` (B the flattened batch dims).
    ``ranks``: the held ranks a launch runs (default every rank; numbered
    over them, the restriction of the global order); ``epoch``: the call's
    epoch, appended to every flag, entry and slot key (the peer route's
    pools are never zeroed: a key names its call)."""
    b, m_loc, _, n_loc = shape
    world, nch = plan.world, plan.num_channels
    bm, bn = tile
    m_tiles = -(-b * (m_loc // nch) // bm)
    n_tiles = -(-n_loc // bn)
    src_t, dst_t = plan.src_tables(), plan.flow_dst_tables()
    held = range(world) if ranks is None else sorted(ranks)
    e = () if epoch is None else (epoch,)
    items = []
    for s in range(world):
        for r in held:
            for c in range(nch):
                o, d = src_t[c][s][r], dst_t[c][s][r]
                push = s < world - 1
                for nt in range(n_tiles):
                    for mt in range(m_tiles):
                        ready = ("ready", r, s, c, mt) + e
                        copy, wait, sets, writes, entry = None, ready, (), (), None
                        if nt == 0 and s == 0:  # seed: own sub-chunk -> own slot (+ the peer's)
                            copy, wait = "seed", None
                            sets = (ready,) + ((("ready", d, 1, c, mt) + e,) if push else ())
                            writes = ((r, r, c, mt) + e,) + (((d, r, c, mt) + e,) if push else ())
                        elif nt == 0 and push:  # push: held slot -> the peer's slot
                            copy, sets, writes = "push", (("ready", d, s + 1, c, mt) + e,), ((d, o, c, mt) + e,)
                        if copy is not None and push:
                            entry = ("entry", r, d) + e
                        held_tile = ((r, o, c, mt) + e,)
                        items.append(AgItem(len(items), s, r, c, mt, nt, o, d, copy, wait, sets, held_tile, writes,
                                            entry))  # fmt: skip
    return items


def plain_weight(w, dtype: torch.dtype):
    """The weight operand as the route of ``dtype`` (``build.ROUTES``) forms
    it, in float32, and the per-column scale its epilogue applies (or None):
    a plain weight as it is; a :class:`~repro_torch.core.quant.PackedWeight`
    as ``(q - zero) * scale`` on the float32 route (the reference's
    formula), or as ``q - zero`` rounded to bf16, with ``scale`` [W, n] left
    for the epilogue, on the bf16 route."""
    if not isinstance(w, PackedWeight):
        return w.float(), None
    qz = w.q.float() if w.zero is None else w.q.float() - w.zero.unsqueeze(-2)
    if ROUTES.get(dtype) == "wgmma":
        return qz.to(torch.bfloat16).float(), w.scale
    return qz * w.scale.unsqueeze(-2), None


def refuse_quantized_wire(what: str, channel):
    """Raise for an int8 / fp8 activation wire: the fused kernels carry no
    scale side channel (the reference's Pallas kernels raise too)."""
    if channel is not None and channel.quant.is_quantized:
        raise NotImplementedError(
            f"{what}: quantized activation wires (QuantSpec.wire_dtype={channel.quant.wire_dtype!r}) are not "
            "supported by the fused kernel; use the eager executor (weight-only quantization via PackedWeight IS "
            "supported here)"
        )


def _check(x: torch.Tensor, w):
    if x.dim() < 3 or len(w.shape) != 3 or x.shape[0] != w.shape[0] or x.shape[-1] != w.shape[1]:
        raise ValueError(
            f"ag_gemm: expected x [W, ..., m_loc, K] and w [W, K, n_loc], got {tuple(x.shape)}, {tuple(w.shape)}"
        )


def launch_plan(x, w, channel=None, world: Optional[int] = None):
    """The plan the launch on these operands runs, and its channel
    (``world``: the TP degree, default ``x``'s rank dimension)."""
    world, m_loc = world or x.shape[0], x.shape[-2]
    channel = channel or BlockChannel(axis="model")
    nch = effective_channels(m_loc, channel.num_channels, kind="ag_matmul")
    return build_plan("ag_matmul", channel, world, nch), channel


def launch_items(x: torch.Tensor, w: torch.Tensor, channel: Optional[BlockChannel] = None) -> list:
    """The work items the bf16 route runs for these operands."""
    _check(x, w)
    plan, _ = launch_plan(x, w, channel)
    return work_items(plan, (math.prod(x.shape[1:-2]), x.shape[-2], x.shape[-1], w.shape[-1]))


def _gathered(gbuf: torch.Tensor, world: int, nch: int, lead, m_sub: int) -> torch.Tensor:
    """The gather slots [held, W*C, B*m_sub, K] (slot ``origin*C + c``, row
    ``b*m_sub + j``) as each held rank's gathered rows [held, *lead,
    W*m_loc, K] (row ``origin*m_loc + c*m_sub + j``)."""
    held, k = gbuf.shape[0], gbuf.shape[-1]
    b = math.prod(lead)
    g = gbuf.view(held, world, nch, b, m_sub, k).permute(0, 3, 1, 2, 4, 5)
    return g.reshape((held,) + tuple(lead) + (world * nch * m_sub, k))


@functools.lru_cache(maxsize=512)
def layout(plan: TilePlan, route: str, b: int, m_sub: int, k: int, dtype: torch.dtype) -> peer.Layout:
    """A rank's receive region (``kernels/peer.Layout``): gather slots [W*C,
    B*m_sub, K] and one ready flag per (step, channel[, m-tile]); cached per shape."""
    world, nch = plan.world, plan.num_channels
    per = -(-b * m_sub // TILE[0]) if route == "wgmma" else 1
    return peer.Layout((world * nch, b * m_sub, k), dtype, world * nch * per, world)


def ag_gemm_plain(
    x: torch.Tensor, w, *, channel: Optional[BlockChannel] = None, return_gathered: bool = False, split: bool = False
):
    """Plain version: the bf16 route's work items replayed in order in
    PyTorch, with the weight formed as ``x``'s route forms it (:func:`plain_weight`).

    ``split``: replay the peer route instead, on this process's CPU pool
    (``kernels/peer``): each rank's gather slots a separate tensor, its flags
    and entry words on its own board, the pool's epoch carried from call to
    call (never zeroed): the launch prologue sets every entry word
    (:func:`entry_keys`), a pusher waits on its copy of the receiver's, and
    every flag holds the epoch, as the kernels do; ``return_gathered`` then
    copies the pool's slots out, as the kernel's wrapper does."""
    _check(x, w)
    refuse_quantized_wire("ag_gemm", channel)
    plan, _ = launch_plan(x, w, channel)
    wf, col_scale = plain_weight(w, x.dtype)
    world, nch = plan.world, plan.num_channels
    lead, (m_loc, k), n_loc = x.shape[1:-2], x.shape[-2:], w.shape[-1]
    b = math.prod(lead)
    m_sub = m_loc // nch
    rows = b * m_sub
    bm, bn = TILE
    xs = x.reshape(world, b, m_loc, k)
    out = torch.zeros((world, b, world * m_loc, n_loc), dtype=x.dtype, device=x.device)
    if split:
        pl = peer.pool("ag_gemm", layout(plan, "wgmma", b, m_sub, k, x.dtype), x.device, split=True)
        pl.epoch += 1
        epoch, slots, boards = pl.epoch, pl.slots, pl.boards
        for key in entry_keys(world, range(world)):  # the launch prologue
            producer_tile_notify(boards[key[1]], key, epoch)
    else:
        gbuf = torch.zeros((world, world * nch, rows, k), dtype=x.dtype, device=x.device)
        epoch, slots, boards = 1, gbuf, [FlagBoard()] * world
    for it in work_items(plan, (b, m_loc, k, n_loc)):
        r, o, c = it.r, it.origin, it.c
        if it.wait is not None:  # the order sets every flag before its wait, else this raises
            (consumer_tile_wait if it.s == 0 else peer_tile_wait)(boards[r], it.wait, epoch)
        sl = slice(it.mt * bm, min(rows, (it.mt + 1) * bm))
        if it.copy == "seed":
            tile = xs[r, :, c * m_sub : (c + 1) * m_sub].reshape(rows, k)[sl]
        elif it.copy == "push":
            tile = slots[r][o * nch + c, sl]
        for n, (rank, origin, ch, _) in enumerate(it.writes):  # into the peer's (and, seeding, the own) gather slot
            if split and rank != r:  # the receiver's call before has read its slots
                peer_tile_wait(boards[r], it.entry, epoch)
            tile_push_data(slots[rank], (origin * nch + ch, sl), tile)
        for key in it.sets:  # the own slot's flag (seeding), the peer's
            (producer_tile_notify if key[1] == r else peer_tile_notify)(boards[key[1]], key, epoch)
        cols = slice(it.nt * bn, min(n_loc, (it.nt + 1) * bn))
        part = slots[r][o * nch + c, sl].float() @ wf[r, :, cols]
        if col_scale is not None:
            part = part * col_scale[r, cols]
        part = part.to(plan.accum_dtype).to(x.dtype)
        i = torch.arange(sl.start, sl.stop, device=x.device)
        out[r, i // m_sub, o * m_loc + c * m_sub + i % m_sub, cols] = part
    out = out.reshape((world,) + tuple(lead) + (world * m_loc, n_loc))
    if not return_gathered:
        return out
    return out, _gathered(torch.stack(slots) if split else gbuf, world, nch, lead, m_sub)


def ag_gemm(
    x: torch.Tensor,
    w,
    *,
    channel: Optional[BlockChannel] = None,
    bn: Optional[int] = None,
    return_gathered: bool = False,
    world=None,
    split: bool = False,
):
    """Fused AG+GEMM over the rank dimension.

    ``x``: [W, *lead, m_loc, K], ``w``: [W, K, n_loc] -> [W, *lead, W*m_loc, n_loc]:
    every rank's all-gathered rows times its own weight shard, rows gathered
    along dim -2 with the leading (batch) dims kept.  The schedule (order,
    channels) and the accum dtype come from ``channel``.  A CPU tensor runs
    :func:`ag_gemm_plain`; a CUDA tensor launches the kernel of its dtype's
    route (``build.ROUTES``) or raises: bfloat16 takes the wgmma route (tile
    ``TILE``; K and n_loc multiples of 8, else ValueError), float32 the FMA
    route with n tile ``bn`` (default the CompSpec tn, clamped to a divisor
    of n_loc and widened by
    :func:`~repro_torch.core.comp_tiles.fma_n_tile`).  ``return_gathered``: also return the gathered operand (module
    docstring).  ``w`` may be a :class:`~repro_torch.core.quant.PackedWeight`
    (module docstring); a quantized activation wire raises.

    The receive region of each rank comes from ``kernels/peer``'s pools:
    ``world`` a :class:`~repro_torch.backend.mesh.World` over processes
    (``x`` / ``w`` then hold its ``held`` ranks, and the kernel pushes into
    the peer cards' regions: the peer route), ``split`` every rank in its
    own allocation on this card (the peer route on one card; on the CPU,
    its plain replay), else one allocation.  ``return_gathered`` on a pool
    copies the held ranks' slots out after the launch (module docstring).
    """
    _check(x, w)
    refuse_quantized_wire("ag_gemm", channel)
    procs = world is not None and world.nprocs > 1
    if x.device.type == "cpu" and w.device.type == "cpu":
        if procs:
            raise ValueError("ag_gemm: the peer route over processes runs on the card (on the CPU the eager "
                             "executor stands in for it)")  # fmt: skip
        return ag_gemm_plain(x, w, channel=channel, return_gathered=return_gathered, split=split)
    if procs and x.shape[0] != world.held:
        raise ValueError(f"ag_gemm: expected the {world.held} held ranks of {world}, got {tuple(x.shape)}")
    plan, channel = launch_plan(x, w, channel, world.size if procs else None)
    w_ptr, s_ptr, z_ptr, _keep = build.weight_operands("ag_gemm", x, w)
    if plan.accum_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ag_gemm kernel accumulates in float32 or bfloat16, not {plan.accum_dtype}")
    world_size, nch = plan.world, plan.num_channels
    held = x.shape[0]
    lead, (m_loc, k), n_loc = x.shape[1:-2], x.shape[-2:], w.shape[-1]
    b = math.prod(lead)
    m_sub = m_loc // nch
    route = ROUTES[x.dtype]
    reg = peer.regions("ag_gemm", layout(plan, route, b, m_sub, k, x.dtype), x.device, world=world, split=split)
    out = torch.empty((held, b, world_size * m_loc, n_loc), dtype=x.dtype, device=x.device)
    src = device_table(plan, "src", x.device)
    dst = device_table(plan, "flow_dst", x.device)
    lib = build.library()
    if route == "wgmma":
        info = (ctypes.c_int * 2)()
        rc = lib.tl_ag_gemm_wgmma(
            x.data_ptr(), w_ptr, s_ptr, z_ptr, out.data_ptr(), reg.address, src.data_ptr(), dst.data_ptr(),
            ctypes.addressof(info), world_size, nch, b, m_loc, m_sub, k, n_loc, build.stream(x),
        )  # fmt: skip
        build.check(rc, "ag_gemm")
        ag_gemm.last_launch = {"route": route, "grid": info[0], "items": info[1], "tile": TILE, "packed": bool(s_ptr),
                               "pool": reg.mode}  # fmt: skip
    else:
        bn = fma_n_tile(n_loc, bn or channel.comp.tile[1], nch * held, probe(x.device).sm_count)
        n_tiles = n_loc // bn
        rc = lib.tl_ag_gemm(
            int(plan.accum_dtype == torch.bfloat16),
            x.data_ptr(), w_ptr, s_ptr, z_ptr, out.data_ptr(), reg.address, src.data_ptr(), dst.data_ptr(),
            world_size, nch, n_tiles, b, m_loc, m_sub, k, n_loc, bn, build.stream(x),
        )  # fmt: skip
        build.check(rc, "ag_gemm")
        ag_gemm.last_launch = {
            "route": route, "grid": n_tiles * nch * held, "items": None, "tile": (64, bn), "packed": bool(s_ptr),
            "pool": reg.mode,
        }  # fmt: skip
    ag_gemm.launches += 1
    ag_gemm.packed_launches += bool(s_ptr)
    out = out.reshape((held,) + tuple(lead) + (world_size * m_loc, n_loc))
    if not return_gathered:
        return out
    if reg.mode == "one":
        gbuf = reg.slots  # made for this call: no later launch writes them, so a view may be kept
    else:  # the pool's slots are overwritten by the next launch of this shape: copied out on the launch's stream
        gbuf = torch.empty((held,) + reg.keep.layout.slot_shape, dtype=x.dtype, device=x.device)
        reg.keep.copy_slots(gbuf, build.stream(x))
    gathered = _gathered(gbuf, world_size, nch, lead, m_sub)
    if route != "wgmma":  # the float32 route reads a rank's own rows in place from x, not from its slot
        for i, r in enumerate(range(held) if not procs else world.ranks):
            gathered[i, ..., r * m_loc : (r + 1) * m_loc, :] = x[i]
    return out, gathered


ag_gemm.launches = 0
ag_gemm.packed_launches = 0  # the launches that took a PackedWeight
ag_gemm.last_launch = None

