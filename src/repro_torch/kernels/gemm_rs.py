"""Fused GEMM + ReduceScatter kernel (``csrc/gemm_rs.cu``), plan-driven.

Replaces ``repro/kernels/gemm_rs.py::gemm_rs_shard`` (``_gemm_rs_kernel``).
The held ranks run in one cooperative launch (every rank when one process
emulates the world; a world over processes launches one grid per card and
the kernels push partials into the peer cards' receive regions:
``kernels/peer``, ``csrc/tile_sync.cuh``); the plan's ``rs_seg_tables()`` /
``rs_dst_tables()`` are device int32 tables.  Two
routes, chosen by dtype before the launch (never by a fallback):

  * bfloat16 (the serve dtype): ``gemm_rs_wgmma_kernel``, a persistent grid
    of output tiles (:func:`work_items`, stage-major) over all SMs, each
    through the TMA -> shared-memory ring -> ``wgmma`` body of
    ``csrc/wgmma_tile.cuh``.  An m-tile is 2 batch rows x 64 rows of the
    segment (one per consumer warpgroup), an n-tile 128 columns of the
    channel (starting ``lead`` columns early where the channel's first
    column is not 16-byte aligned); flags per (rank, stage, channel, m-tile, n-tile).  Its tile is
    fixed: ``bn`` and the CompSpec tile do not apply.  k_loc and N must be
    multiples of 8 (16-byte TMA strides).
  * float32: ``gemm_rs_kernel``, the ``csrc/tile_gemm.cuh`` FMA loop on a
    grid (n-tile, channel, rank) with flags per (rank, stage, channel,
    n-tile); the n tile is ``bn`` / the CompSpec tn.  Products stay exact
    float32 (on tensor cores they would be TF32).

Both routes count in ``gemm_rs.launches`` (``gemm_rs.packed_launches`` the
launches that took a PackedWeight); ``gemm_rs.last_launch`` says
which route the last launch took, its grid and its item count.  The
protocol, the bound and the design are noted in ``csrc/gemm_rs.cu``.

The recv slots hold partials in the plan's wire dtype (``plan.flow_dtype``:
``QuantSpec.wire_dtype``, the accumulation dtype by default): each partial
is summed in float32, cast to the wire at the send edge and added back in
float32, the reference's ``split`` path (e.g. a bf16 wire under float32
accumulation, half the partial traffic).  A quantized wire (int8 / fp8)
raises ``NotImplementedError``, as the reference's kernel does.  ``w`` may be
a :class:`~repro_torch.core.quant.PackedWeight` (int8 / int4 codes ``[W,
k_loc, N]``, scale and zero point ``[W, N]``), dequantized inside the
kernel as in ``kernels/ag_gemm.py``; on the bf16 route a channel's boxes
then start at multiples of 16 columns and N must be a multiple of 16.

:func:`gemm_rs_plain` is the plain PyTorch version: it replays the bf16
route's work items in order, with the same tables, the same recv slots and
the same flag keys, through the host form of the tile primitives
(``core/primitives``: a wait on a flag no earlier item set raises).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.backend.hw import probe
from repro_torch.core.channels import BlockChannel
from repro_torch.core.comp_tiles import fma_n_tile
from repro_torch.core.mapping import effective_channels
from repro_torch.core.plan import TilePlan, build_plan
from repro_torch.core.primitives import FlagBoard, peer_tile_notify, peer_tile_wait, tile_push_data
from repro_torch.core.quant import PackedWeight, as_dtype, dtype_name
from repro_torch.kernels import build, peer
from repro_torch.kernels.ag_gemm import device_table, entry_keys, plain_weight, refuse_quantized_wire

__all__ = ["gemm_rs", "gemm_rs_plain", "work_items", "launch_items", "launch_plan", "tiles", "RsItem", "TILE"]

TILE = build.WGMMA_TILE  # the bf16 route's output tile (BM, BN)
SEG_ROWS = 64  # rows of one batch row's segment a consumer warpgroup holds


class RsItem(NamedTuple):
    """One work item of the bf16 route: output tile (m-tile ``mt`` = batch
    pair ``mt // IB``, row block ``mt % IB``; n-tile ``nt``) of the partial
    of segment ``seg`` of rank ``r`` at stage ``s``, channel ``c``.  Flags are
    ``("part", rank, stage, c, mt, nt)`` in ``rank``'s region; recv slot
    tiles ``(rank, stage, c, mt, nt)``; a pushing item first waits on
    ``entry``, ``("entry", r, dst)``: its own region's copy of the
    receiver's entry word (``ag_gemm.entry_keys``).  With an ``epoch`` every
    key ends with it."""

    index: int
    s: int
    r: int
    c: int
    mt: int
    nt: int
    seg: int  # segment reduced (rs_seg table)
    dst: int  # rank the partial is pushed to (rs_dst table); the last stage stores out
    wait: Optional[tuple]  # flag of the partial received at the stage before
    sets: Tuple[tuple, ...]
    reads: Tuple[tuple, ...]  # recv slot tiles read (s > 0)
    writes: Tuple[tuple, ...]  # recv slot tiles written (s < W-1)
    entry: Optional[tuple] = None  # the receiver's entry word waited on before the push (None: no push)


def channel_lead(c: int, n_sub: int, align: int = 8) -> int:
    """Columns channel c's tiles start before the channel: its first column
    rounded down to a multiple of ``align`` (a 16-byte aligned TMA box
    start: 8 bf16 columns, 16 int8 columns of a packed weight)."""
    return (c * n_sub) % align


def box_align(w) -> int:
    """The bf16 route's box-start alignment in columns for weight ``w``."""
    return 16 if isinstance(w, PackedWeight) else 8


def tiles(shape, nch: int, world: int, tile=TILE, align: int = 8):
    """(row blocks per batch row IB, m-tiles, n-tiles) of the bf16 route; the
    n-tiles cover a channel's n_sub columns plus the widest lead."""
    b, m_glob, _, n = shape
    ib = -(-(m_glob // world) // SEG_ROWS)
    per_tile = tile[0] // SEG_ROWS  # batch rows of an m-tile
    n_sub = n // nch
    widest = max(channel_lead(c, n_sub, align) for c in range(nch))
    return ib, -(-b // per_tile) * ib, -(-(n_sub + widest) // tile[1])


def work_items(plan: TilePlan, shape, tile=TILE, align: int = 8, *, ranks=None, epoch: Optional[int] = None) -> list:
    """The bf16 route's work items, stage-major: numbered by (s, r, c, nt, mt)
    with mt fastest, as ``gemm_rs_wgmma_kernel`` decodes its item index
    (``wg_item``): the blocks that run together share a weight strip.

    ``shape`` is ``(B, M, k_loc, N)`` (B the flattened batch dims); ``align``
    the box-start alignment (:func:`box_align`); ``ranks`` and ``epoch`` as
    in ``ag_gemm.work_items`` (the held ranks a launch runs; the call's
    epoch on every key)."""
    world, nch = plan.world, plan.num_channels
    _, m_tiles, n_tiles = tiles(shape, nch, world, tile, align)
    seg_t, dst_t = plan.rs_seg_tables(), plan.rs_dst_tables()
    held = range(world) if ranks is None else sorted(ranks)
    e = () if epoch is None else (epoch,)
    items = []
    for s in range(world):
        for r in held:
            for c in range(nch):
                seg, d = seg_t[c][s][r], dst_t[c][s][r]
                push = s < world - 1
                entry = ("entry", r, d) + e if push else None
                for nt in range(n_tiles):
                    for mt in range(m_tiles):
                        wait = ("part", r, s - 1, c, mt, nt) + e if s > 0 else None
                        reads = ((r, s - 1, c, mt, nt) + e,) if s > 0 else ()
                        sets = (("part", d, s, c, mt, nt) + e,) if push else ()
                        writes = ((d, s, c, mt, nt) + e,) if push else ()
                        items.append(RsItem(len(items), s, r, c, mt, nt, seg, d, wait, sets, reads, writes, entry))
    return items


def _check(x: torch.Tensor, w, world: Optional[int] = None):
    if x.dim() < 3 or len(w.shape) != 3 or x.shape[0] != w.shape[0] or x.shape[-1] != w.shape[1]:
        raise ValueError(
            f"gemm_rs: expected x [W, ..., M, k_loc] and w [W, k_loc, N], got {tuple(x.shape)}, {tuple(w.shape)}"
        )
    world = world or x.shape[0]
    if x.shape[-2] % world:
        raise ValueError(f"gemm_rs: {x.shape[-2]} rows do not divide over {world} ranks")


def launch_plan(x, w, channel=None, world: Optional[int] = None):
    """The plan the launch on these operands runs, and its channel
    (``world``: the TP degree, default ``x``'s rank dimension)."""
    world, n = world or x.shape[0], w.shape[-1]
    channel = channel or BlockChannel(axis="model")
    nch = effective_channels(n, channel.num_channels, kind="matmul_rs")
    return build_plan("matmul_rs", channel, world, nch), channel


def launch_items(x: torch.Tensor, w, channel: Optional[BlockChannel] = None) -> list:
    """The work items the bf16 route runs for these operands."""
    _check(x, w)
    plan, _ = launch_plan(x, w, channel)
    shape = (math.prod(x.shape[1:-2]), x.shape[-2], x.shape[-1], w.shape[-1])
    return work_items(plan, shape, align=box_align(w))


@functools.lru_cache(maxsize=512)
def layout(plan: TilePlan, route: str, shape, wire: torch.dtype, align: int = 8, n_tiles: int = 1) -> peer.Layout:
    """A rank's receive region (``kernels/peer.Layout``): recv slots [W*C,
    B*m_loc*n_sub] in the wire dtype and one flag per (stage, channel,
    m-tile, n-tile) on the bf16 route (``shape`` (B, M, k_loc, N)), per
    (stage, channel, n-tile) of ``n_tiles`` on the float32 route."""
    world, nch = plan.world, plan.num_channels
    b, m_glob, _, n = shape
    if route == "wgmma":
        _, m_tiles, n_tiles = tiles(shape, nch, world, align=align)
        per = m_tiles * n_tiles
    else:
        per = n_tiles
    return peer.Layout((world * nch, b * (m_glob // world) * (n // nch)), wire, world * nch * per, world)


def gemm_rs_plain(x: torch.Tensor, w, *, channel: Optional[BlockChannel] = None, split: bool = False) -> torch.Tensor:
    """Plain version: the bf16 route's work items replayed in order in
    PyTorch, the recv slots in the wire dtype, the weight formed as ``x``'s
    route forms it (``ag_gemm.plain_weight``).  ``split``: replay the peer
    route on this process's CPU pool (``ag_gemm.ag_gemm_plain``)."""
    _check(x, w)
    refuse_quantized_wire("gemm_rs", channel)
    plan, _ = launch_plan(x, w, channel)
    world, nch = plan.world, plan.num_channels
    lead, (m_glob, k), n = x.shape[1:-2], x.shape[-2:], w.shape[-1]
    b = math.prod(lead)
    m_loc, n_sub = m_glob // world, n // nch
    align = box_align(w)
    ib_count, _, _ = tiles((b, m_glob, k, n), nch, world, align=align)
    per_tile = TILE[0] // SEG_ROWS
    xs = x.reshape(world, b, m_glob, k)
    wf, col_scale = plain_weight(w, x.dtype)
    wire = as_dtype(plan.flow_dtype)
    if split:
        pl = peer.pool("gemm_rs", layout(plan, "wgmma", (b, m_glob, k, n), wire, align), x.device, split=True)
        pl.epoch += 1
        epoch, boards = pl.epoch, pl.boards
        slots = [t.view(world * nch, b, m_loc, n_sub) for t in pl.slots]
        for key in entry_keys(world, range(world)):  # the launch prologue
            peer_tile_notify(boards[key[1]], key, epoch)
    else:
        slots = torch.zeros((world, world * nch, b, m_loc, n_sub), dtype=wire, device=x.device)
        epoch, boards = 1, [FlagBoard()] * world
    out = torch.zeros((world, b, m_loc, n), dtype=x.dtype, device=x.device)
    for it in work_items(plan, (b, m_glob, k, n), align=align):
        if it.wait is not None:  # the partial of the stage before; the order sets it first, else this raises
            peer_tile_wait(boards[it.r], it.wait, epoch)
        r, c = it.r, it.c
        bp, ib = divmod(it.mt, ib_count)
        bs = slice(bp * per_tile, min(b, (bp + 1) * per_tile))
        rs = slice(ib * SEG_ROWS, min(m_loc, (ib + 1) * SEG_ROWS))
        col0 = it.nt * TILE[1] - channel_lead(c, n_sub, align)
        cs = slice(max(0, col0), min(n_sub, col0 + TILE[1]))
        gcs = slice(c * n_sub + cs.start, c * n_sub + cs.stop)
        rows = xs[r, bs, it.seg * m_loc + rs.start : it.seg * m_loc + rs.stop]
        part = rows.float() @ wf[r, :, gcs]
        if col_scale is not None:
            part = part * col_scale[r, gcs]
        if it.reads:
            part = part + slots[r][(it.s - 1) * nch + c, bs, rs, cs].float()  # partial received last stage
        if it.writes:  # push to the peer's recv slot, then its flag
            if split:  # the receiver's call before has read its recv slots
                peer_tile_wait(boards[r], it.entry, epoch)
            tile_push_data(slots[it.dst], (it.s * nch + c, bs, rs, cs), part.to(wire))
            for key in it.sets:
                peer_tile_notify(boards[key[1]], key, epoch)
        else:
            out[r, bs, rs, gcs] = part.to(x.dtype)
    return out.reshape((world,) + tuple(lead) + (m_loc, n))


def gemm_rs(
    x: torch.Tensor,
    w,
    *,
    channel: Optional[BlockChannel] = None,
    bn: Optional[int] = None,
    world=None,
    split: bool = False,
) -> torch.Tensor:
    """Fused GEMM+RS over the rank dimension.

    ``x``: [W, *lead, M, k_loc], ``w``: [W, k_loc, N] -> [W, *lead, M/W, N]:
    rank r's row segment of ``sum_q x[q] @ w[q]``.  The schedule and the
    accum dtype (also the wire dtype of the identity QuantSpec) come from
    ``channel``.  A CPU tensor runs :func:`gemm_rs_plain`; a CUDA tensor
    launches the kernel of its dtype's route (``build.ROUTES``) or raises:
    bfloat16 takes the wgmma route (k_loc and N multiples of 8 and N / C
    even, else ValueError), float32 the FMA route with n tile ``bn`` (default the
    CompSpec tn clamped to a divisor of N / C and widened by
    :func:`~repro_torch.core.comp_tiles.fma_n_tile`).  The recv slots take
    the plan's wire dtype (float32 or bfloat16, else TypeError); ``w`` may
    be a :class:`~repro_torch.core.quant.PackedWeight` (module docstring);
    a quantized wire raises.  ``world`` / ``split``: the receive regions'
    pool, as ``ag_gemm.ag_gemm`` takes them (``x`` / ``w`` hold a world
    over processes' ``held`` ranks).
    """
    _check(x, w, world.size if world is not None and world.nprocs > 1 else None)
    refuse_quantized_wire("gemm_rs", channel)
    procs = world is not None and world.nprocs > 1
    if x.device.type == "cpu" and w.device.type == "cpu":
        if procs:
            raise ValueError("gemm_rs: the peer route over processes runs on the card (on the CPU the eager "
                             "executor stands in for it)")  # fmt: skip
        return gemm_rs_plain(x, w, channel=channel, split=split)
    if procs and x.shape[0] != world.held:
        raise ValueError(f"gemm_rs: expected the {world.held} held ranks of {world}, got {tuple(x.shape)}")
    plan, channel = launch_plan(x, w, channel, world.size if procs else None)
    w_ptr, s_ptr, z_ptr, _keep = build.weight_operands("gemm_rs", x, w)
    wire = as_dtype(plan.flow_dtype)
    world_size, nch = plan.world, plan.num_channels
    held = x.shape[0]
    lead, (m_glob, k), n = x.shape[1:-2], x.shape[-2:], w.shape[-1]
    b = math.prod(lead)
    m_loc, n_sub = m_glob // world_size, n // nch
    out = torch.empty((held, b, m_loc, n), dtype=x.dtype, device=x.device)
    seg = device_table(plan, "rs_seg", x.device)
    dst = device_table(plan, "rs_dst", x.device)
    route = build.ROUTES[x.dtype]
    lib = build.library()
    shape = (b, m_glob, k, n)
    if route == "wgmma":
        if n_sub % 2:
            raise ValueError(f"gemm_rs: the bf16 route stores column pairs; N / C = {n_sub} must be even")
        reg = peer.regions("gemm_rs", layout(plan, route, shape, wire, box_align(w)), x.device, world=world,
                           split=split)  # fmt: skip
        info = (ctypes.c_int * 2)()
        rc = lib.tl_gemm_rs_wgmma(
            build.dtype_code(wire),
            x.data_ptr(), w_ptr, s_ptr, z_ptr, out.data_ptr(), reg.address, seg.data_ptr(), dst.data_ptr(),
            ctypes.addressof(info), world_size, nch, b, m_glob, k, n, n_sub, build.stream(x),
        )  # fmt: skip
        build.check(rc, "gemm_rs")
        gemm_rs.last_launch = {
            "route": route, "grid": info[0], "items": info[1], "tile": TILE, "packed": bool(s_ptr),
            "wire": dtype_name(wire), "pool": reg.mode,
        }  # fmt: skip
    else:
        bn = fma_n_tile(n_sub, bn or channel.comp.tile[1], nch * held, probe(x.device).sm_count)
        n_tiles = n_sub // bn
        # one flag per (rank, stage, channel, n-tile)
        reg = peer.regions("gemm_rs", layout(plan, route, shape, wire, n_tiles=n_tiles), x.device, world=world,
                           split=split)  # fmt: skip
        rc = lib.tl_gemm_rs(
            build.dtype_code(wire),
            x.data_ptr(), w_ptr, s_ptr, z_ptr, out.data_ptr(), reg.address, seg.data_ptr(), dst.data_ptr(),
            world_size, nch, n_tiles, b, m_glob, k, n, n_sub, bn, build.stream(x),
        )  # fmt: skip
        build.check(rc, "gemm_rs")
        gemm_rs.last_launch = {
            "route": route, "grid": n_tiles * nch * held, "items": None, "tile": (64, bn), "packed": bool(s_ptr),
            "wire": dtype_name(wire), "pool": reg.mode,
        }  # fmt: skip
    gemm_rs.launches += 1
    gemm_rs.packed_launches += bool(s_ptr)
    return out.reshape((held,) + tuple(lead) + (m_loc, n))


gemm_rs.launches = 0
gemm_rs.packed_launches = 0  # the launches that took a PackedWeight
gemm_rs.last_launch = None
