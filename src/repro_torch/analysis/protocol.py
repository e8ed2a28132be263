"""Pass 2 — the flag protocol of the port's fused kernels.

The port's counterpart of ``repro/analysis/protocol.py``.  The JAX
package's pass models the Pallas kernels: DMA semaphores, a send credit and
one VMEM staging buffer.  The port's kernels (``kernels/csrc/ag_gemm.cu``,
``gemm_rs.cu`` over ``tile_sync.cuh``) have none of these: all W ranks run
in one cooperative launch, a tile travels by plain stores into the
receiving rank's slot, and a release / acquire flag says it landed.  So
this pass reads a :class:`~repro_torch.analysis.ir.Launch` (the items each
block runs, each item's flag waits and sets and slot-tile reads and writes)
and checks:

  * ``flag_count``       — every flag is set exactly once, and every flag
                           waited on is set by some item;
  * ``item_order``       — every wait is on a flag set by an item with a
                           smaller number (or earlier in the waiting item's
                           own ops: the AG seed item sets the flag its
                           producer then waits on).  This is the invariant
                           the kernels' no-deadlock argument rests on
                           (``ag_gemm.cu``: the smallest unfinished item can
                           always run, for any G >= 1);
  * ``double_write``     — every gather / recv slot tile is written once a
                           pass (no send credit guards a reuse: there is none);
  * ``read_before_flag`` — every slot-tile read is preceded, in its item,
                           by a wait on a flag whose setter wrote that tile
                           before setting it, or by the item's own write
                           (the AG seed item reads the slot it filled);
  * ``deadlock``         — G co-resident blocks run to completion, block b
                           taking items b, b+G, ... (the bf16 route), in
                           round robin (one item a turn) and in a seeded
                           random interleaving; the float32 route's blocks,
                           one per grid tile, all resident.  A stuck state
                           names the blocked block, its item and the flag.

The flags are the paper's tile primitives (Table 3), the only flag code
of both kernels, in ``kernels/csrc/tile_sync.cuh``: ``producer_tile_notify``
and ``peer_tile_notify`` (every thread fences its stores, the group's
barrier, one release store: the ``set`` ops of an item),
``consumer_tile_wait`` and ``peer_tile_wait`` (one thread's acquire spin, a
fence, the group's barrier: the ``wait`` ops), each in a block-wide form
(the float32 routes), a one-thread form (the bf16 routes' TMA producer
warp) and a form over the consumer warpgroups' own barrier (``_synced``);
and ``tile_push_data`` (the stores into a peer's slot: the ``write`` ops).
``core/primitives`` holds the same names over a host flag board, which the
plain versions replay.

Within a block the producer warp runs ahead of the consumers, but it waits
only after it has issued the loads of the items before, so running a
block's items one after another is the same as far as deadlock goes.

What runs where: :func:`check_protocol` is shape-free (``verify_plan`` runs
it for ``ag_matmul`` and ``matmul_rs``: both routes at the canonical shape
of ``ir.CANON_TILES`` and the packed-weight variant of the AG items);
:func:`check_launch` checks one concrete launch (``verify.verify_launch``);
:func:`check_seam_protocol` the RS -> AG pair as two launches, ``gemm_rs``
then ``ag_gemm``, the launch boundary a barrier: the AG seed items read
the home segments the RS launch stored.  The kinds whose executors move
tiles by stream-ordered ``World.permute`` (``ag_attention``, ``ag_moe``,
``a2a_dispatch``, ``combine_rs``) have no flags to check.
"""

from __future__ import annotations

import dataclasses
import heapq
import random
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.errors import PlanVerificationError
from repro_torch.analysis.ir import (
    CANON_TILES,
    Launch,
    PlanTables,
    canonical_ag_shape,
    canonical_rs_shape,
    fma_ag_launch,
    fma_rs_launch,
    wgmma_launch,
)

__all__ = [
    "PROTOCOL_KINDS",
    "PROTOCOL_GRIDS",
    "check_peer_protocol",
    "peer_launches",
    "check_launches",
    "check_launch",
    "check_protocol",
    "check_seam_protocol",
    "plan_launches",
    "simulate",
    "check_order",
]

PROTOCOL_KINDS = {"ag_matmul": "ag_gemm", "matmul_rs": "gemm_rs"}  # kind -> its fused kernel
KIND_OF_KERNEL = {v: k for k, v in PROTOCOL_KINDS.items()}
# the persistent grids the shape-free pass simulates: one block, a few, and the H100's 132 SMs
PROTOCOL_GRIDS = (1, 3, 7, 132)
SEED = 7  # the seeded random interleaving
PEER_SCHEDULES = (None, SEED, "first", "last")  # how the peer pass interleaves the processes' grids
PEER_TILES = (1, 2)  # the peer pass's m-tiles x n-tiles per (step, rank, channel)


def _err(message, *, check, ctx, item=None, launch: Optional[Launch] = None):
    kw = dict(ctx)
    if launch is not None and "kind" not in kw:
        kw["kind"] = KIND_OF_KERNEL[launch.kernel]
    if item is not None:
        kw.update(step=item.s, rank=item.r, channel=item.c)
    return PlanVerificationError(message, check=check, **kw)


def _static(launches: Sequence[Launch], ctx) -> Tuple[int, Dict, Dict]:
    """flag_count, item_order, double_write and read_before_flag over the
    launches in order (items numbered across them, each launch boundary a
    barrier).  Returns (checks, setter, writer): flag -> item number, tile
    -> item number."""
    setter, writer, published, origin = {}, {}, {}, {}
    checks = 0
    base = 0
    bounds = []
    for li, ln in enumerate(launches):
        for it in ln.items:
            n = base + it.index
            done = []
            for pos, (op, key) in enumerate(it.ops):
                if op == "set":
                    if key in setter or key in ln.prologue:
                        raise _err(f"flag {key} set twice (items {setter.get(key, ('a prologue',))[0]} and {n})",
                                   check="flag_count", ctx=ctx, item=it, launch=ln)  # fmt: skip
                    setter[key] = (n, pos)
                    published[key] = tuple(done)
                elif op == "write":
                    if key in writer:
                        raise _err(f"slot tile {key} written twice (items {writer[key]} and {n})",
                                   check="double_write", ctx=ctx, item=it, launch=ln)  # fmt: skip
                    writer[key] = n
                    origin[key] = li
                    done.append(key)
        bounds.append(base)
        base += len(ln.items)
    for li, ln in enumerate(launches):
        b0 = bounds[li]
        for it in ln.items:
            n = b0 + it.index
            guard = set()
            for pos, (op, key) in enumerate(it.ops):
                if op == "wait":
                    if key in ln.prologue:  # the launch's own entry words: set before any of its items
                        checks += 1
                        continue
                    hit = setter.get(key)
                    if hit is None:
                        raise _err(f"item {n} waits on flag {key}, which no item sets", check="flag_count",
                                   ctx=ctx, item=it, launch=ln)  # fmt: skip
                    if not (hit[0] < n or (hit[0] == n and hit[1] < pos)):
                        raise _err(f"item {n} waits on flag {key}, set by item {hit[0]}, which comes later",
                                   check="item_order", ctx=ctx, item=it, launch=ln)  # fmt: skip
                    guard.update(published[key])
                    checks += 2
                elif op == "write":
                    guard.add(key)
                    checks += 1
                elif op == "read":
                    if key not in guard and origin.get(key, li) >= li:
                        who = writer.get(key)
                        why = "no item writes it" if who is None else f"no flag it waited on orders item {who}'s write"
                        raise _err(f"item {n} reads slot tile {key} before it is written: {why}",
                                   check="read_before_flag", ctx=ctx, item=it, launch=ln)  # fmt: skip
                    checks += 1
                else:
                    checks += 1
    return checks, setter, writer


def _codes(ln: Launch) -> Tuple[List[List[int]], List]:
    """Each item's waits and sets as ints, 2 * flag id (+1 for a set), with
    the launch's own flag ids (every launch starts from zeroed flags), and
    the keys by id; indexed by item number (a launch's items are numbered
    0, 1, ...).  Cached on the launch: a regridded launch shares them."""
    hit = ln.__dict__.get("_codes")
    if hit is None:
        fid: Dict = {key: i for i, key in enumerate(ln.prologue)}  # the prologue's flags come first
        codes = [[2 * fid.setdefault(key, len(fid)) + (op == "set") for op, key in it.ops if op in ("wait", "set")]
                 for it in ln.items]  # fmt: skip
        hit = (codes, list(fid))
        object.__setattr__(ln, "_codes", hit)
    return hit


def _run(ln: Launch, seed: Optional[int], ctx) -> Tuple[int, List[int]]:
    """Run the launch's blocks to completion: round robin, one item a turn
    (``seed`` None), or a random ready block each turn.  Returns (ops run,
    items in the order they finished); raises ``deadlock`` on a stuck state."""
    codes, keys = _codes(ln)
    blocks = ln.blocks
    nb = len(blocks)
    is_set = bytearray(max(1, len(keys)))
    is_set[: len(ln.prologue)] = b"\x01" * len(ln.prologue)  # set when the launch starts
    nxt, at = [0] * nb, [0] * nb  # per block: its next item's place in the block, the op reached in it
    waiting: Dict[int, List[int]] = {}
    ready = deque(range(nb)) if seed is None else list(range(nb))
    take = ready.popleft if seed is None else None
    rand = random.Random(seed).random
    ran, events = [], 0
    while ready:
        if take is not None:
            b = take()
        else:
            k = int(rand() * len(ready))
            ready[k], ready[-1] = ready[-1], ready[k]
            b = ready.pop()
        i = blocks[b][nxt[b]]
        ops = codes[i]
        k, n = at[b], len(ops)
        while k < n:
            code = ops[k]
            if code & 1:
                f = code >> 1
                is_set[f] = 1
                woken = waiting.pop(f, None)
                if woken:
                    ready.extend(woken)
            elif not is_set[code >> 1]:
                waiting.setdefault(code >> 1, []).append(b)
                break
            k += 1
        events += k - at[b]
        if k < n:  # blocked on a wait
            at[b] = k
            continue
        ran.append(i)
        at[b] = 0
        nxt[b] += 1
        if nxt[b] < len(blocks[b]):
            ready.append(b)
    stuck = [b for b in range(nb) if nxt[b] < len(blocks[b])]
    if stuck:
        b = min(stuck, key=lambda b: blocks[b][nxt[b]])
        it = ln.items[blocks[b][nxt[b]]]
        flag = keys[codes[it.index][at[b]] >> 1]
        how = "round robin" if seed is None else f"random interleaving (seed {seed})"
        raise _err(f"deadlock with G = {nb} ({how}): block {b} is stuck at item {it.index}, waiting on flag {flag} "
                   f"({len(stuck)} block(s) stuck)", check="deadlock", ctx=ctx, item=it, launch=ln)  # fmt: skip
    return events, ran


def _simulate(launches: Sequence[Launch], seeds: Sequence[Optional[int]], ctx) -> Tuple[int, List[int]]:
    """Run the launches one after another (launch k starts once launch k-1
    has finished) under each interleaving of ``seeds``; returns (ops run,
    the item numbers in the order the last interleaving finished them)."""
    events, order = 0, []
    for seed in seeds:
        order, base = [], 0
        for ln in launches:
            ev, ran = _run(ln, seed, ctx)
            events += ev
            order += [base + i for i in ran]
            base += len(ln.items)
    return events, order


def check_launches(
    launches: Sequence[Launch], ctx=None, seeds=(None, SEED), grids: Sequence[int] = ()
) -> Tuple[int, int]:
    """Every check over launches that run one after another; returns
    (checks, events simulated).  ``grids``: also simulate the persistent
    launches on each of these G (the static checks do not depend on G)."""
    ctx = dict(ctx or {})
    checks, _, _ = _static(launches, ctx)
    events, _ = _simulate(launches, seeds, ctx)
    for g in grids:
        ev, _ = _simulate([ln.with_grid(g) if ln.persistent else ln for ln in launches], seeds, ctx)
        events += ev
    return checks + len(seeds) * (1 + len(grids)), events


def check_launch(items: Sequence, grid: int, *, packed: bool = False, ctx=None) -> Tuple[int, int]:
    """Check one bf16-route launch: the wrapper's ``items`` on G = ``grid``
    persistent blocks (``packed``: the AG items' packed-weight variant)."""
    return check_launches([wgmma_launch(items, grid, packed)], ctx)


def plan_launches(t: PlanTables, grid: int, *, packed: bool = False, fma: bool = False) -> Launch:
    """The canonical launch of a plan's kernel: the bf16 route's items at
    ``ir.CANON_TILES`` on ``grid`` blocks, or (``fma``) the float32 route's
    grid at CANON_TILES[1] n-tiles."""
    from repro_torch.kernels.ag_gemm import work_items as ag_items
    from repro_torch.kernels.gemm_rs import work_items as rs_items

    if PROTOCOL_KINDS[t.kind] == "ag_gemm":
        if fma:
            return fma_ag_launch(t, CANON_TILES[1])
        return wgmma_launch(ag_items(t, canonical_ag_shape(t.num_channels)), grid, packed)
    if fma:
        return fma_rs_launch(t, CANON_TILES[1])
    return wgmma_launch(rs_items(t, canonical_rs_shape(t.world, t.num_channels)), grid)


def _ctx(t: PlanTables):
    return dict(kind=t.kind, order=t.order, world=t.world)


def _variants(t: PlanTables):
    """(packed, fma) variants the shape-free pass checks for ``t``'s kernel."""
    out = [(False, False), (False, True)]
    return out + [(True, False)] if PROTOCOL_KINDS[t.kind] == "ag_gemm" else out


def check_protocol(t: PlanTables, grids: Sequence[int] = PROTOCOL_GRIDS) -> Tuple[int, int]:
    """The shape-free protocol pass of one ``ag_matmul`` / ``matmul_rs``
    plan: both routes at the canonical shape, the packed AG items too, the
    bf16 route on every grid of ``grids``, and the bf16 route's peer form
    with one rank a process (:func:`check_peer_protocol`, two calls).
    Returns (checks, events)."""
    if t.kind not in PROTOCOL_KINDS:
        raise ValueError(f"{t.kind!r} has no fused-kernel flags to check; one of {tuple(PROTOCOL_KINDS)}")
    checks = events = 0
    for packed, fma in _variants(t):
        ln = plan_launches(t, grids[0], packed=packed, fma=fma)
        c, e = check_launches([ln], _ctx(t), grids=() if fma else grids[1:])
        checks, events = checks + c, events + e
    c, e = check_peer_protocol(t, t.world, grids)
    return checks + c, events + e


# ---- the peer route: one grid per process, calls counted in epochs


def peer_launches(t: PlanTables, procs: int, grid: int, epoch: int, *, packed: bool = False) -> List[Launch]:
    """Call ``epoch`` of the bf16 route over ``procs`` processes: one launch
    per process, of its held ranks' items (numbered over them), every key
    ending with the epoch, its prologue the held ranks' entry words."""
    from repro_torch.kernels.ag_gemm import work_items as ag_items
    from repro_torch.kernels.gemm_rs import work_items as rs_items

    if t.world % procs:
        raise ValueError(f"{procs} processes do not divide a world of {t.world}")
    held = t.world // procs
    return [wgmma_launch(_peer_items(t, epoch, range(p * held, (p + 1) * held)), grid, packed, world=t.world)
            for p in range(procs)]  # fmt: skip


def _peer_items(t: PlanTables, epoch: int, ranks=None) -> list:
    """The bf16 route's items of call ``epoch`` (of ``ranks``) at the peer
    pass's canonical shape: PEER_TILES m-tiles x n-tiles per (step, rank,
    channel), so an n-tile that pushes and one that does not."""
    from repro_torch.kernels.ag_gemm import work_items as ag_items
    from repro_torch.kernels.gemm_rs import work_items as rs_items

    mt, nt = PEER_TILES
    if PROTOCOL_KINDS[t.kind] == "ag_gemm":
        return ag_items(t, (1, t.num_channels * 128 * mt, 128, 128 * nt), ranks=ranks, epoch=epoch)
    return rs_items(t, (2, t.world * 64 * mt, 128, t.num_channels * 128 * nt), ranks=ranks, epoch=epoch)


def _peer_static(t: PlanTables, calls: int, packed: bool, ctx) -> int:
    """flag_count, item_order, double_write and read_before_flag of each call
    over every rank at once (the global item order the processes' grids
    walk; every rank's entry words set before any item)."""
    from repro_torch.analysis.ir import prologue_of

    checks = 0
    for e in range(1, calls + 1):
        items = _peer_items(t, e)
        ln = wgmma_launch(items, 1, packed, world=t.world)
        checks += _static([dataclasses.replace(ln, prologue=prologue_of(items, t.world))], ctx)[0]
    return checks


def _peer_codes(calls: Sequence[Sequence[Launch]]):
    """The runs' ops as ints, ``4 * id + op`` (op 0 wait, 1 set, 2 read, 3
    write; flags and slot tiles numbered over every launch), the
    prologues' flag ids, the reads each (slot tile, epoch) id awaits, and
    each written tile's id at the epoch before (-1 if none)."""
    fid: Dict = {}
    tid: Dict = {}
    kinds = {"wait": 0, "set": 1, "read": 2, "write": 3}
    codes, pro = [], []
    for launches in calls:
        codes.append([[[4 * (fid if op in ("wait", "set") else tid).setdefault(key, len(fid if op in ("wait", "set")
                                                                                      else tid)) + kinds[op]
                        for op, key in it.ops] for it in ln.items] for ln in launches])  # fmt: skip
        pro.append([[fid.setdefault(key, len(fid)) for key in ln.prologue] for ln in launches])
    reads = [0] * len(tid)
    for launches in calls:
        for ln in launches:
            for it in ln.items:
                for op, key in it.ops:
                    if op == "read":
                        reads[tid[key]] += 1
    prev = [tid.get(key[:-1] + (key[-1] - 1,), -1) for key in tid]
    return codes, pro, reads, prev, list(tid)


class _Ready:
    """The ready blocks ``(process, block)`` of the peer simulation, taken
    round robin (``seed`` None), at random (an int seed), or the lowest /
    highest process first ("first" / "last")."""

    def __init__(self, seed):
        self.seed, self._n = seed, 0
        self._fifo: deque = deque()
        self._heap: list = []
        self._rand = random.Random(seed).random if isinstance(seed, int) else None

    def __bool__(self) -> bool:
        return bool(self._fifo or self._heap)

    def append(self, pb):
        if self.seed in ("first", "last"):
            self._n += 1
            heapq.heappush(self._heap, (pb[0] if self.seed == "first" else -pb[0], self._n, pb))
        else:
            self._fifo.append(pb)

    def extend(self, pbs):
        for pb in pbs:
            self.append(pb)

    def pop(self):
        if self._heap:
            return heapq.heappop(self._heap)[2]
        if self._rand is None:
            return self._fifo.popleft()
        k = int(self._rand() * len(self._fifo))
        self._fifo[k], self._fifo[-1] = self._fifo[-1], self._fifo[k]
        return self._fifo.pop()


def _run_peer(calls: Sequence[Sequence[Launch]], seed, ctx, codes=None) -> int:
    """Run the processes' grids together: process p's launch of call k + 1
    starts once its call k has finished (stream order) and sets its
    prologue then; every process runs its blocks' items in order, one item
    a turn (``seed`` None: round robin over every block of every process;
    an int: a seeded random ready block; "first" / "last": the ready block
    of the lowest / highest process, which runs ahead as far as its flags
    let it).  Flags are values: a key names its call.  Besides
    ``deadlock``, raises ``overwrite`` when a write of call e lands on a slot
    tile that call e - 1 has still to read.  Returns the ops run."""
    codes, pro, pending, prev, tiles = codes or _peer_codes(calls)  # the same items on any grid: the same codes
    pending = list(pending)
    procs = len(calls[0])
    is_set = bytearray(max(1, 1 + max((c >> 2 for run in codes for ln in run for it in ln for c in it if c & 3 < 2),
                                      default=0)))  # fmt: skip
    for run in pro:
        for ids in run:
            for f in ids:
                if f >= len(is_set):
                    is_set.extend(bytes(f + 1 - len(is_set)))
    call = [0] * procs
    place: Dict[tuple, int] = {}
    at: Dict[tuple, int] = {}
    waiting: Dict[int, List[tuple]] = {}
    ready = _Ready(seed)
    left = [0] * procs

    def start(p):
        for f in pro[call[p]][p]:
            is_set[f] = 1
            ready.extend(waiting.pop(f, ()))
        blocks = calls[call[p]][p].blocks
        left[p] = len(blocks)
        for b in range(len(blocks)):
            place[(p, b)], at[(p, b)] = 0, 0
            ready.append((p, b))

    for p in range(procs):
        start(p)
    events = 0
    while ready:
        pb = ready.pop()
        p, b = pb
        ln = calls[call[p]][p]
        i = ln.blocks[b][place[pb]]
        ops = codes[call[p]][p][i]
        a0 = a = at[pb]
        while a < len(ops):
            c = ops[a]
            op, x = c & 3, c >> 2
            if op == 0 and not is_set[x]:
                waiting.setdefault(x, []).append(pb)
                break
            if op == 1:
                is_set[x] = 1
                ready.extend(waiting.pop(x, ()))
            elif op == 2:
                pending[x] -= 1
            elif op == 3 and prev[x] >= 0 and pending[prev[x]]:
                it, key = ln.items[i], tiles[x]
                raise _err(f"process {p}'s item {it.index} of call {key[-1]} writes slot tile {key[:-1]} before "
                           f"call {key[-1] - 1} has read it", check="overwrite", ctx=ctx, item=it, launch=ln)  # fmt: skip
            a += 1
        events += a - a0
        if a < len(ops):
            at[pb] = a
            continue
        place[pb] += 1
        at[pb] = 0
        if place[pb] < len(ln.blocks[b]):
            ready.append(pb)
            continue
        left[p] -= 1
        if left[p] == 0 and call[p] + 1 < len(calls):
            call[p] += 1
            start(p)
    stuck = [pb for pb, n in place.items() if n < len(calls[call[pb[0]]][pb[0]].blocks[pb[1]])]
    if stuck or any(c + 1 < len(calls) for c in call):
        p, b = stuck[0] if stuck else (0, 0)
        ln = calls[call[p]][p]
        it = ln.items[ln.blocks[b][place[(p, b)]]] if stuck else None
        how = {None: "round robin", "first": "process 0 ahead", "last": "the last process ahead"}.get(
            seed, f"random interleaving (seed {seed})")  # fmt: skip
        raise _err(f"deadlock over {procs} processes ({how}): process {p} block {b} is stuck in call {call[p] + 1}"
                   f"{'' if it is None else f' at item {it.index}'} ({len(stuck)} block(s) stuck)", check="deadlock",
                   ctx=ctx, item=it, launch=ln)  # fmt: skip
    return events


def check_peer_protocol(t: PlanTables, procs: int, grids: Sequence[int] = PROTOCOL_GRIDS,
                        calls: int = 2) -> Tuple[int, int]:  # fmt: skip
    """The bf16 route's peer form over ``procs`` processes (each holding
    W / procs ranks, one grid each), ``calls`` calls on one pool in a row,
    never zeroed: each call's static checks over every rank, then the
    processes' grids simulated together on every G of ``grids`` (round
    robin, a seeded interleaving, and the first and the last process each
    running ahead): no deadlock across the grids and the calls,
    and no push of a call before the receiver's call before has read the
    slot (the entry words).  Returns (checks, events)."""
    ctx = dict(_ctx(t), order=t.order)
    checks = events = 0
    for packed in (False, True) if PROTOCOL_KINDS[t.kind] == "ag_gemm" else (False,):
        checks += _peer_static(t, calls, packed, ctx)
        base = [peer_launches(t, procs, grids[0], e, packed=packed) for e in range(1, calls + 1)]
        codes = _peer_codes(base)
        for g in grids:
            runs = [[ln.with_grid(g) for ln in run] for run in base]
            for seed in PEER_SCHEDULES if procs > 1 else (None,):
                events += _run_peer(runs, seed, ctx, codes)
                checks += 1
    return checks, events


def _seam_edges(rs: Launch, ag: Launch, producer: PlanTables) -> Tuple[Launch, Launch]:
    """The seam handoff: each last-stage RS item of rank r, channel c stores
    a tile of the segment it reduced (``rs_seg[c][W-1][r]``) into rank r's
    output, ``("home", r, segment, c, k)``; each AG seed item of rank r (the
    bf16 route's step-0 n-tile-0 items, the float32 route's step-0 pushing
    blocks) reads rank r's home segment r whole, every (c, k) of it."""
    last = producer.world - 1
    tiles: Dict[int, list] = {}
    rs_items = []
    for it in rs.items:
        ops = it.ops
        if it.s == last:
            seg = producer.rs_seg[it.c][last][it.r]
            k = sum(1 for t in tiles.get(it.r, ()) if t[0] == it.c)
            tiles.setdefault(it.r, []).append((it.c, k))
            ops = ops + (("write", ("home", it.r, seg, it.c, k)),)
        rs_items.append(it._replace(ops=ops))
    ag_items = []
    for it in ag.items:
        ops = it.ops
        if it.s == 0 and any(op == "set" for op, _ in it.ops):
            ops = tuple(("read", ("home", it.r, it.r, c, k)) for c, k in tiles.get(it.r, ())) + ops
        ag_items.append(it._replace(ops=ops))
    return dataclasses.replace(rs, items=tuple(rs_items)), dataclasses.replace(ag, items=tuple(ag_items))


def check_seam_protocol(producer: PlanTables, consumer: PlanTables,
                        grids: Sequence[int] = PROTOCOL_GRIDS) -> Tuple[int, int]:  # fmt: skip
    """The RS -> AG pair as the fused backend runs it: the ``gemm_rs``
    launch, then the ``ag_gemm`` launch on its output, stream-ordered (the
    boundary a barrier), both routes at the canonical shapes; the AG seed
    items read the home segments the RS launch stored (``home == rank`` is
    ``check_seam``'s; here the read must find them written)."""
    ctx = dict(kind=f"{producer.kind}->{consumer.kind}", order=producer.order, world=producer.world)
    checks = events = 0
    for fma in (False, True):
        pair = _seam_edges(
            plan_launches(producer, grids[0], fma=fma), plan_launches(consumer, grids[0], fma=fma), producer
        )
        c, e = check_launches(pair, ctx, grids=() if fma else grids[1:])
        checks, events = checks + c, events + e
    return checks, events


# ---- the wrapper items' schedule, as tests/test_torch_fused_schedule.py reads it


def simulate(items: Sequence, grid: int, seed: Optional[int] = None, *, packed: bool = False) -> List[int]:
    """Run the wrapper's bf16 ``items`` on G = ``grid`` persistent blocks
    (round robin, or a random interleaving with ``seed``) after the static
    checks; returns the item numbers in the order they finished.  Raises
    :class:`PlanVerificationError` (``deadlock``, ``read_before_flag``, ...)."""
    ln = wgmma_launch(items, grid, packed)
    _static([ln], {})
    return _simulate([ln], (seed,), {})[1]


def check_order(items: Sequence, *, packed: bool = False) -> Tuple[Dict, Dict]:
    """The static checks over the wrapper's ``items``; returns (flag ->
    setting item, slot tile -> writing item), in the items' own keys."""
    _, setter, writer = _static([wgmma_launch(items, 1, packed)], {})
    return {f: n for f, (n, _) in setter.items()}, writer
