"""Receive regions of the fused kernels: one a rank, found through a table.

Replaces no TPU kernel.  On the TPU the fused kernels' remote DMAs address
another chip's buffers through the mesh (``src/repro/kernels/ag_gemm.py``,
``tile_push_data`` = ``pltpu.make_async_remote_copy``).  Here a push is
plain stores through a pointer: ``csrc/tile_sync.cuh``'s ``PeerTbl`` gives
the kernels each rank's receive region, its slots and its control words
(the ready flags, W entry words, 2 words of its own: :class:`Layout`), by
addresses in the launch's parameters (at most :data:`MAX_WORLD` ranks),
built from the host :class:`PeerArgs` a launch passes.  Three forms, by
where the ranks live:

  ``"one"``    every rank emulated in this process (``World(W)`` on one
               card, what the kernels always ran): made for each call by
               :func:`regions`, one ``torch.empty`` of every rank's slots
               and one ``torch.zeros`` of every rank's control words (so
               every call is epoch 1), each at a fixed stride, so the
               launch takes two addresses and no table; device scope;
  ``"split"``  every rank in this process, each rank's region its own
               ``cudaMalloc`` (``csrc/peer.cu``), system scope: the peer
               route on one card, which checks the addressing of separate
               allocations and the epochs without a second card;
  ``"procs"``  a world over P processes (``World(..., procs=)``): this
               process allocates its held ranks' regions (``cudaMalloc``),
               the processes exchange their CUDA IPC handles once over the
               world's process group, and every other rank's region is a
               peer card's memory mapped here (``cudaIpcOpenMemHandle``,
               peer access over NVLink); system scope.

A ``"split"`` or ``"procs"`` region set is a :class:`Pool`, kept per
``(kind, layout, device)`` for the process; its regions are never zeroed
again: the kernels count its calls in epochs (``tile_sync.cuh``).  It is
created outside a CUDA-graph capture and is stream-ordered: the calls on
one pool run on one stream at a time, as the port's do.  On the CPU a
``"split"`` pool holds each rank's slots as a tensor and its flags and
entry words on a ``core.primitives.FlagBoard``, with the epoch on the
host: the plain versions replay the peer route on it
(``ag_gemm_plain(split=True)``).  :func:`release` closes the mappings and
frees the regions (a process of a world over processes passes it a barrier
of the group, before it leaves the group).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.primitives import FlagBoard

__all__ = ["Layout", "PeerArgs", "Pool", "Regions", "regions", "pool", "release", "pools", "pool_bytes", "ALIGN",
           "MODES", "MAX_WORLD"]  # fmt: skip

ALIGN = 256  # bytes: a cudaMalloc'd region's control words start on this boundary (128-byte lines)
CTL_WORDS = 32  # a rank's control words round up to this many int32 (one 128-byte line each)
MODES = ("one", "split", "procs")
MAX_WORLD = 16  # ranks a table holds (csrc/tile_sync.cuh, TL_MAX_W)
HANDLE_BYTES = 64  # a cudaIpcMemHandle_t


def _align(n: int, to: int = ALIGN) -> int:
    return -(-n // to) * to


@dataclasses.dataclass(frozen=True)
class Layout:
    """One rank's receive region: the slots (``slot_shape`` of ``dtype``) and
    its control words, int32: ``flags`` ready flags, ``world`` entry words,
    2 words of its own (the last finished epoch, the blocks finished in this
    call).  Offsets in bytes, from the control words' address."""

    slot_shape: Tuple[int, ...]
    dtype: torch.dtype
    flags: int
    world: int

    @functools.cached_property
    def slot_bytes(self) -> int:
        n = self.dtype.itemsize
        for d in self.slot_shape:
            n *= d
        return n

    @property
    def entry_off(self) -> int:
        return 4 * self.flags

    @property
    def ctl_off(self) -> int:
        return 4 * (self.flags + self.world)

    @functools.cached_property
    def ctl_words(self) -> int:
        return _align(self.flags + self.world + 2, CTL_WORDS)

    @functools.cached_property
    def ctl_base(self) -> int:
        """Where a ``cudaMalloc``'d region's control words start."""
        return _align(self.slot_bytes)

    @functools.cached_property
    def nbytes(self) -> int:
        """A ``cudaMalloc``'d region: the slots, then the control words."""
        return self.ctl_base + 4 * self.ctl_words


class PeerArgs(ctypes.Structure):
    """The host form of a launch's regions (``csrc/tile_sync.cuh``'s
    ``PeerArgs``): a table ``bases`` of 2W addresses (every rank's slots,
    then every rank's control words), or, with ``bases`` null, rank q's
    slots at ``slot0 + q * slot_stride`` and its control words at ``ctl0 +
    q * ctl_stride``; the held ranks ``[rank0, rank0 + held)``; ``sys`` the
    kernels' scope."""

    _fields_ = [("bases", ctypes.c_void_p), ("slot0", ctypes.c_ulonglong), ("ctl0", ctypes.c_ulonglong),
                ("slot_stride", ctypes.c_longlong), ("ctl_stride", ctypes.c_longlong),
                ("entry_off", ctypes.c_longlong), ("ctl_off", ctypes.c_longlong), ("rank0", ctypes.c_int),
                ("held", ctypes.c_int), ("sys", ctypes.c_int), ("pad", ctypes.c_int)]  # fmt: skip


class Regions(NamedTuple):
    """A launch's regions: ``args`` its :class:`PeerArgs` (passed by
    ``address``), ``mode`` one of :data:`MODES`, ``slots`` the "one" form's
    slots ``[W, *slot_shape]`` (None otherwise), ``keep`` what must outlive
    the launch's enqueueing (the "one" form's tensors, or the pool)."""

    args: PeerArgs
    address: int
    mode: str
    slots: Optional[torch.Tensor]
    keep: object


@functools.lru_cache(maxsize=512)
def _one_args(layout: Layout) -> Tuple[PeerArgs, int]:
    """The "one" form's arguments of a layout (every call fills in its two addresses)."""
    a = PeerArgs(None, 0, 0, layout.slot_bytes, 4 * layout.ctl_words, layout.entry_off, layout.ctl_off, 0,
                 layout.world, 0, 0)  # fmt: skip
    return a, ctypes.addressof(a)


def regions(kind: str, layout: Layout, device: torch.device, *, world=None, split: bool = False) -> Regions:
    """The receive regions of one launch of ``kind``: a :class:`Pool`'s for a
    ``world`` over processes ("procs") or ``split``; else made for the call
    ("one", module docstring)."""
    if (world is not None and world.nprocs > 1) or split:
        return pool(kind, layout, device, world=world, split=split).regions
    if layout.world > MAX_WORLD:
        raise ValueError(f"the fused kernels take worlds of at most {MAX_WORLD} ranks, got {layout.world}")
    slots = torch.empty((layout.world,) + layout.slot_shape, dtype=layout.dtype, device=device)
    ctl = torch.zeros(layout.world * layout.ctl_words, dtype=torch.int32, device=device)
    args, address = _one_args(layout)
    args.slot0, args.ctl0 = slots.data_ptr(), ctl.data_ptr()
    return Regions(args, address, "one", slots, (slots, ctl))


class Pool:
    """The regions of one key kept for the process (module docstring):
    ``regions`` the launches' :class:`Regions`; ``epoch`` the host's count of
    calls (the CPU replay's; the card keeps its own)."""

    def __init__(self, layout: Layout, device: torch.device, mode: str, world=None):
        if mode not in ("split", "procs"):
            raise ValueError(f"pool mode {mode!r}; one of ('split', 'procs')")
        if layout.world > MAX_WORLD:
            raise ValueError(f"the fused kernels take worlds of at most {MAX_WORLD} ranks, got {layout.world}")
        self.layout, self.device, self.mode = layout, device, mode
        self.size = layout.world
        self.rank0 = 0 if world is None else world.rank0
        self.held = self.size if world is None else world.held
        self.epoch = 0
        self._owned: List[int] = []
        self._opened: List[int] = []
        if device.type == "cpu":
            if mode != "split":
                raise ValueError("a CPU pool is the peer route's plain replay: mode 'split'")
            self.slots = [torch.zeros(layout.slot_shape, dtype=layout.dtype) for _ in range(self.size)]
            self.boards = [FlagBoard() for _ in range(self.size)]
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a peer pool is created outside a CUDA-graph capture: run the shapes once first")
        bases = self._regions(world if mode == "procs" else None)
        self._bases = (ctypes.c_ulonglong * (2 * self.size))(*bases, *(b + layout.ctl_base for b in bases))
        args = PeerArgs(ctypes.addressof(self._bases), 0, 0, 0, 0, layout.entry_off, layout.ctl_off, self.rank0,
                        self.held, 1, 0)  # fmt: skip
        self.regions = Regions(args, ctypes.addressof(args), mode, None, self)

    def _regions(self, world) -> List[int]:
        """cudaMalloc'd regions of the held ranks; over processes the others'
        mapped from their IPC handles, exchanged once over the group."""
        from repro_torch.kernels import build

        lib = build.library()
        own = []
        for _ in range(self.held):
            ptr = ctypes.c_ulonglong(0)
            build.check(lib.tl_peer_alloc(self.layout.nbytes, ctypes.addressof(ptr)), "peer pool alloc")
            own.append(ptr.value)
            self._owned.append(ptr.value)
        if world is None:
            return own
        import torch.distributed as dist

        handles = []
        for ptr in own:
            h = ctypes.create_string_buffer(HANDLE_BYTES)
            build.check(lib.tl_peer_handle(ptr, ctypes.addressof(h)), "peer pool IPC handle")
            handles.append(h.raw)
        every: List[Optional[list]] = [None] * world.nprocs
        dist.all_gather_object(every, handles)
        regions = []
        for p, hs in enumerate(every):
            for i, raw in enumerate(hs):
                if p == world.procs.rank:
                    regions.append(own[i])
                    continue
                ptr, h = ctypes.c_ulonglong(0), ctypes.create_string_buffer(raw, HANDLE_BYTES)
                build.check(lib.tl_peer_open(ctypes.addressof(h), ctypes.addressof(ptr)),
                            f"peer pool IPC open of process {p}'s region")  # fmt: skip
                regions.append(ptr.value)
                self._opened.append(ptr.value)
        return regions

    def copy_slots(self, out: torch.Tensor, stream: int):
        """Copy the held ranks' slots into ``out`` [held, *slot_shape] (a
        contiguous tensor of the layout's dtype on the pool's card), on
        ``stream``, after the work enqueued there."""
        from repro_torch.kernels import build

        n = self.layout.slot_bytes
        if tuple(out.shape) != (self.held,) + self.layout.slot_shape or not out.is_contiguous() or \
                out.dtype != self.layout.dtype:  # fmt: skip
            raise ValueError(f"copy_slots: expected a contiguous [{self.held}, *{self.layout.slot_shape}] "
                             f"{self.layout.dtype} tensor, got {tuple(out.shape)} {out.dtype}")  # fmt: skip
        lib = build.library()
        for i, base in enumerate(self._owned):
            build.check(lib.tl_peer_copy(out.data_ptr() + i * n, base, n, stream), "peer pool slot copy")

    def unmap(self):
        """Close the peer regions mapped into this process."""
        from repro_torch.kernels import build

        if self._opened:
            torch.cuda.synchronize(self.device)
            for ptr in self._opened:
                build.check(build.library().tl_peer_close(ptr), "peer pool IPC close")
        self._opened = []

    def free(self):
        """Free this process's own regions (after every peer has unmapped them)."""
        from repro_torch.kernels import build

        if self._owned:
            torch.cuda.synchronize(self.device)
            for ptr in self._owned:
                build.check(build.library().tl_peer_free(ptr), "peer pool free")
        self._owned = []


_POOLS: Dict[tuple, Pool] = {}


def pool(kind: str, layout: Layout, device: torch.device, *, world=None, split: bool = False) -> Pool:
    """The pool of ``kind`` for ``layout`` on ``device``: mode "procs" for a
    ``world`` over processes, else "split"; the process's, made at first use
    (over processes every process must ask for its pools in one order: the
    first ask exchanges the handles)."""
    procs = world is not None and world.nprocs > 1
    mode = "procs" if procs else "split"
    key = (kind, layout, str(device), mode, (world.rank0, world.held) if procs else None)
    hit = _POOLS.get(key)
    if hit is None:
        hit = _POOLS[key] = Pool(layout, torch.device(device), mode, world if procs else None)
    return hit


def pools() -> Dict[tuple, Pool]:
    """The pools this process holds, by key."""
    return dict(_POOLS)


def pool_bytes(device=None) -> int:
    """Device bytes of the regions this process's pools allocated (its held
    ranks' regions, on ``device`` when given): what the kept pools cost a card."""
    return sum(p.held * p.layout.nbytes for p in _POOLS.values()
               if p.device.type == "cuda" and (device is None or p.device == torch.device(device)))  # fmt: skip


def release(barrier: Optional[Callable[[], None]] = None):
    """Unmap the peer regions and free this process's own, every pool, after
    the last call on them.  Over processes ``barrier`` (a collective every
    process reaches) runs before the unmapping (a peer's last pushes have
    landed) and again before the freeing (no peer still maps them)."""
    for step in ("unmap", "free"):
        if barrier is not None:
            barrier()
        for p in _POOLS.values():
            getattr(p, step)()
    _POOLS.clear()
