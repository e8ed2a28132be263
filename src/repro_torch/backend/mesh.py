"""The ``World`` — tensor-parallel ranks, replacing the ``shard_map`` region.

The JAX package runs per-shard code inside ``shard_map`` over a mesh axis
(``repro/backend/mesh.py``).  The port runs a world of ``size`` ranks
emulated on one device:

  * every per-rank value carries a leading rank dimension ``[W, ...]`` in one
    allocation, and per-rank code is written batched over it;
  * a value replicated over the ranks (decode activations) is stored once,
    without the rank dimension;
  * a permute is an index on dim 0, ``psum`` a sum over dim 0;
  * the fused kernels take rank-stacked operands and run all ranks in one
    launch, a "peer store" being a store into another rank's slice.

The methods below are the transport interface the executors use.
:class:`DistWorld` implements the same methods over ``torch.distributed``
for the data axes: one process per data replica, each holding its own
tensors (no rank dimension).

The TP world may also span ``P`` processes (``World(size, device,
procs=dist)``, ``dist`` a :class:`DistWorld` of the P processes): process
``p`` holds the contiguous block of ``held = size / P`` ranks ``[rank0,
rank0 + held)``, ``rank0 = p * held``, and every rank-stacked value it
sees is ``[held, ...]``.  ``size`` stays the TP degree (layouts, plans,
the gathered extents); ``held`` / ``ranks`` name what this process stores.
Each collective gives this process the held ranks' slices of what the
one-process World gives for the same global data: ``shard`` keeps the held
chunks (no traffic), ``unshard`` / ``all_gather`` gather the processes'
blocks, ``permute`` turns the pairs that cross processes into send / recv
(pairs inside the process stay index copies), ``psum`` and
``reduce_scatter`` reduce over the processes.  ``psum`` (the decode
path's, on a few rows) gathers every rank's partial and sums them in rank
order, the one-process World's ``sum(0)`` bitwise (W times an
all-reduce's payload).  ``reduce_scatter`` (the non-overlapped baseline's,
on whole activations) sums the held ranks locally, then the library's
reduce-scatter reduces the processes (NCCL on the card, gloo on the CPU:
one path), in its own order: equal to the one-process World's within
float rounding, not bitwise.  The counter records what the one-process World records, per rank.
Over processes every collective is an autograd Function whose backward is
its adjoint over the same transport, so that autograd gives what it gives
at P = 1, where the collectives are indexing and sums: a value every
process computes whole (a ``psum`` or ``unshard`` result, the input of
``shard``) gets its whole gradient on every process, and a rank-stacked
value its held ranks' slices.  ``permute``'s adjoint is the inverse
permute (sums where two destinations read one source, synchronous), ``all_gather``'s a
reduce-scatter (each rank used its copy), ``reduce_scatter``'s an
all-gather, ``psum``'s the replicated gradient on every held rank,
``unshard``'s this process's slice and ``shard``'s the all-gather of the
held chunks' gradients.  The adjoints are not counted (the one-process
World's backward counts nothing either).
A permute may complete lazily (:meth:`World.permute_start`, which the
overlap executors use): over processes its send / recv batch is issued
and not waited on, and the returned :class:`Landing` waits where the
landed tile is first read.  Under NCCL a wait makes the current stream
wait for the transfer, so a wait taken at once (:meth:`World.permute`)
would queue the step's compute, issued after the next step's permute,
behind that transfer; under gloo the wait blocks the host.  Every process
issues its transfers in one program order, so the NCCL calls match.  On
one process a permute is an index copy, already landed.
The fused kernels' peer route (``kernels/peer.py``) writes tiles straight
into the peer cards' buffers; ``dist`` carries only their handles and the
eager collectives.  With ``P = 1`` (``procs=None``) the world is the
emulated one, unchanged.

``World.counting()`` turns on a :class:`CommCounter` for the transport:
every ``permute`` / ``psum`` / ``all_gather`` / ``reduce_scatter`` then
records its payload bytes per rank, by kind, with the group size, and a
permute also by link direction (the sign of dst - src voted over its first
pairs, as ``repro/launch/roofline.parse_collective_bytes`` classifies a
collective-permute).  ``launch/roofline.collective_bytes`` weights them
into per-device link bytes.  The counter reads shapes only (no host sync,
so it may stay on inside a CUDA-graph capture), and with none enabled a
call pays one attribute test.

:class:`DistWorld` joins ``size`` processes in a ``torch.distributed``
group through a file store (``init_method="file://..."``: no fixed port, so
test processes that run at once do not collide).  Its backend is named by
the caller, never switched: ``"gloo"`` (CPU tensors; on the card, the data
replicas of one H100, where NCCL refuses two ranks on one device) or
``"nccl"`` (one process per GPU).  Which tensors each collective hands the
backend is its *staging*, also the caller's: ``"direct"`` (the tensor as it
lies) or ``"host"`` (copied through pinned host memory and back, the bytes
counted in ``CommCounter.staged``).  gloo in torch 2.11 takes CUDA tensors
for its all-reduce, reduce-scatter and all-gather but not for send / recv
(on an H100 the peer sees its connection closed, or the process aborts),
so :data:`GLOO_CUDA_STAGING` stages the permute alone.  Scalars that
steer a step (a loss, a mask count, a squared norm) are reduced with
``control=True``: they are not payload, which ``launch/roofline`` models,
and no counter records them.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
import time
from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.backend.target import resolve_device

__all__ = ["World", "DistWorld", "Landing", "CommCounter", "KINDS", "STAGINGS", "GLOO_CUDA_STAGING", "permute_direction"]

KINDS = ("permute", "psum", "all_gather", "reduce_scatter")  # the transport's collectives
STAGINGS = ("direct", "host")  # how a DistWorld collective hands its tensors to the backend
# gloo on CUDA tensors (torch 2.11, probed on an H100): send / recv do not take them, the rest do
GLOO_CUDA_STAGING = {"permute": "host", "psum": "direct", "all_gather": "direct", "reduce_scatter": "direct"}
DIST_TIMEOUT_S = 600  # a DistWorld collective that waits longer on a peer raises
VOTES = 8  # pairs a permute's direction is voted over (the JAX package's parser reads the first 8)


def permute_direction(pairs: Sequence[Tuple[int, int]]) -> int:
    """+1 or -1: the link direction of a permute, the sign of dst - src
    voted over its first :data:`VOTES` pairs (ties count as +1)."""
    votes = sum(1 if dst > src else -1 for src, dst in list(pairs)[:VOTES])
    return 1 if votes >= 0 else -1


class CommCounter:
    """Payload bytes per rank that a world's transport moved since the last
    :meth:`reset`.

    ``payload[kind][g]``: the bytes of one rank's payload summed over the
    calls of ``kind`` over a group of ``g`` ranks (a permute's and a psum's
    input, an all-gather's gathered output, a reduce-scatter's scattered
    output: the payloads the JAX package's HLO parser reads);
    ``permute_dirs[+1 | -1]``: the permutes' payload by link direction;
    ``staged[kind]``: the payload a :class:`DistWorld` copied through host
    memory; ``seconds``: with ``timed``, a DistWorld's host time inside its
    collectives (the device drained before and after each, so the time is
    the transport's; without ``timed`` nothing is drained and it stays 0)."""

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.reset()

    def reset(self):
        self.payload: Dict[str, Dict[int, float]] = {k: defaultdict(float) for k in KINDS}
        self.permute_dirs: Dict[int, float] = defaultdict(float)
        self.staged: Dict[str, float] = defaultdict(float)
        self.seconds = 0.0

    def add(self, kind: str, nbytes: float, group: int, direction: Optional[int] = None):
        self.payload[kind][group] += nbytes
        if direction is not None:
            self.permute_dirs[direction] += nbytes


class Landing:
    """A permute's result whose transfers may still be in flight:
    :meth:`wait` returns the tensor once they have landed (under NCCL the
    current stream waits for them; under gloo the host does).  ``keep``
    holds the tensors the transfers read until then."""

    __slots__ = ("tensor", "works", "keep")

    def __init__(self, tensor: torch.Tensor, works: Sequence = (), keep: Sequence = ()):
        self.tensor, self.works, self.keep = tensor, list(works), list(keep)

    def wait(self) -> torch.Tensor:
        for work in self.works:
            work.wait()
        self.works, self.keep = [], []
        return self.tensor


def _rank_bytes(xs: torch.Tensor, ranks: int) -> int:
    """One rank's share of a rank-stacked value's bytes (shape only)."""
    return xs.numel() // ranks * xs.element_size()


class World:
    """``size`` tensor-parallel ranks on ``device``: all of them emulated in
    this process, or (``procs``, a :class:`DistWorld` of P processes) the
    block ``ranks`` of ``held = size / P`` of them (module docstring)."""

    def __init__(self, size: int, device: Optional[Union[str, torch.device]] = None, *,
                 procs: Optional["DistWorld"] = None):  # fmt: skip
        if int(size) < 1:
            raise ValueError(f"world size must be >= 1, got {size}")
        self.size = int(size)
        self.device = resolve_device(device)
        self.counter: Optional[CommCounter] = None
        self.procs = procs
        nproc = 1 if procs is None else procs.size
        if self.size % nproc:
            raise ValueError(f"{nproc} processes do not divide a world of {self.size} ranks")
        self.held = self.size // nproc
        self.rank0 = 0 if procs is None else procs.rank * self.held
        if procs is not None and procs.device != self.device:
            raise ValueError(f"World on {self.device} over processes on {procs.device}")

    def __repr__(self) -> str:
        if self.procs is None:
            return f"World(size={self.size}, device={self.device})"
        return f"World(size={self.size}, device={self.device}, ranks={self.rank0}..{self.rank0 + self.held - 1} " \
               f"of process {self.procs.rank}/{self.procs.size})"

    @property
    def nprocs(self) -> int:
        """Processes the world spans (1: every rank emulated here)."""
        return 1 if self.procs is None else self.procs.size

    @property
    def ranks(self) -> range:
        """The global ids of the ranks this process holds."""
        return range(self.rank0, self.rank0 + self.held)

    def local(self, per_rank: Sequence):
        """The held ranks' entries of a per-rank sequence over all ``size`` ranks."""
        return tuple(per_rank[self.ranks.start : self.ranks.stop])

    @contextlib.contextmanager
    def counting(self, counter: Optional[CommCounter] = None):
        """Record the transport's payloads into ``counter`` (a new
        :class:`CommCounter` by default) inside; yields the counter."""
        counter = CommCounter() if counter is None else counter
        before, self.counter = self.counter, counter
        try:
            yield counter
        finally:
            self.counter = before

    # ---- layout: global <-> rank-stacked --------------------------------
    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Split a global tensor along ``dim`` into ``[held, ...]`` (contiguous;
        every rank's chunk, ``[W, ...]``, in one process)."""
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {self.size} ranks")
        if self.procs is not None:
            return _Shard.apply(x, self, dim)
        return torch.stack(torch.chunk(x, self.size, dim=dim)).contiguous()

    def unshard(self, xs: torch.Tensor, dim: int) -> torch.Tensor:
        """Inverse of :meth:`shard`: concatenate the ranks' values along the
        per-rank dimension ``dim`` (over processes: gathered first)."""
        self._check(xs)
        return torch.cat(list(self.gather_ranks(xs).unbind(0)), dim=dim)

    def gather_ranks(self, xs: torch.Tensor) -> torch.Tensor:
        """Every rank's value, ``[W, ...]`` (the processes' blocks gathered;
        its gradient, which every process holds whole, sliced back)."""
        return xs if self.procs is None else _Gather.apply(xs, self)

    # ---- collectives -----------------------------------------------------
    def permute(self, xs: torch.Tensor, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``out[dst] = xs[src]`` for every (src, dst) pair (a ppermute; a
        rank no pair names as destination takes rank 0's value), landed.

        The index tensor is built once per (pairs, device) and cached, so a
        repeated permute issues no host-to-device copy (and a CUDA-graph
        capture may replay one whose index was built before it).  Over
        processes the pairs inside this process stay index copies and the
        others become one batch of send / recv."""
        return self.permute_start(xs, pairs).wait()

    def permute_start(self, xs: torch.Tensor, pairs: Sequence[Tuple[int, int]]) -> Landing:
        """:meth:`permute` issued and not waited on (module docstring): its
        :class:`Landing` waits for the transfers where the result is first
        read.  On one process the result is an index copy, already landed."""
        self._check(xs)
        if self.counter is not None:
            self.counter.add("permute", _rank_bytes(xs, self.held), self.size, permute_direction(pairs))
        order = [0] * self.size
        for src, dst in pairs:
            order[dst] = src
        if self.procs is None:
            return Landing(xs[_perm_index(tuple(order), xs.device)])
        pending = []
        out = _Permute.apply(xs, self, tuple(order), pending)
        return Landing(out, *pending)

    def _permute_procs(self, xs: torch.Tensor, order: Tuple[int, ...], pending: list):
        """``out[dst] = xs[order[dst]]`` over the processes: the pairs inside
        this process index copies, the others one batch of send / recv,
        issued and not waited on: ``pending`` takes the batch's works and
        the tensors it reads."""
        lo, hi = self.rank0, self.rank0 + self.held
        out = torch.empty_like(xs, memory_format=torch.contiguous_format)
        sends, recvs = [], []
        for dst, src in enumerate(order):  # every process walks the pairs in this one order
            if lo <= dst < hi and lo <= src < hi:
                out[dst - lo].copy_(xs[src - lo])
            elif lo <= src < hi:
                sends.append((xs[src - lo].contiguous(), dst // self.held))
            elif lo <= dst < hi:
                recvs.append((out[dst - lo], src // self.held))
        works = self.procs.exchange(sends, recvs, wait=False)
        if works:
            pending.extend((works, [t for t, _ in sends]))
        return out

    def _permute_adjoint(self, g: torch.Tensor, order: Tuple[int, ...]) -> torch.Tensor:
        """The gradient of :meth:`_permute_procs`: ``gx[src] = sum of g[dst]``
        over the destinations that read ``src``, added in destination order
        (the one-process World's index backward)."""
        lo, hi = self.rank0, self.rank0 + self.held
        g = g.contiguous()
        sends, recvs, adds = [], [], []
        for dst, src in enumerate(order):
            if lo <= dst < hi and lo <= src < hi:
                adds.append((src - lo, g[dst - lo]))
            elif lo <= dst < hi:
                sends.append((g[dst - lo], src // self.held))
            elif lo <= src < hi:
                buf = torch.empty_like(g[0])
                recvs.append((buf, dst // self.held))
                adds.append((src - lo, buf))
        self.procs.exchange(sends, recvs)
        out = torch.zeros_like(g)
        for i, part in adds:
            out[i] += part
        return out

    def psum(self, xs: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks; the replicated result is stored once."""
        self._check(xs)
        if self.counter is not None:
            self.counter.add("psum", _rank_bytes(xs, self.held), self.size)
        return self.gather_ranks(xs).sum(0)

    def all_gather(self, xs: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's view of the concatenation along per-rank ``dim``
        (a broadcast view of one gathered tensor)."""
        if self.procs is not None:
            self._check(xs)
            g = _AllGather.apply(xs, self, dim)
        else:
            g = self.unshard(xs, dim)
        if self.counter is not None:
            self.counter.add("all_gather", g.numel() * g.element_size(), self.size)
        return g.unsqueeze(0).expand((self.held,) + tuple(g.shape))

    def reduce_scatter(self, xs: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum over the ranks, then each rank keeps its chunk of per-rank ``dim``."""
        self._check(xs)
        if self.counter is not None:
            self.counter.add("reduce_scatter", _rank_bytes(xs, self.held) // self.size, self.size)
        if self.procs is None:
            return self.shard(xs.sum(0), dim)
        return _ReduceScatter.apply(xs, self, dim)

    def _reduce_scatter_procs(self, xs: torch.Tensor, dim: int) -> torch.Tensor:
        """The held ranks' partials summed here, then the library's
        reduce-scatter over the processes (NCCL on the card, gloo on the CPU:
        its own order of the processes' sums, not rank order as in one
        process): this process's held chunks, ``[held, ...]``."""
        block = self.procs.reduce_scatter(xs.sum(0), dim)  # this process's held chunks, in rank order
        return torch.stack(torch.chunk(block, self.held, dim=dim)).contiguous()

    def _all_gather_procs(self, xs: torch.Tensor, dim: int) -> torch.Tensor:
        """The held ranks' values ``[held, ...]`` joined along ``dim``, then
        every process's block gathered along it: the whole value."""
        block = torch.cat(list(xs.unbind(0)), dim=dim)
        return self.procs.all_gather(block.contiguous(), dim)

    def _check(self, xs: torch.Tensor):
        if xs.shape[0] != self.held:
            raise ValueError(f"expected a rank-stacked [W={self.held}, ...] value, got {tuple(xs.shape)}")


class _Gather(torch.autograd.Function):
    """Every process's block of ranks gathered, ``[W, ...]``; the gradient,
    whole on every process (what reads the gathered value is computed
    whole), sliced back to the held ranks."""

    @staticmethod
    def forward(ctx, xs, world):
        ctx.world = world
        return world.procs.all_gather(xs.contiguous(), 0)

    @staticmethod
    def backward(ctx, g):
        w = ctx.world
        return g[w.rank0 : w.rank0 + w.held], None


class _AllGather(torch.autograd.Function):
    """The whole value along per-rank ``dim`` (``World.all_gather`` before
    its broadcast to the held ranks); each rank reads its own copy, so the
    gradient is the ranks' sum: the held ranks summed here, then a
    reduce-scatter over the processes."""

    @staticmethod
    def forward(ctx, xs, world, dim):
        ctx.world, ctx.dim = world, dim
        return world._all_gather_procs(xs, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.world._reduce_scatter_procs(g.unsqueeze(0), ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """``World.reduce_scatter`` over processes; its adjoint gathers every
    rank's chunk of the gradient and gives each held rank the whole."""

    @staticmethod
    def forward(ctx, xs, world, dim):
        ctx.world, ctx.dim = world, dim
        return world._reduce_scatter_procs(xs, dim)

    @staticmethod
    def backward(ctx, g):
        w = ctx.world
        whole = w._all_gather_procs(g, ctx.dim)
        return whole.unsqueeze(0).expand((w.held,) + tuple(whole.shape)), None, None


class _Shard(torch.autograd.Function):
    """The held ranks' chunks of a value every process holds whole; its
    gradient is every rank's chunk gradient gathered (whole on every
    process)."""

    @staticmethod
    def forward(ctx, x, world, dim):
        ctx.world, ctx.dim = world, dim
        return torch.stack(world.local(torch.chunk(x, world.size, dim=dim))).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.world._all_gather_procs(g, ctx.dim), None, None


class _Permute(torch.autograd.Function):
    """``World.permute_start`` over processes (``pending`` takes the
    transfers' works; the output is read only after they are waited on);
    its adjoint the inverse permute, synchronous."""

    @staticmethod
    def forward(ctx, xs, world, order, pending):
        ctx.world, ctx.order = world, order
        return world._permute_procs(xs, order, pending)

    @staticmethod
    def backward(ctx, g):
        return ctx.world._permute_adjoint(g, ctx.order), None, None, None


@functools.lru_cache(maxsize=1024)
def _perm_index(order: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The gather index of a permute, on ``device`` (read-only, shared)."""
    return torch.tensor(order, device=device)


class DistWorld:
    """``size`` data-parallel replicas over ``torch.distributed``, this
    process being replica ``rank`` (module docstring).  The surface of
    :class:`World` on this process's own tensors: ``psum`` / ``pmax`` all-reduce,
    ``all_gather`` / ``reduce_scatter`` along a dim, ``permute`` over (src,
    dst) pairs (a rank no pair sends to gets zeros, as ``lax.ppermute``),
    ``shard`` this rank's block of a global tensor (no traffic) and
    ``unshard`` its inverse (an all-gather).  Payload bytes are counted as
    :class:`World` counts them per rank, so the two counters agree on the same
    data.  ``staging``: one of :data:`STAGINGS` for every kind, or a mapping
    kind -> staging; CPU tensors and NCCL take ``"direct"`` only (the
    default there), gloo on CUDA tensors must be told (e.g.
    :data:`GLOO_CUDA_STAGING`).  Use as a context manager, or call
    :meth:`close`, to leave the group."""

    def __init__(self, size: int, rank: int, *, init_file: str, backend: str, device=None, staging=None):
        import torch.distributed as dist

        if backend not in ("gloo", "nccl"):
            raise ValueError(f"DistWorld backend must be 'gloo' or 'nccl', got {backend!r}")
        if not 0 <= int(rank) < int(size):
            raise ValueError(f"rank {rank} outside a world of {size}")
        self.size, self.rank, self.backend = int(size), int(rank), backend
        self.device = resolve_device(device)
        self.staging = self._stagings(staging)
        self.counter: Optional[CommCounter] = None
        if dist.is_initialized():
            raise RuntimeError("DistWorld: this process already belongs to a torch.distributed group")
        if backend == "nccl":
            torch.cuda.set_device(self.device)
        dist.init_process_group(backend, init_method=f"file://{os.path.abspath(init_file)}", world_size=self.size,
                                rank=self.rank, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))  # fmt: skip

    def _stagings(self, staging) -> Dict[str, str]:
        gloo_cuda = self.backend == "gloo" and self.device.type == "cuda"
        if staging is None:
            if gloo_cuda:
                raise ValueError("DistWorld: gloo on CUDA tensors needs an explicit staging (e.g. GLOO_CUDA_STAGING)")
            staging = "direct"
        table = {k: staging for k in KINDS} if isinstance(staging, str) else dict(staging)
        if set(table) != set(KINDS) or not set(table.values()) <= set(STAGINGS):
            raise ValueError(f"DistWorld staging must give each of {KINDS} one of {STAGINGS}, got {staging!r}")
        if not gloo_cuda and "host" in table.values():
            raise ValueError(f"DistWorld: host staging is for gloo on CUDA tensors, not {self.backend} on "
                             f"{self.device.type}")  # fmt: skip
        return table

    def __repr__(self) -> str:
        return f"DistWorld(size={self.size}, rank={self.rank}, backend={self.backend}, device={self.device})"

    def close(self):
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    counting = World.counting

    # ---- staging ----------------------------------------------------------
    def _in(self, kind: str, x: torch.Tensor, copy: bool) -> torch.Tensor:
        """``x`` as the backend takes it: contiguous, in pinned host memory
        under host staging, else a copy when ``copy`` (an in-place collective)."""
        if self.staging[kind] == "host":
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x)
            if self.counter is not None:
                self.counter.staged[kind] += x.numel() * x.element_size()
            return h
        x = x.contiguous()
        return x.clone() if copy else x

    def _empty(self, kind: str, shape, like: torch.Tensor) -> torch.Tensor:
        if self.staging[kind] == "host":
            return torch.empty(shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def _out(self, kind: str, t: torch.Tensor, device: torch.device) -> torch.Tensor:
        return t.to(device) if self.staging[kind] == "host" else t

    def _count(self, kind: str, nbytes: float, control: bool, direction: Optional[int] = None):
        if self.counter is not None and not control:
            self.counter.add(kind, nbytes, self.size, direction)

    @contextlib.contextmanager
    def _timed(self):
        """Host seconds inside a collective into a ``timed`` counter: the
        device is drained before and after, so they are the transport's."""
        if self.counter is None or not self.counter.timed:
            yield
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.counter.seconds += time.perf_counter() - t0

    # ---- layout -------------------------------------------------------------
    def shard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of a global tensor along ``dim`` (a contiguous copy,
        so the block keeps nothing of ``x`` alive; no traffic)."""
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {self.size} replicas")
        return torch.chunk(x, self.size, dim=dim)[self.rank].clone(memory_format=torch.contiguous_format)

    def unshard(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Inverse of :meth:`shard`: every rank's block concatenated along ``dim``."""
        return self.all_gather(x, dim)

    # ---- collectives --------------------------------------------------------
    def psum(self, x: torch.Tensor, control: bool = False) -> torch.Tensor:
        """Sum over the replicas (a new tensor)."""
        return self._all_reduce(x, "sum", control)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the replicas (an all-reduce, counted as one)."""
        return self._all_reduce(x, "max", False)

    def _all_reduce(self, x, op: str, control: bool) -> torch.Tensor:
        import torch.distributed as dist

        self._count("psum", x.numel() * x.element_size(), control)
        with self._timed():
            buf = self._in("psum", x, copy=True)
            dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
            return self._out("psum", buf, x.device)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The replicas' tensors concatenated along ``dim``, rank order."""
        from repro_torch import compat

        self._count("all_gather", self.size * x.numel() * x.element_size(), False)
        with self._timed():
            xin = self._in("all_gather", x, copy=False).reshape(-1)
            out = self._empty("all_gather", (self.size * xin.numel(),), xin)  # flat: the ranks' tensors in order
            compat.all_gather_single(out, xin)
            out = self._out("all_gather", out, x.device)
        return torch.cat(out.reshape((self.size,) + tuple(x.shape)).unbind(0), dim=dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Sum over the replicas, then this rank keeps its block of ``dim``."""
        from repro_torch import compat

        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide over {self.size} replicas")
        self._count("reduce_scatter", x.numel() // self.size * x.element_size(), False)
        with self._timed():
            xin = self._in("reduce_scatter", x.movedim(dim, 0), copy=False)
            out = self._empty("reduce_scatter", (xin.shape[0] // self.size,) + tuple(xin.shape[1:]), xin)
            compat.reduce_scatter_single(out, xin)
            out = self._out("reduce_scatter", out, x.device)
        return out.movedim(0, dim).contiguous()

    def barrier(self):
        """Return once every process has reached it, this process's device
        drained before and after (NCCL's all-reduce returns to the host
        before it completes); not counted."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.psum(torch.zeros((1,), device=self.device), control=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def exchange(self, sends: Sequence[Tuple[torch.Tensor, int]], recvs: Sequence[Tuple[torch.Tensor, int]],
                 wait: bool = True) -> list:  # fmt: skip
        """One batch of point-to-point transfers: each ``(tensor, peer)`` of
        ``sends`` goes to process ``peer``, each ``(buffer, peer)`` of
        ``recvs`` is filled from it (in place); the transfers between two
        processes match in the order both list them.  Waited on here, or
        with ``wait=False`` issued only: the returned works are waited on
        before a ``recvs`` buffer is read or a ``sends`` tensor written.
        Not counted (the caller counts its payload); under gloo, CPU tensors
        only."""
        import torch.distributed as dist

        ops = [dist.P2POp(dist.isend, t, peer) for t, peer in sends]
        ops += [dist.P2POp(dist.irecv, t, peer) for t, peer in recvs]
        works = list(dist.batch_isend_irecv(ops)) if ops else []
        if wait:
            for req in works:
                req.wait()
            return []
        return works

    def permute(self, x: torch.Tensor, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """This rank receives the tensor of the pair's source that names it
        as destination (zeros if none does); it sends ``x`` to every
        destination it is the source of (a ppermute)."""
        import torch.distributed as dist

        pairs = [(int(a), int(b)) for a, b in pairs]
        if len({b for _, b in pairs}) != len(pairs):
            raise ValueError(f"permute: a destination appears twice in {pairs}")
        self._count("permute", x.numel() * x.element_size(), False, permute_direction(pairs))
        with self._timed():
            xin = self._in("permute", x, copy=False)
            buf = torch.zeros_like(xin)
            ops = []
            for src, dst in pairs:
                if src == dst == self.rank:
                    buf.copy_(xin)
                elif src == self.rank:
                    ops.append(dist.P2POp(dist.isend, xin, dst))
                elif dst == self.rank:
                    ops.append(dist.P2POp(dist.irecv, buf, src))
            for req in dist.batch_isend_irecv(ops) if ops else ():
                req.wait()
            return self._out("permute", buf, x.device)
