"""ParallelContext — distribution configuration threaded through the model.

The port's counterpart of ``repro/parallel/context.py``.  It carries the
:class:`~repro_torch.backend.mesh.World`, the overlap mode, the
``BlockChannel`` design point and the backend:

  mode="overlap"   TileLink tile plans (compile_overlap -> plan -> executor)
  mode="baseline"  the non-overlapped baselines on either backend: every
                   collective op compiles on "eager" with
                   ``overlapped=False`` (gather then one GEMM per rank, one
                   GEMM then the reduce-scatter, on tensor cores on the
                   card; the all-gathered KV then flash attention; the MoE
                   baselines), while attention and the LM head keep the
                   backend's kernels — so on the card only the overlap
                   differs between the two modes, as in the JAX package

  backend="fused"  the hand-written Hopper kernels: AG+GEMM, GEMM+RS, flash
                   attention (also on each KV tile of the ring), the
                   grouped expert GEMM, the SSD intra-chunk
                   term and the tile-GEMM LM head; the default when the
                   world lives on a CUDA device (the JAX package pins
                   ``backend="xla"``; the port runs its kernels on the card)
  backend="eager"  the eager executor and the plain attention — the
                   default on the CPU, and the reference on the card
                   (the default on a CUDA device is "fused" in both modes)

``moe_decode_stream`` picks the MoE decode form (``nn/moe.apply_decode``):
each local expert's weights streamed once over every token with a masked
combine, instead of per-(token, k) weight gathers (the default, as in the
JAX package).

``fuse_seams`` has ``models/lm.forward`` fuse each layer's RS into the
next projection's AG over one shared ring pass (``pc.matmul_rs_ag``, the
``compile_overlap`` list form, on the eager executor whatever the
backend: the JAX package has no fused-kernel seam).  ``ep_axis`` opts the
MoE blocks into expert parallelism (``pc.a2a_moe``: the dispatch / combine
all-to-all over the world's one axis, which it must name).

``quant`` is the wire-dtype policy: ``None`` (the channel's own spec), a
:class:`~repro_torch.core.quant.QuantSpec` (pinned on the context's channel
once, so every op inherits its wire encoding), or ``"auto"`` / ``True``
(under ``tune=True`` the tuner's int8 wire axis is opened; without it the
channel's own wire runs, as in the JAX package).

With ``tune=True`` the design point is not fixed: each collective op
resolves the best ``BlockChannel`` for its own per-rank operand shapes and
dtype through ``repro_torch.tune`` over the JOINT space (comm half and
compute tile, and the wire under ``quant="auto"``), for the context's
backend: what the fused kernels of that route honour on the card, the eager
executor's blocking otherwise.  ``tune_ranker`` picks the ranker ("auto":
CUDA-event timings of the candidates on the card, the cost model on the
CPU; a cache hit never re-ranks).  The seam and the a2a pair resolve
jointly (``tune.resolve_seq`` / ``resolve_a2a``).  ``pc.channel``'s
non-tuned fields (comm resource and mode) carry into every winner.
``mode="baseline"`` tunes nothing.

The mesh: ``mesh_axes`` names the deployment's axes and their sizes,
``(("data", 32), ("model", 8))`` (``launch/mesh``), with the model axis the
world's own; by default it is the world alone, ``{"model": world.size}``
(with ``data``, ``(("data", data.size), ("model", world.size))``).  The
world emulates the ranks of one model group.  The data axes (``dp_axes``,
by default ``("pod", "data")``, those the mesh has) are the replicas of
that group: ``dp`` is their product, ``dp_spec()`` their spec entry in the
parameter specs of ``models/*.specs``.  Without ``data`` they are replicas
the planner counts (``launch/dryrun``), not ranks anything runs.  With
``data`` (a :class:`~repro_torch.backend.mesh.DistWorld`: one replica a
process, the JAX package's reduction over the tuple spec ``("pod",
"data")`` as one group over their product) they run:
the parameters are stored as each replica's block of every leaf the data
axes split (ZeRO-3: ``parallel/sharding.place_data``), and
:meth:`use_gather` gathers a layer's leaves whole over ``data`` at each use
(one all-gather per dtype; its backward reduce-scatters the gradients back
onto the blocks), as the JAX package's ``use_gather`` does;
``training.make_train_step`` all-reduces the gradients of the replicated
leaves and updates the blocks against moments that hold only those blocks;
``dp`` is then ``data.size``, and a mesh whose data axes multiply to
anything else raises.  ``launch/roofline.data_axis_bytes`` counts that
traffic from the specs.

``attn_p_bf16`` casts softmax P to bf16 before P V in the eager route's
attention (``chunked_attention``), as the JAX package does; the fused
route's wgmma kernel already takes P in bf16, and its float32 FMA route
has no bf16 P and raises (``nn/attention.apply_seq``).

Layers call ``pc.ag_matmul`` / ``pc.matmul_rs`` / ``pc.matmul_rs_ag`` /
``pc.ring_attention`` / ``pc.ag_moe`` / ``pc.a2a_moe`` / ``pc.psum`` /
``pc.pmean`` / ``pc.all_gather_seq`` on rank-stacked values.

A world over processes (``World(..., procs=)``, one process per card):
``tp`` stays the TP degree, which sets the layouts (heads, columns, rows
per rank); ``held`` and ``rank0`` are the ranks this process stores, the
leading dimension of every rank-stacked value.  Attention with a dense
MLP or a MoE block runs there (prefill, decode, the LM head, the fused
AG+GEMM / GEMM+RS on their peer route, the MoE double ring ``ag_moe`` and
the expert-parallel pair ``a2a_moe`` with their expert GEMMs on each
card's grouped kernel, the eager executors and the baselines), for
serving and for training (``training.make_train_step``: the world's
collectives carry their adjoints, the fused ops' backward runs on the
peer route, and the step sums the replicated leaves' gradients over the
processes); :meth:`single_process` refuses the rest by name
(``NotImplementedError``: ring attention and seams here, Mamba and the
encoder-decoder in ``convert.check_procs``), and ``data`` or ``tune`` with it raises
``ValueError``: ``DistWorld`` owns the default process group, and the
tuner times one process's kernels alone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.backend.mesh import DistWorld, World
from repro_torch.core.channels import BlockChannel
from repro_torch.core.compiler import BACKENDS, compile_overlap
from repro_torch.core.quant import QuantSpec
from repro_torch.parallel.sharding import use_gather

__all__ = ["ParallelContext"]


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    world: World
    mode: str = "overlap"  # "overlap" | "baseline"
    channel: Optional[BlockChannel] = None
    backend: Optional[str] = None  # "fused" | "eager"; None -> by device
    moe_decode_stream: bool = False  # MoE decode: stream each local expert once over all tokens
    fuse_seams: bool = False  # fuse layer RS -> AG seams into one ring pass (lm.forward)
    ep_axis: Optional[str] = None  # expert-parallel opt-in: the axis of the MoE dispatch / combine
    quant: Any = None  # wire-dtype policy: None, a QuantSpec (pinned on the channel), or "auto"/True
    tune: bool = False  # resolve each op's BlockChannel per (kind, shape, dtype) through repro_torch.tune
    tune_ranker: Optional[str] = None  # "auto" | "measure" | "model" (None: REPRO_TUNE_RANKER, else "auto")
    dp_axes: Tuple[str, ...] = ("pod", "data")  # the data-parallel (ZeRO) axes, those the mesh has
    mesh_axes: Any = None  # (name, size) pairs of the mesh (a mapping is taken); None: the world's axis alone
    attn_p_bf16: bool = False  # cast softmax P to bf16 before P V (eager route; the wgmma route always does)
    data: Optional[DistWorld] = None  # the data axes' transport (one replica a process); None: planned only

    def __post_init__(self):
        if self.mode not in ("overlap", "baseline"):
            raise ValueError(f"mode must be 'overlap' or 'baseline', got {self.mode!r}")
        if self.quant is True:
            object.__setattr__(self, "quant", "auto")
        if not (self.quant is None or self.quant == "auto" or isinstance(self.quant, QuantSpec)):
            raise ValueError(f"quant must be None, a QuantSpec, or 'auto'/True; got {self.quant!r}")
        if self.channel is None:
            object.__setattr__(self, "channel", BlockChannel(axis="model"))
        if isinstance(self.quant, QuantSpec) and self.channel.quant != self.quant:
            # bake the pinned spec into the channel once: every op inherits the wire encoding
            object.__setattr__(self, "channel", self.channel.with_(quant=self.quant))
        if self.backend is None:
            object.__setattr__(self, "backend", "fused" if self.world.device.type == "cuda" else "eager")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; one of {BACKENDS}")
        axis = self.channel.axis
        mesh = ((axis, self.world.size),) if self.data is None else (("data", self.data.size), (axis, self.world.size))
        mesh = mesh if self.mesh_axes is None else self.mesh_axes
        mesh = tuple((str(a), int(n)) for a, n in (mesh.items() if isinstance(mesh, dict) else mesh))
        if dict(mesh).get(axis) != self.world.size:
            raise ValueError(f"mesh {dict(mesh)} must give the {axis!r} axis the world's {self.world.size} ranks")
        object.__setattr__(self, "mesh_axes", mesh)
        object.__setattr__(self, "dp_axes", tuple(self.dp_axes))
        if self.data is not None and self.dp != self.data.size:
            raise ValueError(f"mesh {dict(mesh)} gives the data axes {self.dp_axes} {self.dp} replicas, "
                             f"the data transport has {self.data.size}")  # fmt: skip
        if self.ep_axis is not None and self.ep_axis != self.channel.axis:
            raise ValueError(f"ep_axis {self.ep_axis!r} is not the world's axis {self.channel.axis!r}")
        if self.world.nprocs > 1 and self.tune:
            raise ValueError("tune=True over a TP world of processes: the tuner times one process's kernels alone")
        if self.world.nprocs > 1 and self.data is not None:
            raise ValueError("a TP world over processes takes no data axes: the data transport owns the default "
                             "process group (TP x data across processes: ROADMAP queue 1 item 1 (d))")  # fmt: skip

    # ---- static topology ------------------------------------------------
    @property
    def tp(self) -> int:
        return self.world.size

    @property
    def held(self) -> int:
        """The ranks this process stores (``tp`` unless the world spans processes)."""
        return self.world.held

    @property
    def rank0(self) -> int:
        """The global id of this process's first rank."""
        return self.world.rank0

    def single_process(self, what: str):
        """Raise ``NotImplementedError`` for ``what`` on a world over processes
        (attention with a dense MLP or a MoE block is ported there)."""
        if self.world.nprocs > 1:
            raise NotImplementedError(
                f"{what} over a TP world of {self.world.nprocs} processes is not ported (attention with a dense "
                "MLP or a MoE block is); ROADMAP queue 1 item 1 (d): Mamba, ring attention, seams and the "
                "encoder-decoder across cards"
            )

    @property
    def mesh_shape(self) -> Dict[str, int]:
        """The mesh's axis sizes, ``{"data": 32, "model": 8}``."""
        return dict(self.mesh_axes)

    @property
    def dp(self) -> int:
        """Data replicas: the product of the data axes the mesh has (with
        ``data``, its size: ``__post_init__`` holds them equal)."""
        n = 1
        for a in self.dp_axes:
            n *= self.mesh_shape.get(a, 1)
        return n

    def dp_spec(self):
        """The spec entry of the data axes: None, one axis name, or a tuple."""
        present = tuple(a for a in self.dp_axes if a in self.mesh_shape)
        return present if len(present) > 1 else (present[0] if present else None)

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def fused(self) -> bool:
        return self.backend == "fused"

    # ---- ZeRO-3 use-time gather -----------------------------------------
    def use_gather(self, tree, spec_tree):
        """``tree`` (stored blocks of the parameter specs ``spec_tree``) for
        one use: every leaf the data axes split gathered whole over
        ``data``, one all-gather per dtype, whose backward reduce-scatters
        the gradients onto the blocks (``parallel/sharding.use_gather``);
        every other leaf as it is.  The identity without ``data``."""
        return use_gather(tree, spec_tree, self.data, self.dp_axes)

    # ---- per-rank collective ops ----------------------------------------
    def _tune_space(self):
        """The JOINT space, with the int8 wire axis opened under quant="auto"."""
        from repro_torch.tune import JOINT_SPACE

        if self.quant == "auto":
            return dataclasses.replace(JOINT_SPACE, flows=(None, "int8"))
        return JOINT_SPACE

    @property
    def _tuning(self) -> bool:
        return self.tune and self.mode == "overlap"

    def _op(self, kind, args) -> Callable:
        """``kind`` compiled for this context: on its backend when overlapped,
        the eager baselines otherwise; under ``tune=True`` with the channel
        resolved for ``args``' per-rank shapes and dtype."""
        overlapped = self.mode == "overlap"
        backend = self.backend if overlapped else "eager"
        channel = self.channel
        if self._tuning:
            from repro_torch.tune import resolve_channel

            channel = resolve_channel(
                kind, shapes=[tuple(a.shape[1:]) for a in args], world=self.world, axis=self.channel.axis,
                backend=backend, dtype=args[0].dtype, base=self.channel, ranker=self.tune_ranker,
                space=self._tune_space(),
            )  # fmt: skip
        return compile_overlap(kind, channel, world=self.world, backend=backend, overlapped=overlapped)

    def _seq(self, ops, backend: Optional[str] = None) -> Callable:
        """The list form ``ops`` for this context (on ``backend``, default the
        context's, when overlapped), tuned jointly under ``tune=True``."""
        overlapped = self.mode == "overlap"
        backend = (backend or self.backend) if overlapped else "eager"
        if self._tuning:
            return compile_overlap(
                ops, "auto", world=self.world, backend=backend, axis=self.channel.axis, tune_ranker=self.tune_ranker,
                tune_base=self.channel, tune_space=self._tune_space(),
            )  # fmt: skip
        return compile_overlap(ops, self.channel, world=self.world, backend=backend, overlapped=overlapped)

    def ag_matmul(self, x, w, **kw):
        """[W, *lead, m_loc, K] x [W, K, n_loc] -> [W, *lead, W*m_loc, n_loc]."""
        return self._op("ag_matmul", (x, w))(x, w, **kw)

    def matmul_rs(self, x, w, **kw):
        """[W, *lead, M, k_loc] x [W, k_loc, N] -> [W, *lead, M/W, N]."""
        return self._op("matmul_rs", (x, w))(x, w, **kw)

    def matmul_rs_ag(self, x, w1, w2, *, residual=None, glue=None, **kw):
        """Fused layer seam: ``matmul_rs(x, w1)`` -> ``ag_matmul(glue(residual + .), w2)``
        over one shared ring pass; returns ``(y, out)`` with ``y`` the
        residual stream (before ``glue``).  Compiled on "eager" whatever
        ``backend`` is; an incompatible seam warns once and runs unfused;
        under ``tune=True`` the tuner prices fused against unfused per shape."""
        self.single_process("the fused RS -> AG seam")
        fn = self._seq(["matmul_rs", "ag_matmul"], backend="eager")
        return fn(x, w1, w2, residual=residual, glue=glue, **kw)

    def ring_attention(self, q, k, v, **kw):
        """Sequence-parallel AG-KV + attention: q [W, B, H, s_loc or W*s_loc,
        D], k/v [W, B, Hkv, s_loc, D] -> [W, B, H, Sq, D]."""
        self.single_process("ring attention")
        return self._op("ag_attention", (q, k, v))(q, k, v, **kw)

    def ag_moe(self, x, ids, wts, w_gu, w_down, **kw):
        """Tokens [W, *lead, m_loc, d] through the AG+MoE double ring -> [W, *lead, m_loc, d]."""
        return self._op("ag_moe", (x, ids, wts, w_gu, w_down))(x, ids, wts, w_gu, w_down, **kw)

    def a2a_moe(self, x, ids, wts, w_gu, w_down, **kw):
        """Expert-parallel MoE, the overlapped dispatch / combine all-to-all:
        [W, *lead, m_loc, d] -> [W, *lead, m_loc, d].  Needs ``ep_axis``;
        ``mode="baseline"`` runs ``a2a_moe_baseline`` (the same capacity), as
        does an unfused verdict of the tuner under ``tune=True``."""
        if self.ep_axis is None:
            raise ValueError(
                "a2a_moe requires ParallelContext(ep_axis=...); expert parallelism is opt-in "
                "(use ag_moe for the TP MoE path)"
            )
        return self._seq(["a2a_dispatch", "combine_rs"])(x, ids, wts, w_gu, w_down, **kw)

    def psum(self, x):
        return self.world.psum(x)

    def pmean(self, x):
        """Mean over the ranks of a rank-stacked value."""
        return self.world.psum(x) / self.tp

    def all_gather_seq(self, x, dim: int):
        """Every rank's view of the concatenation along per-rank ``dim``
        (``lax.all_gather(..., tiled=True)`` in the JAX package)."""
        return self.world.all_gather(x, dim)
