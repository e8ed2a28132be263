"""Sharding specs — the port's counterpart of ``repro/parallel/sharding.py``.

The JAX package describes how a global array lies on the mesh with a
``PartitionSpec``: one entry per dimension, each ``None`` (replicated), a
mesh axis name, or a tuple of axis names (split over their product).  The
port's :class:`Spec` is the same thing for the port's own leaves:

  * a rank-stacked leaf ``[W, ...]`` (``convert.shard_params``) has
    ``"model"`` on its rank dimension 0, and the data axes (``pod`` /
    ``data``: ZeRO-style storage of the parameters and the optimizer
    moments) on the dimension the JAX package's spec names for them;
  * a leaf stored once (a norm, the router, the LM head) names the axes
    its global dimensions are split by on a real mesh, ``"model"``
    included; on the emulated world it is one tensor.

:func:`stacked` turns a global spec into the rank-stacked leaf's, and
:func:`place` moves a global tensor into that layout (the ``"model"`` dim
split over the world's ranks).  The data axes are a second transport,
``ParallelContext.data``: :func:`place_data` keeps this replica's block of
a leaf along the one dim its spec names for them (ZeRO-3 storage of the
parameters and the optimizer moments) and :func:`gather_data` is its
inverse, an all-gather over them; a leaf whose spec names no data axis is
replicated.  :func:`use_gather` gathers the blocks of one use's leaves,
one all-gather per dtype, and its backward reduce-scatters the gradients
onto the blocks (the JAX package's ``ParallelContext.use_gather``).  Over a
:class:`~repro_torch.backend.mesh.DistWorld` (one replica a process) a
block is this process's own; over an emulated
:class:`~repro_torch.backend.mesh.World` of the data axes it is every
replica's, stacked on a new dim 0 (the in-process form the tests hold the
same code with).  :func:`per_device_bytes` is what one
device of a mesh stores of a leaf (each dim divided by the product of its
axes' sizes, rounded up: the JAX package requires each to divide evenly, so
the two agree wherever the reference accepts the spec).  A mesh is
described by its axis sizes, ``{"data": 32, "model": 8}`` (a mapping or
the ``(name, size)`` pairs of ``launch/mesh.Mesh.axes``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

__all__ = ["Spec", "is_spec", "axes_of", "stacked", "only_axes", "shard_shape", "per_device_bytes",
           "Sharding", "shardings_of", "place", "map_specs", "tree_bytes", "DATA_AXES", "data_dim", "place_data",
           "gather_data", "use_gather"]  # fmt: skip

DATA_AXES = ("pod", "data")  # the data-parallel axes by default (``ParallelContext.dp_axes``)


class Spec(tuple):
    """One entry per dimension of a leaf: ``None``, an axis name or a tuple
    of axis names (``jax.sharding.PartitionSpec``'s form).  ``Spec()`` is a
    scalar's."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(repr(e) for e in self) + ")"


def is_spec(v) -> bool:
    return isinstance(v, Spec)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def axes_of(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis that splits some dimension of the leaf, in order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def _mesh(mesh_axes) -> Dict[str, int]:
    return dict(mesh_axes.items() if isinstance(mesh_axes, Mapping) else mesh_axes)


def stacked(spec: Spec, axis: str = "model") -> Spec:
    """The spec of a global leaf's rank-stacked layout: ``axis`` moves to a
    new leading dim, every other entry stays on its dim.  A spec without
    ``axis`` gets a replicated leading dim."""
    rest = []
    for e in spec:
        kept = tuple(a for a in _entry_axes(e) if a != axis)
        rest.append(None if not kept else (kept[0] if len(kept) == 1 else kept))
    return Spec(axis if axis in axes_of(spec) else None, *rest)


def only_axes(spec: Spec, keep: Sequence[str]) -> Spec:
    """``spec`` with every axis not in ``keep`` dropped (the JAX package's
    ``manual_only``)."""
    out = []
    for e in spec:
        kept = tuple(a for a in _entry_axes(e) if a in keep)
        out.append(None if not kept else (kept[0] if len(kept) == 1 else kept))
    return Spec(*out)


def shard_shape(shape: Sequence[int], spec: Spec, mesh_axes) -> Tuple[int, ...]:
    """One device's block of a leaf of ``shape``: each dim divided by the
    product of its axes' sizes (rounded up); axes the mesh lacks count 1."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} has more entries than the leaf's {len(shape)} dims")
    sizes = _mesh(mesh_axes)
    out = []
    for i, n in enumerate(shape):
        parts = math.prod(sizes.get(a, 1) for a in _entry_axes(spec[i])) if i < len(spec) else 1
        out.append(-(-int(n) // parts))
    return tuple(out)


def per_device_bytes(leaf_shape: Sequence[int], dtype: torch.dtype, spec: Spec, mesh_axes) -> int:
    """Bytes one device of the mesh stores of the leaf."""
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    return math.prod(shard_shape(leaf_shape, spec, mesh_axes)) * itemsize


class Sharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s role)."""

    def __init__(self, mesh_axes, spec: Spec):
        self.mesh = _mesh(mesh_axes)
        self.spec = spec

    def __repr__(self) -> str:
        return f"Sharding({self.mesh}, {self.spec!r})"

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return shard_shape(shape, self.spec, self.mesh)

    def nbytes(self, shape: Sequence[int], dtype: torch.dtype) -> int:
        return per_device_bytes(shape, dtype, self.spec, self.mesh)


def map_specs(fn: Callable, spec_tree, *rest):
    """``fn(spec, *leaves)`` over a spec tree (dicts and lists, :class:`Spec`
    leaves) and trees of its structure; a None spec leaf maps to None."""
    if is_spec(spec_tree):
        return fn(spec_tree, *rest)
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest)) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return [map_specs(fn, v, *(r[i] for r in rest)) for i, v in enumerate(spec_tree)]
    raise TypeError(f"map_specs: not a spec tree node: {spec_tree!r}")


def shardings_of(mesh_axes, spec_tree):
    """Map a tree of :class:`Spec` to :class:`Sharding` on the mesh."""
    return map_specs(lambda s: Sharding(mesh_axes, s), spec_tree)


def tree_bytes(tree, spec_tree, mesh_axes) -> int:
    """Per-device bytes of a tree of tensors (meta or real) by its specs."""
    total = []
    map_specs(lambda s, t: total.append(per_device_bytes(t.shape, t.dtype, s, mesh_axes)), spec_tree, tree)
    return sum(total)


def place(x: torch.Tensor, spec: Spec, world, axis: str = "model") -> torch.Tensor:
    """A global tensor in its rank-stacked layout by ``spec``: the dim that
    ``axis`` splits becomes ``[W, ...]`` (``world.shard``), the layout of
    ``stacked(spec)``; a leaf ``axis`` does not split is stored once, as it
    is.  The data axes are :func:`place_data`'s."""
    dims = [i for i, e in enumerate(spec) if axis in _entry_axes(e)]
    if not dims:
        return x.to(world.device)
    if len(dims) > 1:
        raise ValueError(f"place: {axis!r} splits more than one dim of {spec!r}")
    return world.shard(x.to(world.device), dims[0])



def data_dim(spec: Spec, dp_axes: Sequence[str] = DATA_AXES) -> Optional[int]:
    """The dim of a stored leaf that its spec splits over the data axes
    ``dp_axes``, or None (the leaf is replicated over them)."""
    dims = [i for i, e in enumerate(spec) if any(a in dp_axes for a in _entry_axes(e))]
    if len(dims) > 1:
        raise ValueError(f"the data axes {tuple(dp_axes)} split more than one dim of {spec!r}")
    return dims[0] if dims else None


def place_data(x: torch.Tensor, spec: Spec, data, dp_axes: Sequence[str] = DATA_AXES) -> torch.Tensor:
    """This replica's block of a stored leaf along :func:`data_dim` over the
    data transport ``data`` (``data.shard``: a dim the replicas do not divide
    raises, as the JAX package's placement does); the leaf itself where the
    spec names no data axis."""
    d = data_dim(spec, dp_axes)
    return x if d is None else data.shard(x, d)


def gather_data(x: torch.Tensor, spec: Spec, data, dp_axes: Sequence[str] = DATA_AXES) -> torch.Tensor:
    """Inverse of :func:`place_data`: the replicas' blocks gathered over ``data``."""
    d = data_dim(spec, dp_axes)
    return x if d is None else data.unshard(x, d)


# ---- ZeRO-3 use-time gathering ----------------------------------------------------------------
#
# A bucket is the leaves of one use that share a dtype.  Replica r's part of the bucket is its blocks, each moved to
# [b_d, ...] (data dim first) and flattened, concatenated: [total].  The all-gather of the parts is [n, total] in rank
# order, so a leaf's slice [n, k] holds its n blocks, which reshape into the whole leaf; the backward takes the whole
# gradients apart into the same [n, total] rows and reduce-scatters them.  Over an in-process World of the data axes
# every tensor carries the replicas on a leading dim ("lead").


def _lead(data) -> int:
    """1 where ``data`` is an in-process World (its values stacked on dim 0), 0 over a DistWorld."""
    return 0 if hasattr(data, "rank") else 1


def _block_part(b: torch.Tensor, d: int, lead: int) -> torch.Tensor:
    """A block [*lead, pre, b_d, post] as its flat part [*lead, b_d * ...] (data dim first)."""
    return b.movedim(lead + d, lead).reshape(b.shape[:lead] + (-1,))


def _part_block(p: torch.Tensor, d: int, shape, lead: int) -> torch.Tensor:
    """Inverse of :func:`_block_part` for a block of per-replica ``shape``."""
    moved = (shape[d],) + tuple(shape[:d]) + tuple(shape[d + 1 :])
    return p.reshape(p.shape[:lead] + moved).movedim(lead, lead + d).contiguous()


def _whole_rows(g: torch.Tensor, d: int, n: int, lead: int) -> torch.Tensor:
    """A whole leaf [*lead, pre, N, post] as the rows [*lead, n, N / n * ...] of its n blocks."""
    shape = g.shape[lead:]
    split = g.reshape(g.shape[:lead] + tuple(shape[:d]) + (n, shape[d] // n) + tuple(shape[d + 1 :]))
    return split.movedim(lead + d, lead).movedim(lead + d + 1, lead + 1).reshape(g.shape[:lead] + (n, -1))


def _rows_whole(rows: torch.Tensor, d: int, shape, n: int, lead: int) -> torch.Tensor:
    """Inverse of :func:`_whole_rows`: rows [*lead, n, k] as the whole leaf of per-replica ``shape``
    (contiguous)."""
    b_d = shape[d] // n
    x = rows.reshape(rows.shape[:lead] + (n, b_d) + tuple(shape[:d]) + tuple(shape[d + 1 :]))
    x = x.movedim(lead + 1, lead + 1 + d).movedim(lead, lead + d)
    return x.reshape(rows.shape[:lead] + tuple(shape)).contiguous()


def _buckets(dtypes) -> Dict[torch.dtype, list]:
    """Indices by dtype, in order of first appearance (the same collective order on every replica)."""
    out: Dict[torch.dtype, list] = {}
    for i, dt in enumerate(dtypes):
        out.setdefault(dt, []).append(i)
    return out


def _gather_whole(blocks: Sequence[torch.Tensor], dims: Sequence[int], data) -> list:
    """The whole leaves of the replicas' ``blocks`` (each split along its
    ``dims`` entry), one ``data.all_gather`` per dtype."""
    n, lead = data.size, _lead(data)
    out = [None] * len(blocks)
    for idx in _buckets([b.dtype for b in blocks]).values():
        flat = data.all_gather(torch.cat([_block_part(blocks[i], dims[i], lead) for i in idx], dim=-1), 0)
        rows = flat.reshape(flat.shape[:lead] + (n, -1)).split([math.prod(blocks[i].shape[lead:]) for i in idx], dim=-1)
        for i, r in zip(idx, rows):
            shape = list(blocks[i].shape[lead:])
            shape[dims[i]] *= n
            out[i] = _rows_whole(r, dims[i], shape, n, lead)
    return out


def _scatter_blocks(wholes: Sequence[torch.Tensor], dims: Sequence[int], data) -> list:
    """Each replica's block of the replicas' sum of ``wholes`` along its
    ``dims`` entry, one ``data.reduce_scatter`` per dtype (the transpose of
    :func:`_gather_whole`)."""
    n, lead = data.size, _lead(data)
    out = [None] * len(wholes)
    for idx in _buckets([g.dtype for g in wholes]).values():
        rows = [_whole_rows(wholes[i], dims[i], n, lead) for i in idx]
        cat = torch.cat(rows, dim=-1)
        part = data.reduce_scatter(cat.reshape(cat.shape[:lead] + (-1,)), 0)
        for i, p in zip(idx, part.split([r.shape[-1] for r in rows], dim=-1)):
            shape = list(wholes[i].shape[lead:])
            shape[dims[i]] //= n
            out[i] = _part_block(p, dims[i], shape, lead)
    return out


class _UseGather(torch.autograd.Function):
    """One use's gather: the blocks of the leaves the data axes split ->
    their whole leaves (:func:`_gather_whole`); the backward reduce-scatters
    the whole gradients onto the blocks (:func:`_scatter_blocks`).  A
    recomputing backward (``torch.utils.checkpoint``) runs the forward, and
    so the gather, again."""

    @staticmethod
    def forward(ctx, data, dims, *blocks):
        ctx.data, ctx.dims = data, dims
        return tuple(_gather_whole(blocks, dims, data))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *_scatter_blocks(grads, ctx.dims, ctx.data))


def _spec_pairs(spec_tree, tree, out: list):
    """(spec, leaf) of a tree and its spec tree, in the tree's order; a node
    whose keys or length differ from its spec's raises."""
    if is_spec(spec_tree):
        out.append((spec_tree, tree))
    elif isinstance(spec_tree, dict):
        if set(spec_tree) != set(tree):
            raise ValueError(f"use_gather: keys {sorted(tree)} against the specs' {sorted(spec_tree)}")
        for k in tree:
            _spec_pairs(spec_tree[k], tree[k], out)
    elif isinstance(spec_tree, (list, tuple)):
        if len(spec_tree) != len(tree):
            raise ValueError(f"use_gather: {len(tree)} subtrees against {len(spec_tree)} specs")
        for s, t in zip(spec_tree, tree):
            _spec_pairs(s, t, out)
    elif spec_tree is not None:
        raise TypeError(f"use_gather: not a spec tree node: {spec_tree!r}")
    return out


def _rebuilt(spec_tree, tree, leaves):
    """``tree``'s structure (its key order) holding the next of ``leaves`` at each spec."""
    if is_spec(spec_tree):
        return next(leaves)
    if isinstance(spec_tree, dict):
        return {k: _rebuilt(spec_tree[k], tree[k], leaves) for k in tree}
    if isinstance(spec_tree, (list, tuple)):
        return [_rebuilt(s, t, leaves) for s, t in zip(spec_tree, tree)]
    return None


def use_gather(tree, spec_tree, data, dp_axes: Sequence[str] = DATA_AXES):
    """``tree`` (stored blocks) for one use: every leaf whose spec splits a
    dim over the data axes gathered whole over ``data`` in one
    :class:`_UseGather` (one all-gather per dtype, whose backward is one
    reduce-scatter per dtype), every other leaf as it is.  ``data``: a
    :class:`~repro_torch.backend.mesh.DistWorld`, or an in-process World of
    the data axes (blocks and whole leaves stacked on dim 0, each replica's
    view); the tree itself when ``data`` is None."""
    if data is None:
        return tree
    pairs = _spec_pairs(spec_tree, tree, [])
    split = [(i, data_dim(s, dp_axes)) for i, (s, _) in enumerate(pairs) if data_dim(s, dp_axes) is not None]
    leaves = [t for _, t in pairs]
    if split:
        whole = _UseGather.apply(data, tuple(d for _, d in split), *(leaves[i] for i, _ in split))
        for (i, _), w in zip(split, whole):
            leaves[i] = w
    return _rebuilt(spec_tree, tree, iter(leaves))
