"""Compatibility surface — the port's counterpart of ``repro/compat.py``.

The reference re-exports ``shard_map`` and ``make_mesh`` from its backend
and names ``jax.tree_util``'s tree functions.  Here:

  * ``tree_map``, ``tree_leaves``, ``tree_flatten``, ``tree_unflatten`` over
    ``torch.utils._pytree``, with JAX's semantics where torch's differ:
    ``None`` is an empty subtree (torch counts it as a leaf:
    ``tree_leaves([1, None, {"a": 2}])`` is ``[1, 2]`` here and in JAX,
    ``[1, None, 2]`` in torch), and a dict's children go in sorted key
    order (torch keeps insertion order); ``tree_unflatten`` takes
    ``(treedef, leaves)``, as JAX's does;
  * ``make_dev_mesh`` (``launch/mesh``), the port's mesh constructor, and
    ``World``, the emulated model axis it builds;
  * ``shard_map`` has no counterpart: a ``World`` runs every rank of its
    axis at once on rank-stacked tensors, so there is no per-rank program
    to map;
  * ``all_gather_single`` / ``reduce_scatter_single``: the flat-tensor
    collectives of ``torch.distributed`` under the names each torch has.
    torch 2.13 names them ``all_gather_single`` / ``reduce_scatter_single``
    and warns that the older ``all_gather_into_tensor`` /
    ``reduce_scatter_tensor`` are deprecated; older torch has only those.
    The choice is made once, by probing ``torch.distributed`` for the new
    names (``backend/mesh.DistWorld`` calls these).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple

import torch.distributed as _dist
import torch.utils._pytree as _pt

from repro_torch.backend.mesh import World
from repro_torch.launch.mesh import make_dev_mesh

__all__ = ["make_dev_mesh", "World", "tree_map", "tree_leaves", "tree_flatten", "tree_unflatten", "TreeDef",
           "all_gather_single", "reduce_scatter_single"]  # fmt: skip

# (output, input, group=None, async_op=False) in both namings; (output, input, op, group, async_op) for the RS
all_gather_single = getattr(_dist, "all_gather_single", None) or getattr(_dist, "all_gather_into_tensor", None)
reduce_scatter_single = getattr(_dist, "reduce_scatter_single", None) or getattr(_dist, "reduce_scatter_tensor", None)


class TreeDef(NamedTuple):
    """A tree's structure: torch's spec of the key-sorted tree, and which of
    its leaves are ``None`` (empty subtrees, no leaf of their own)."""

    spec: Any
    none: Tuple[bool, ...]


def _sorted(tree):
    """The tree with every plain dict rebuilt in sorted key order (JAX's)."""
    if type(tree) is dict:
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_sorted(v) for v in tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a namedtuple
        return type(tree)(*(_sorted(v) for v in tree))
    return tree


def tree_flatten(tree) -> Tuple[List[Any], TreeDef]:
    """(leaves, treedef): the leaves in JAX's order, ``None`` left out."""
    leaves, spec = _pt.tree_flatten(_sorted(tree))
    none = tuple(leaf is None for leaf in leaves)
    return [leaf for leaf in leaves if leaf is not None], TreeDef(spec, none)


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of ``treedef`` with ``leaves`` in its leaf positions."""
    it = iter(leaves)
    full = [None if is_none else next(it) for is_none in treedef.none]
    return _pt.tree_unflatten(full, treedef.spec)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (each of ``tree``'s structure, else ValueError); ``None`` stays ``None``."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError(f"tree_map: a tree of another structure: {r_def.spec} vs {treedef.spec}")
        others.append(r_leaves)
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])
