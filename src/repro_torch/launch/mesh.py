"""Mesh descriptions — the port's counterpart of ``repro/launch/mesh.py``.

The JAX package builds ``jax.sharding.Mesh`` objects over (placeholder)
devices.  The port's world emulates the ranks of one model-parallel group
on one card, so a mesh here is a description: its axes and sizes, and the
link rate of each axis (``launch/roofline``).  ``Mesh.world()`` builds the
:class:`~repro_torch.backend.mesh.World` of its ``"model"`` axis and
``Mesh.context()`` the :class:`~repro_torch.parallel.context.ParallelContext`
that plans over the whole mesh (``launch/dryrun``).

``make_production_mesh`` describes an H100 deployment with the reference's
chip counts and axis names: 256 GPUs as ``(data=32, model=8)``, and 512 as
``(pod=2, data=32, model=8)``.  The reference's TPU mesh is ``(16, 16)``;
here the ``"model"`` axis is 8, one HGX node's NVLink domain (8 H100 SXM
joined by NVSwitch), because a tensor-parallel ring of 16 would cross
InfiniBand between nodes on every step.  The data and pod axes run over
one 400 Gb/s NDR port per GPU.

``make_dev_mesh`` is the card itself: ``n_model`` ranks emulated on it,
the model axis at the emulated world's peer-store rate (``HW["link_bw"]``),
and ``n_data`` data replicas, one process each (``Mesh.context(data=)``
takes their :class:`~repro_torch.backend.mesh.DistWorld`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.backend.mesh import World
from repro_torch.launch.roofline import HW

__all__ = ["Mesh", "make_production_mesh", "make_dev_mesh", "PRODUCTION_MODEL"]

PRODUCTION_MODEL = 8  # the model axis of a production mesh: one HGX node's NVLink domain
PRODUCTION_CHIPS = 256  # the reference's single-pod chip count (512 with the pod axis)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh: ``axes`` the (name, size) pairs in order, ``link_bw``
    each axis's link rate in B/s per direction."""

    axes: Tuple[Tuple[str, int], ...]
    link_bw: Tuple[Tuple[str, float], ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(n for _, n in self.axes)

    def world(self, device=None) -> World:
        """The emulated world of the ``"model"`` axis on ``device`` (the card
        unless said: ``backend.target.resolve_device``)."""
        return World(self.shape["model"], device)

    def context(self, device=None, **kw):
        """A ParallelContext over this mesh (its world on ``device``); the
        data axes are the mesh's own unless ``dp_axes`` is given.  ``data=``
        a DistWorld runs them (its size must be their product)."""
        from repro_torch.parallel.context import ParallelContext

        kw.setdefault("dp_axes", tuple(a for a in ("pod", "data") if a in self.shape))
        return ParallelContext(world=self.world(device), mesh_axes=self.axes, **kw)


def _rates(names) -> Tuple[Tuple[str, float], ...]:
    return tuple((a, HW["axis_bw"][a]) for a in names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """256 H100s as (data=32, model=8); 512 as (pod=2, data=32, model=8)."""
    data = PRODUCTION_CHIPS // PRODUCTION_MODEL
    axes = (("data", data), ("model", PRODUCTION_MODEL))
    if multi_pod:
        axes = (("pod", 2),) + axes
    return Mesh(axes, _rates(a for a, _ in axes))


def make_dev_mesh(n_model: int = 4, n_data: Optional[int] = None) -> Mesh:
    """The card: (pod=1, data=n_data, model=n_model), the model axis at the
    emulated peer-store rate; ``n_data`` (default 1) is the number of
    replica processes."""
    n_data = 1 if n_data is None else int(n_data)
    if n_data < 1:
        raise ValueError(f"make_dev_mesh: n_data must be >= 1, got {n_data}")
    axes = (("pod", 1), ("data", n_data), ("model", int(n_model)))
    return Mesh(axes, (("pod", HW["axis_bw"]["pod"]), ("data", HW["axis_bw"]["data"]), ("model", HW["link_bw"])))
