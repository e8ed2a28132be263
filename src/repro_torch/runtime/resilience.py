"""Fault tolerance and straggler detection for long runs — the port of
``repro/runtime/resilience.py``.

  * ``StepWatchdog`` tracks per-step wall time and flags a straggler when a
    step exceeds ``threshold`` x the running median.
  * ``ElasticMesh`` factorizes the devices present into (pod, data, model)
    as the reference does (shrinking data first, then model by powers of
    two); ``world`` builds the tensor-parallel :class:`World` of the plan's
    model factor, and ``build`` the plan's mesh, that world and, given the
    data replicas' :class:`~repro_torch.backend.mesh.DistWorld` (one
    process per pod x data replica), the ParallelContext that runs them.
  * ``run_resilient`` is the restart loop: run the train loop, on failure
    rebuild the state (restoring the latest checkpoint, which is
    world-size-agnostic) and continue.

The data pipeline's global cursor (``data/pipeline.py``) keeps sample
delivery exactly-once across restarts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np

from repro_torch.backend.mesh import World

__all__ = ["StepWatchdog", "ElasticMesh", "ElasticBuild", "run_resilient"]


class ElasticBuild(NamedTuple):
    """What :meth:`ElasticMesh.build` returns: the plan's ``mesh``
    (``launch/mesh.Mesh``, axes (pod, data, model)), the ``usable`` device
    count, the tensor-parallel ``world`` and, with a data transport, the
    ``context`` over the data factors (else None)."""

    mesh: object
    usable: int
    world: World
    context: object


@dataclasses.dataclass
class StepWatchdog:
    threshold: float = 3.0
    window: int = 32
    min_samples: int = 5
    _times: List[float] = dataclasses.field(default_factory=list)
    _last_start: Optional[float] = None
    stragglers: int = 0

    def start(self):
        self._last_start = time.monotonic()

    def stop(self) -> bool:
        """Record the step; True if this step was a straggler."""
        dt = time.monotonic() - self._last_start
        flagged = False
        if len(self._times) >= self.min_samples:
            med = float(np.median(self._times[-self.window :]))
            if dt > self.threshold * med:
                self.stragglers += 1
                flagged = True
        self._times.append(dt)
        return flagged

    def median(self) -> float:
        return float(np.median(self._times)) if self._times else 0.0


class ElasticMesh:
    """Factorize a (possibly reduced) device count into mesh axes."""

    def __init__(self, target_model: int = 16, axis_names=("pod", "data", "model")):
        self.target_model = target_model
        self.axis_names = axis_names

    def plan(self, n_devices: int) -> dict:
        """Largest usable (pod, data, model) with model as close to the
        target as possible (shrinks data first, then model by powers of two)."""
        model = self.target_model
        while model > 1 and n_devices % model:
            model //= 2
        rest = n_devices // model
        pod = 2 if rest % 2 == 0 and rest >= 2 else 1  # pods only if the rest splits evenly in 2
        data = rest // pod
        return {"pod": pod, "data": data, "model": model}

    def world(self, n_devices: int, device=None) -> World:
        """The tensor-parallel world of the plan's model factor on ``device``."""
        return World(self.plan(n_devices)["model"], device)

    def build(self, n_devices: int, device=None, data=None) -> ElasticBuild:
        """The (pod, data, model) mesh of :meth:`plan`, its usable device
        count (the reference's ``build``), the model factor's world on
        ``device`` and, with ``data`` (a DistWorld of pod x data replicas),
        a ParallelContext over the mesh that runs the data factors."""
        from repro_torch.launch.mesh import Mesh, make_dev_mesh

        p = self.plan(n_devices)
        dev = make_dev_mesh(p["model"], p["pod"] * p["data"])
        rates = dict(dev.link_bw)
        mesh = Mesh(tuple((a, p[a]) for a in self.axis_names), tuple((a, rates[a]) for a in self.axis_names))
        world = mesh.world(device)
        ctx = None
        if data is not None:
            from repro_torch.parallel.context import ParallelContext

            ctx = ParallelContext(world=world, mesh_axes=mesh.axes, data=data)
        return ElasticBuild(mesh, p["pod"] * p["data"] * p["model"], world, ctx)


def run_resilient(make_state: Callable, run: Callable, *, max_failures: int = 3, on_failure: Optional[Callable] = None):
    """Restart loop.

    make_state() -> state   (builds the world, restores the latest checkpoint)
    run(state)   -> result  (train loop; raises on a failure)
    """
    failures = 0
    while True:
        state = make_state()
        try:
            return run(state)
        except Exception as e:  # noqa: BLE001 — any device / host failure
            failures += 1
            if failures > max_failures:
                raise
            if on_failure is not None:
                on_failure(e, failures)
