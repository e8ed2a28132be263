"""Fault tolerance and straggler detection for long runs — the port of
``repro/runtime/resilience.py``.

  * ``StepWatchdog`` tracks per-step wall time and flags a straggler when a
    step exceeds ``threshold`` x the running median.
  * ``ElasticMesh`` factorizes the devices present into (pod, data, model)
    as the reference does (shrinking data first, then model by powers of
    two); ``world`` builds the tensor-parallel :class:`World` of the plan's
    model factor.  The port has no data-parallel axis yet, so the pod and
    data factors are the replicas such an axis would run.
  * ``run_resilient`` is the restart loop: run the train loop, on failure
    rebuild the state (restoring the latest checkpoint, which is
    world-size-agnostic) and continue.

The data pipeline's global cursor (``data/pipeline.py``) keeps sample
delivery exactly-once across restarts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from repro_torch.backend.mesh import World

__all__ = ["StepWatchdog", "ElasticMesh", "run_resilient"]


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
