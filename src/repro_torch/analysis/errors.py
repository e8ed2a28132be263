"""Structured diagnostics of the port's plan verifier.

The port's copy of ``repro/analysis/errors.py``.  This module is the bottom
of the analysis layering and imports nothing of ``repro_torch.core``:
``core/plan.py`` imports :class:`PlanVerificationError` (its ``PlanError``
is this class), so the table derivations, ``build_plan``'s verification and
the tuner's candidate probes raise the same structured diagnosis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["PlanVerificationError", "VerificationReport"]


class PlanVerificationError(ValueError):
    """A plan, its baked schedule tables or a launch's work items violate a
    static invariant.

    A ``ValueError``, as the plan errors before it were; carries the failing
    coordinate so the tuner, the executors and the CLI report one diagnosis.
    """

    def __init__(
        self,
        message: str,
        *,
        check: str,
        kind: Optional[str] = None,
        order: Optional[str] = None,
        world: Optional[int] = None,
        step: Optional[int] = None,
        rank: Optional[int] = None,
        channel: Optional[int] = None,
        op_index: Optional[int] = None,
    ):
        self.check = check
        self.kind = kind
        self.order = order
        self.world = world
        self.step = step
        self.rank = rank
        self.channel = channel
        # position of the failing op inside a two-op SeqPlan (None for a
        # single-op plan): a seam failure names the half that broke
        self.op_index = op_index
        self.raw_message = message
        where = ", ".join(
            f"{name}={val!r}"
            for name, val in (
                ("kind", kind),
                ("order", order),
                ("world", world),
                ("channel", channel),
                ("step", step),
                ("rank", rank),
                ("op_index", op_index),
            )
            if val is not None
        )
        super().__init__(f"[{check}] {message}" + (f" ({where})" if where else ""))

    def with_op_index(self, op_index: int) -> "PlanVerificationError":
        """The same diagnosis, tagged with its position in the sequence."""
        return PlanVerificationError(
            self.raw_message,
            check=self.check,
            kind=self.kind,
            order=self.order,
            world=self.world,
            step=self.step,
            rank=self.rank,
            channel=self.channel,
            op_index=op_index,
        )

    def __reduce__(self):  # pickles across processes (the keyword-only fields are not in ``args``)
        fields = ("check", "kind", "order", "world", "step", "rank", "channel", "op_index")
        return _rebuild, (self.raw_message, {f: getattr(self, f) for f in fields})


def _rebuild(message: str, fields: dict) -> PlanVerificationError:
    return PlanVerificationError(message, **fields)


@dataclasses.dataclass(frozen=True)
class VerificationReport:
    """What the verifier proved about one plan.

    ``effective_channels`` is the channel count the verified tables use;
    where ``mapping.effective_channels`` clamped a request,
    ``requested_channels`` keeps the request.
    """

    kind: str
    order: str
    world: int
    flow: str
    effective_channels: int
    requested_channels: Optional[int] = None
    passes: Tuple[str, ...] = ()
    checks: int = 0  # individual assertions evaluated
    events: int = 0  # protocol ops simulated (0 if the pass did not run)

    @property
    def clamped(self) -> bool:
        return self.requested_channels is not None and self.requested_channels != self.effective_channels

    def summary(self) -> str:
        ch = str(self.effective_channels)
        if self.clamped:
            ch += f" (requested {self.requested_channels})"
        return (
            f"{self.kind:<13} {self.order:<10} world={self.world:<3} C={ch:<18} "
            f"passes={'+'.join(self.passes)} checks={self.checks} events={self.events}"
        )
