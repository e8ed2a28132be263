"""Request-level admission control for the continuous-batching engine.

The port's copy of ``repro/serving/scheduler.py`` (pure host code; the port
imports nothing of the JAX package).  A :class:`Request` is the public unit
of work; the :class:`Scheduler` seats queued requests into a fixed pool of
batch slots FIFO as slots free up, and tracks per-request host state
(prompt cursor, generated tokens, cache length) between ``engine.step()``
calls.  All device state lives in ``serving.cache.SlotPool`` — the
scheduler is pure host bookkeeping.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Request", "RequestState", "Scheduler"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: prompt tokens, budget, sampling knobs.

    ``max_new_tokens`` is exact: the engine emits exactly that many tokens
    unless ``eos_id`` is sampled first (the eos token is included in the
    output).  ``top_k == 0`` disables truncation; ``temperature <= 0`` is
    greedy.  ``seed`` gives per-request reproducible sampling independent of
    which other requests share the batch.
    """

    tokens: Sequence[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    seed: int = 0


@dataclasses.dataclass
class RequestState:
    rid: int
    request: Request
    prompt: np.ndarray  # int32 [len]
    pos: int = 0  # prompt tokens already fed through the model
    cache_len: int = 0  # tokens whose KV/state is resident in the slot
    generated: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False

    @property
    def remaining(self) -> int:
        return self.request.max_new_tokens - len(self.generated)

    @property
    def pending(self) -> Optional[int]:
        """Last sampled token whose KV is not yet in the cache."""
        if self.pos < len(self.prompt) or not self.generated:
            return None
        return self.generated[-1]


class Scheduler:
    """FIFO admission over a fixed slot pool."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.queue: Deque[int] = deque()
        self.states: Dict[int, RequestState] = {}
        self.slots: List[Optional[int]] = [None] * n_slots
        self._next_rid = 0

    def submit(self, req: Request) -> int:
        rid = self._next_rid
        self._next_rid += 1
        prompt = np.asarray(req.tokens, np.int32).reshape(-1)
        self.states[rid] = RequestState(rid, req, prompt)
        self.queue.append(rid)
        return rid

    def admit(self) -> List[int]:
        """Seat queued requests into free slots; returns the slots seated."""
        seated = []
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                rid = self.queue.popleft()
                self.states[rid].slot = i
                self.slots[i] = rid
                seated.append(i)
        return seated

    def release(self, slot: int) -> None:
        rid = self.slots[slot]
        if rid is not None:
            self.states[rid].slot = None
        self.slots[slot] = None

    def active(self):
        """(slot, state) pairs currently seated, slot order."""
        for i, rid in enumerate(self.slots):
            if rid is not None:
                yield i, self.states[rid]

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)
