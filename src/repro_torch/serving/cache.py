"""Slot-pool KV/SSM cache management for continuous batching.

The port of ``repro/serving/cache.py``.  A fixed pool of ``n_slots`` batch
rows over ``lm.init_caches``: each admitted request owns one row, its
per-slot length masks every attention read, and evicting a finished
sequence is just re-seating the slot.  ``reset(slot)`` zeroes the row's
cache/state — mandatory for the recurrent mamba SSM/conv state (a stale
recurrence would silently poison the next occupant; attention rows are
already excluded by the length masks, so zeroing them is hygiene).

Every cache tensor is rank-stacked with the slot on axis 1 (KV
``[W, B, kv_loc, L, hd]``, SSM ``[W, B, h_loc, N, P]``, conv
``[W, B, K-1, di_loc]``).  The pool's tensors are allocated once and only
ever written in place, so a CUDA graph that captured them stays valid.

With ``pc.data`` (D replicas, one a process) the slot axis is split over
the data axes, as the caches' specs split it in the JAX package
(``cache_specs``): replica r holds the global slots ``[r n/D, (r+1) n/D)``
as its ``n_loc = n/D`` local rows, and ``reset`` of a global slot zeroes
the owner's row and nothing elsewhere.  An ``n_slots`` that D does not
divide raises ValueError.
"""

from __future__ import annotations

import torch

from repro_torch.models import lm

__all__ = ["SlotPool"]


class SlotPool:
    """Device-resident cache pool; ``lm.decode_step`` updates ``caches`` in place."""

    def __init__(self, cfg, pc, n_slots: int, max_len: int, dtype=torch.bfloat16):
        replicas, rank = (1, 0) if pc.data is None else (pc.data.size, pc.data.rank)
        if n_slots % replicas:
            raise ValueError(f"{n_slots} slots do not divide over the {replicas} data replicas")
        self.n_slots = n_slots
        self.max_len = max_len
        self.n_loc = n_slots // replicas  # this replica's rows
        self.first = rank * self.n_loc  # the global slot of local row 0
        self.caches = lm.init_caches(cfg, pc, self.n_loc, max_len, dtype)

    def reset(self, slot: int) -> None:
        """Evict whatever occupied global ``slot``: zero its row of every
        layer's cache in place on the replica that owns it (a no-op on any
        other).  Device-side only — enqueues one fill per cache tensor, no
        host sync."""
        if not 0 <= slot < self.n_slots:
            raise IndexError(f"slot {slot} outside the pool of {self.n_slots}")
        if not self.first <= slot < self.first + self.n_loc:  # another replica's row
            return
        for cache in self.caches:
            for t in cache.values():
                t[:, slot - self.first].zero_()
