"""Deterministic, elastically-resumable data pipelines — a copy of
``repro/data/pipeline.py`` (numpy only), so the port's batches are bitwise
the JAX package's.

Both pipelines index samples by a pure function of (cursor, host shard), so:
  * resume from checkpoint = restore the integer cursor (exactly-once);
  * elastic remesh = recompute host shards from the same cursor — no sample is
    duplicated or dropped when the host set changes (the cursor is global).

``SyntheticLM`` generates a learnable in-memory corpus (token t+1 depends on
token t via a fixed random bigram table) so loss-decrease tests are meaningful.
``MemmapTokens`` streams a flat token file (np.memmap) — the production path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["SyntheticLM", "MemmapTokens", "make_pipeline"]


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    cursor: int = 0  # global step cursor (checkpointed)
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 4096)
        self._v = v
        # sparse bigram transition table -> predictable structure
        self._table = rng.integers(0, v, size=(v, 4), dtype=np.int32)

    def _sample(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng(hash((self.seed, idx)) % (2 ** 63))
        toks = np.empty(self.seq_len + 1, np.int32)
        toks[0] = rng.integers(0, self._v)
        choices = rng.integers(0, 4, size=self.seq_len)
        for t in range(self.seq_len):
            toks[t + 1] = self._table[toks[t], choices[t]]
        return toks

    def host_batch(self) -> Dict[str, np.ndarray]:
        """This host's shard of the next global batch; advances the cursor."""
        per_host = self.global_batch // self.n_hosts
        base = self.cursor * self.global_batch + self.host_id * per_host
        seqs = np.stack([self._sample(base + i) for i in range(per_host)])
        self.cursor += 1
        return {"inputs": seqs[:, :-1], "labels": seqs[:, 1:]}

    def state(self) -> dict:
        return {"cursor": self.cursor, "seed": self.seed}

    def restore(self, state: dict):
        self.cursor = int(state["cursor"])


@dataclasses.dataclass
class MemmapTokens:
    """Flat uint16/uint32 token file, deterministic strided sampling."""
    path: str
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    cursor: int = 0
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        self._mm = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n_seqs = (len(self._mm) - 1) // self.seq_len

    def host_batch(self) -> Dict[str, np.ndarray]:
        per_host = self.global_batch // self.n_hosts
        base = self.cursor * self.global_batch + self.host_id * per_host
        out_i = np.empty((per_host, self.seq_len), np.int32)
        out_l = np.empty((per_host, self.seq_len), np.int32)
        for i in range(per_host):
            s = ((base + i) % self._n_seqs) * self.seq_len
            chunk = np.asarray(self._mm[s: s + self.seq_len + 1], np.int32)
            out_i[i] = chunk[:-1]
            out_l[i] = chunk[1:]
        self.cursor += 1
        return {"inputs": out_i, "labels": out_l}

    def state(self) -> dict:
        return {"cursor": self.cursor, "path": self.path}

    def restore(self, state: dict):
        self.cursor = int(state["cursor"])


def make_pipeline(kind: str, **kw):
    if kind == "synthetic":
        return SyntheticLM(**kw)
    if kind == "memmap":
        return MemmapTokens(**kw)
    raise ValueError(kind)
