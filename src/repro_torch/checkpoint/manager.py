"""Async, atomic, world-size-agnostic checkpointing — the port of
``repro/checkpoint/manager.py``.

Layout: ``<dir>/step_<N>/{manifest.json, arrays.npz}``.  Writes go to a tmp
dir renamed into place (atomic on POSIX) from a background thread, so
training is not blocked on I/O; the device -> host copy is synchronous (a
consistent snapshot).  Retention keeps the newest ``keep`` checkpoints.

Given the model's config and :class:`~repro_torch.backend.mesh.World`,
arrays are saved logically (``convert.unshard_params`` of the parameters and
of both moments), so a checkpoint restores onto another world size.  The
global layout packs some columns per rank as two halves (``wkv`` and its
bias ``bkv``: [K heads || V heads], ``w_gu``: [gate || up], ``w_xz``:
[x || z]), which
mean other columns at another world size, so a checkpoint stores each as
its two halves (``PACKED``); a world whose padded shapes differ from the
saved ones is refused (ValueError).  numpy
has no bfloat16: a bf16 leaf is stored bitwise as its int16 view, with its
dtype in the manifest.

A TP world over processes (``world.nprocs > 1``): :meth:`CheckpointManager.save`
is called by every process, which gathers each layer's held slices over
them (``convert.gather_held``) into the one-process tree; process 0
writes it, and the others return.  :meth:`CheckpointManager.restore`
reads the global arrays on every process into a one-process tree
(``convert.held_like``) and keeps this process's slices, so a checkpoint
saved at any P restores at any P.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.backend.mesh import World
from repro_torch.convert import gather_held, held_like, shard_params, unshard_params
from repro_torch.training.optimizer import tree_leaves, tree_unflatten

__all__ = ["CheckpointManager"]

_VIEWS = {torch.bfloat16: torch.int16}  # dtypes numpy lacks, stored as a same-width integer view
# columns the global layout packs per rank as [first half || second half]: matrices [D, n] and the
# kv bias [n] (a MoE block's w_gu [E, D, 2 f] is sharded by experts, not packed)
PACKED = {"wkv": ("wk", "wv"), "bkv": ("bk", "bv"), "w_gu": ("w_gate", "w_up"), "w_xz": ("w_x", "w_z")}


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return t.view(_VIEWS[t.dtype]).cpu().numpy() if t.dtype in _VIEWS else t.cpu().numpy()


def _from_host(a: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(a.copy(order="C"))
    if str(like.dtype) != dtype:
        raise TypeError(f"checkpoint leaf is {dtype}, the tree to restore into holds {like.dtype}")
    if like.dtype in _VIEWS:
        t = t.view(like.dtype)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} does not fit {tuple(like.shape)}")
    return t.to(like.device)


def _walk(node, fn):
    """Apply ``fn`` to every dict of a tree (in place), depth first."""
    if isinstance(node, dict):
        for v in node.values():
            _walk(v, fn)
        fn(node)
    elif isinstance(node, list):
        for v in node:
            _walk(v, fn)
    return node


def _unpack(glob: dict, world) -> dict:
    """Every per-rank-packed column matrix or bias of the global layout
    (``PACKED``) -> its halves [D, W * n] or [W * n] (rank-major, as one
    rank's half is stored)."""

    def split(node):
        for name, halves in PACKED.items():
            if name in node and node[name].dim() <= 2:
                w = node.pop(name)
                parts = w.reshape(w.shape[:-1] + (world.size, 2, -1)).unbind(-2)
                node.update({h: p.reshape(w.shape[:-1] + (-1,)) for h, p in zip(halves, parts)})

    return _walk(glob, split)


def _repack(glob: dict, world) -> dict:
    """Inverse of :func:`_unpack` for ``world``."""

    def join(node):
        for name, halves in PACKED.items():
            if halves[0] in node:
                a, b = (node.pop(h) for h in halves)
                node[name] = torch.stack([t.reshape(t.shape[:-1] + (world.size, -1)) for t in (a, b)], -2).reshape(
                    a.shape[:-1] + (-1,)
                )

    return _walk(glob, join)


def _logical(tree: dict, cfg, world, held=gather_held) -> dict:
    """{"params", "opt": {"mu", "nu", "step"}} rank-stacked -> logical.  A
    world over processes first takes ``held`` of each tree (its slices
    gathered, or a target shaped like them) onto the one-process world."""
    one = world if world.nprocs == 1 else World(world.size, world.device)

    def glob(t):
        return _unpack(unshard_params(held(t, cfg, world), cfg, one), one)

    opt = tree["opt"]
    return {"params": glob(tree["params"]), "opt": {"mu": glob(opt["mu"]), "nu": glob(opt["nu"]), "step": opt["step"]}}


def _stacked(glob: dict, like: dict, cfg, world) -> dict:
    """Inverse of :func:`_logical` onto ``like``'s world (keys ``like`` lacks,
    such as a tied head's copy in the moments, are dropped)."""

    def onto(g, lk):
        return {k: v for k, v in shard_params(_repack(g, world), cfg, world).items() if k in lk}

    opt = glob["opt"]
    return {"params": onto(glob["params"], like["params"]), "opt": {"mu": onto(opt["mu"], like["opt"]["mu"]),
                                      "nu": onto(opt["nu"], like["opt"]["nu"]), "step": opt["step"]}}  # fmt: skip


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---- save -----------------------------------------------------------------
    def save(self, step: int, params, opt_state, extra: Optional[Dict[str, Any]] = None, *, cfg=None, world=None):
        """Snapshot (device -> host copy now; the I/O async).  With ``cfg``
        and ``world`` the arrays are saved logically (module docstring);
        over processes every process calls it and process 0 writes."""
        tree = {"params": params, "opt": opt_state}
        if cfg is not None:
            tree = _logical(tree, cfg, world)
            if world.nprocs > 1 and world.procs.rank != 0:
                return
        leaves = tree_leaves(tree)
        host = [_to_host(t) for t in leaves]  # sync: consistent snapshot
        meta = {"step": int(step), "extra": extra or {}, "dtypes": [str(t.dtype) for t in leaves],
                "logical": cfg is not None}  # fmt: skip

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **{f"a{i}": a for i, a in enumerate(host)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._retain()

        self.wait()
        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    # ---- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, *, cfg=None, world=None):
        """Restore into the structure, dtypes and devices of ``like``
        ({"params", "opt"}); with ``cfg`` and ``world`` (``like``'s world,
        which may differ from the one saved) from the logical arrays.
        Returns (tree, manifest)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            meta = json.load(f)
        if meta.get("logical", False) != (cfg is not None):
            raise ValueError("restore: pass cfg and world exactly when the checkpoint was saved with them")
        target = _logical(like, cfg, world, held=held_like) if cfg is not None else like
        flat_like = tree_leaves(target)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            if len(data.files) != len(flat_like):
                raise ValueError(f"checkpoint holds {len(data.files)} arrays, the tree {len(flat_like)}")
            flat = [_from_host(data[f"a{i}"], dt, lk) for i, (dt, lk) in enumerate(zip(meta["dtypes"], flat_like))]
        tree = tree_unflatten(target, flat)
        if cfg is not None:
            tree = _stacked(tree, like, cfg, world)
        return tree, meta
