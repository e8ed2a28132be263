"""Persistent per-target autotune cache.

The port's counterpart of ``repro/tune/cache.py``.  Results are keyed on a
**fingerprint**, everything that can change which design point wins without
the workload changing:

  world size + axis name + backend + GPU name ("cpu" on the CPU) + SM count
  + torch version + CUDA version

One JSON file per fingerprint lives under the cache directory,
``~/.cache/repro-torch-tune`` by default (``REPRO_TUNE_CACHE`` overrides,
``XDG_CACHE_HOME`` is respected), the port's own directory, so records of
the two packages never meet.  The file name is a short hash of the
fingerprint; the fingerprint itself is stored inside and compared on every
load, and a mismatch (a copied file, an edited entry) reads as an empty
cache, so the shape re-tunes.  A damaged or unreadable file reads as empty
too.  Writes are atomic (a temporary file, then ``os.replace``), merge
with what other processes stored since the last read, and a process-local
memo keeps repeated resolutions off the disk.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["cache_dir", "fingerprint", "fingerprint_digest", "load_entry", "store_entry", "clear_memo"]

_ENV_DIR = "REPRO_TUNE_CACHE"

_MEMO: Dict[Tuple[str, str, str], Dict[str, Any]] = {}  # (directory, digest, key) -> record
_FILES: Dict[Tuple[str, str], Dict[str, Any]] = {}  # (directory, digest) -> parsed payload


def cache_dir() -> str:
    """The resolved cache directory (created at the first store)."""
    env = os.environ.get(_ENV_DIR)
    if env:
        return os.path.expanduser(env)
    xdg = os.environ.get("XDG_CACHE_HOME", "~/.cache")
    return os.path.join(os.path.expanduser(xdg), "repro-torch-tune")


def fingerprint(world, *, axis: str, backend: str) -> Dict[str, Any]:
    """The identity a tuning result is valid for (module docstring)."""
    dev = world.device
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        gpu, sms = props.name, int(props.multi_processor_count)
    else:
        gpu, sms = "cpu", 0
    return {
        "world": int(world.size),
        "axis": str(axis),
        "backend": str(backend),
        "gpu": gpu,
        "sm_count": sms,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def fingerprint_digest(fp: Dict[str, Any]) -> str:
    """A short stable digest of a fingerprint (the cache file's name)."""
    blob = json.dumps(fp, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _resolve_dir(directory: Optional[str]) -> str:
    return os.path.abspath(directory or cache_dir())


def _path(digest: str, directory: str) -> str:
    return os.path.join(directory, f"{digest}.json")


def _read_file(digest: str, directory: str, fp: Dict[str, Any], *, fresh: bool = False) -> Dict[str, Any]:
    """Load and verify one cache file; a mismatch or damage reads as empty.
    ``fresh=True`` re-reads the disk past the memo (writers merge that way)."""
    if not fresh and (directory, digest) in _FILES:
        return _FILES[(directory, digest)]
    payload: Dict[str, Any] = {"fingerprint": fp, "entries": {}}
    try:
        with open(_path(digest, directory)) as fh:
            data = json.load(fh)
        if isinstance(data, dict) and data.get("fingerprint") == fp and isinstance(data.get("entries"), dict):
            payload = data
    except (OSError, ValueError):
        pass
    _FILES[(directory, digest)] = payload
    return payload


def load_entry(fp: Dict[str, Any], entry_key: str, *, directory: Optional[str] = None) -> Optional[Dict[str, Any]]:
    """The cached record for ``entry_key`` under ``fp``, else None."""
    directory = _resolve_dir(directory)
    digest = fingerprint_digest(fp)
    memo_key = (directory, digest, entry_key)
    if memo_key in _MEMO:
        return _MEMO[memo_key]
    rec = _read_file(digest, directory, fp)["entries"].get(entry_key)
    if rec is not None:
        _MEMO[memo_key] = rec
    return rec


def store_entry(fp: Dict[str, Any], entry_key: str, record: Dict[str, Any], *, directory: Optional[str] = None) -> str:
    """Persist ``record`` atomically; returns the cache file's path."""
    directory = _resolve_dir(directory)
    digest = fingerprint_digest(fp)
    path = _path(digest, directory)
    payload = _read_file(digest, directory, fp, fresh=True)
    payload["fingerprint"] = fp
    payload["entries"][entry_key] = dict(record, saved_at=time.time())
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _MEMO[(directory, digest, entry_key)] = payload["entries"][entry_key]
    _FILES[(directory, digest)] = payload
    return path


def clear_memo() -> None:
    """Drop the in-process memo (tests use this to force a disk round trip)."""
    _MEMO.clear()
    _FILES.clear()
