"""Feature detection for the installed PyTorch and CUDA toolchain (probed
once, at import) — the port's counterpart of ``repro/backend/features.py``.

Every probe is a ``hasattr``, an ``importlib.util.find_spec`` or a path
check, never a version comparison; ``TORCH_VERSION`` is kept for reports
only.  The rest of the port keys off these names: ``kernels/build`` takes
``nvcc`` and triton's bundled ``cuobjdump`` from here.

Importing this module does not initialise CUDA (``torch.cuda.is_available``
asks the driver for a device count and creates no context).  What needs a
device or a subprocess — the card's capability, SM count and opt-in shared
memory (``backend/hw.probe``), ``nvcc --version`` — is read by
:func:`describe`, on request.
"""

from __future__ import annotations

import importlib.util
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

__all__ = [
    "TORCH_VERSION",
    "HAS_CUDA",
    "NVCC",
    "CUTLASS_INCLUDE",
    "TRITON_DIR",
    "HAS_TRITON",
    "HAS_FLOAT8",
    "HAS_CUDA_GRAPHS",
    "HAS_FLOP_COUNTER",
    "nvcc",
    "describe",
]

TORCH_VERSION = torch.__version__
HAS_CUDA = torch.cuda.is_available()


def _find_nvcc() -> Optional[str]:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    return str(cand) if cand.exists() else None


def _find_cutlass() -> Optional[str]:
    cand = Path("/usr/local/cutlass/include")
    return str(cand) if (cand / "cutlass" / "cutlass.h").exists() else None


def _find_triton() -> Optional[Path]:
    spec = importlib.util.find_spec("triton")
    return Path(spec.origin).parent if spec is not None and spec.origin else None


NVCC = _find_nvcc()  # the CUDA compiler (PATH, else /usr/local/cuda/bin), or None
CUTLASS_INCLUDE = _find_cutlass()  # CUTLASS's headers, or None (the kernels include none of them)
TRITON_DIR = _find_triton()  # the triton package's directory, or None
HAS_TRITON = TRITON_DIR is not None  # importable (the kernels are CUDA C++; triton carries a cuobjdump)
HAS_FLOAT8 = hasattr(torch, "float8_e4m3fn")  # core/quant's fp8 wire
HAS_CUDA_GRAPHS = hasattr(torch.cuda, "CUDAGraph") and hasattr(torch.cuda, "graph")  # the engine's capture
HAS_FLOP_COUNTER = importlib.util.find_spec("torch.utils.flop_counter") is not None  # launch/dryrun's FLOPs


def nvcc() -> str:
    """The path of ``nvcc``; raises if the toolkit is missing (the kernels cannot build)."""
    if NVCC is None:
        raise RuntimeError("repro_torch: nvcc not found (PATH or /usr/local/cuda/bin); cannot build the kernels")
    return NVCC


def _nvcc_version() -> Optional[str]:
    if NVCC is None:
        return None
    res = subprocess.run([NVCC, "--version"], capture_output=True, text=True, check=False)
    lines = [line for line in res.stdout.splitlines() if line.strip()]
    return lines[-1] if lines else None


def describe() -> dict:
    """Every probe, plus what needs a device or a subprocess: the card's name,
    capability, SM count and opt-in shared memory per block (CUDA device 0,
    when there is one) and the last line of ``nvcc --version``."""
    out = {
        "torch_version": TORCH_VERSION,
        "torch_cuda": torch.version.cuda,
        "has_cuda": HAS_CUDA,
        "nvcc": NVCC,
        "nvcc_version": _nvcc_version(),
        "cutlass_include": CUTLASS_INCLUDE,
        "has_triton": HAS_TRITON,
        "has_float8": HAS_FLOAT8,
        "has_cuda_graphs": HAS_CUDA_GRAPHS,
        "has_flop_counter": HAS_FLOP_COUNTER,
        "device": None,
    }
    if HAS_CUDA:
        from repro_torch.backend.hw import probe

        info = probe(torch.device("cuda", 0))
        out["device"] = {
            "name": info.name,
            "capability": list(info.capability),
            "sm_count": info.sm_count,
            "smem_per_block_optin": info.smem_per_block_optin,
        }
    return out
