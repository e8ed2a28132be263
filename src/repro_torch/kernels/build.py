"""Build and load the Hopper kernels: ``nvcc`` into one shared library with a
plain C interface, bound with ``ctypes``.

Every ``csrc/*.cu`` compiles to an object with its own ``nvcc`` process, all
started together, and the objects link into ``libtilelink.so``.  The build
lands in ``build/repro_torch/<hash>/`` at the repository root (listed in
``.gitignore``), keyed on a hash of every source, so a checkout builds once
at first use and a changed source rebuilds.  Nothing is built when a module
is imported: the first kernel launch on a CUDA tensor calls :func:`library`.

A build that fails raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["library", "check", "check_cuda_operands", "dtype_code", "stream", "ptxas_report", "CSRC", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
]

_LOCK = threading.Lock()
_LIB = None

# C entry points and their ctypes signatures (p = pointer, i = int, f = float);
# every pointer and the stream go as c_void_p, or ctypes would cut them to 32 bits
_SIGNATURES = {
    # dtype, x, w, out, M, N, K, bm, bn, stream
    "tl_matmul": "i" + "ppp" + "iiiii" + "p",
    # dtype, accum_bf16, x, w, out, gbuf, flags, src_tbl, dst_tbl,
    # W, nch, n_tiles, B, m_loc, m_sub, K, n_loc, bn, stream
    "tl_ag_gemm": "ii" + "ppppppp" + "iiiiiiiii" + "p",
    # dtype, acc_dtype, x, w, out, rbuf, flags, seg_tbl, dst_tbl,
    # W, nch, n_tiles, B, M, K, N, n_sub, bn, stream
    "tl_gemm_rs": "ii" + "ppppppp" + "iiiiiiiii" + "p",
    # dtype, q, k, v, o, BH, BHkv, Sq, Sk, D, scale, causal, window, stream
    "tl_flash_attention": "i" + "pppp" + "iiiii" + "f" + "ii" + "p",
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("repro_torch: nvcc not found (PATH or /usr/local/cuda/bin); cannot build the kernels")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256()
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    nvcc = _nvcc()
    cu, _ = _sources()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir))
    procs = []
    for src in cu:
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed, logs = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out.decode(errors='replace')}")
        if proc.returncode != 0:
            failed.append(src.name)
    (work / "nvcc.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"repro_torch: nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp_lib = work / "libtilelink.so"
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp_lib)]
    res = subprocess.run(link + [str(o) for _, o, _ in procs], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"repro_torch: link failed:\n{res.stdout}\n{res.stderr}")
    lib = out_dir / "libtilelink.so"
    shutil.copy(work / "nvcc.log", out_dir / "nvcc.log")
    os.replace(tmp_lib, lib)  # atomic: a concurrent loader sees all or nothing
    shutil.rmtree(work, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out_dir = _ROOT / "build" / "repro_torch" / _digest()
        lib_path = out_dir / "libtilelink.so"
        if not lib_path.exists():
            lib_path = _build(out_dir)
        lib = ctypes.CDLL(str(lib_path))
        for name, sig in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [_CTYPES[c] for c in sig]
        lib.tl_error_string.restype = ctypes.c_char_p
        lib.tl_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
        return lib


def check(rc: int, what: str):
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = _LIB.tl_error_string(rc).decode() if _LIB is not None else str(rc)
        raise RuntimeError(f"repro_torch kernel {what}: CUDA error {rc}: {msg}")


def dtype_code(dtype: torch.dtype) -> int:
    """The C entry points' dtype code: 0 = float32, 1 = bfloat16."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"repro_torch kernels take float32 or bfloat16, got {dtype}")
    return _DTYPE_CODES[dtype]


def stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_operands(what: str, *ts: torch.Tensor):
    """Raise unless every operand is a contiguous float32/bfloat16 CUDA tensor
    of one dtype on one device (what every kernel takes)."""
    dev, dt = ts[0].device, ts[0].dtype
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: operands must all be on one CUDA device, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{what}: operands on {dev} and {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{what}: operand dtypes differ ({dt} vs {t.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    dtype_code(dt)


def ptxas_report() -> str:
    """The compiler's per-kernel register / shared-memory report of the build."""
    log = _ROOT / "build" / "repro_torch" / _digest() / "nvcc.log"
    return log.read_text() if log.exists() else ""
