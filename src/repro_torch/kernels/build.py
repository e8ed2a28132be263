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

from repro_torch.backend import features

__all__ = [
    "library",
    "check",
    "check_cuda_operands",
    "check_tma_operands",
    "weight_operands",
    "ROUTES",
    "WGMMA_TILE",
    "dtype_code",
    "stream",
    "ptxas_report",
    "sass_report",
    "CSRC",
    "NVCC_FLAGS",
]

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

# C entry points and their ctypes signatures (p = pointer, i = int, l = long long, f = float);
# every pointer and the stream go as c_void_p, or ctypes would cut them to 32 bits
_SIGNATURES = {
    # dtype, x, w, out, info, M, N, K, bm, bn, stream
    "tl_matmul": "i" + "pppp" + "iiiii" + "p",
    # float32: accum_bf16, x, w, scale, zero (null unless packed), out, regions (kernels/peer.PeerArgs),
    # src_tbl, dst_tbl, W, nch, n_tiles, B, m_loc, m_sub, K, n_loc, bn, stream
    "tl_ag_gemm": "i" + "pppppp" + "pp" + "iiiiiiiii" + "p",
    # float32: wire_dtype, x, w, scale, zero, out, regions, seg_tbl, dst_tbl, W, nch, n_tiles, B, M, K, N, n_sub,
    # bn, stream
    "tl_gemm_rs": "i" + "pppppp" + "pp" + "iiiiiiiii" + "p",
    # bfloat16: x, w, scale, zero, out, regions, src_tbl, dst_tbl, info, W, nch, B, m_loc, m_sub, K, n_loc, stream
    "tl_ag_gemm_wgmma": "pppppp" + "ppp" + "iiiiiii" + "p",
    # bfloat16: wire_dtype, x, w, scale, zero, out, regions, seg_tbl, dst_tbl, info, W, nch, B, M, K, N, n_sub, stream
    "tl_gemm_rs_wgmma": "i" + "pppppp" + "ppp" + "iiiiiii" + "p",
    # the peer route's receive pools (csrc/peer.cu): bytes, out ptr; ptr, out handle; handle, out ptr; ptr; ptr
    "tl_peer_alloc": "l" + "p",
    "tl_peer_handle": "pp",
    "tl_peer_open": "pp",
    "tl_peer_close": "p",
    "tl_peer_free": "p",
    # dst, src, bytes, stream: a device copy on the stream (a pool's slots copied out)
    "tl_peer_copy": "ppl" + "p",
    # dtype, q, k, v, o, m, l, so, BH, BHkv, Sq, Sk, D, scale, causal, window, W, map, load, store, stream
    "tl_flash_attention": "i" + "ppppppp" + "iiiii" + "f" + "ii" + "i" + "p" + "ii" + "p",
    # dtype, out_dtype, x, w, tile_expert, out, info, n_tiles, N, K, E, bm, stream
    "tl_grouped_matmul": "ii" + "ppppp" + "iiiii" + "p",
    # bfloat16: q, k, v, o, m, l, so, BH, BHkv, Sq, Sk, D, scale, causal, window, W, map, load, store, info, stream
    "tl_flash_attention_wgmma": "ppppppp" + "iiiii" + "f" + "ii" + "i" + "p" + "ii" + "p" + "p",
    # dtype, cum, cb, xdt, y, T, Q, P, info, stream
    "tl_ssd_intra_chunk": "i" + "pppp" + "iii" + "p" + "p",
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# every GEMM-shaped kernel picks its route by dtype: bfloat16 the Hopper
# kernels (TMA + wgmma over WGMMA_TILE output tiles; its K block is 64),
# float32 the FMA kernels (exact float32 products)
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "fma"}
WGMMA_TILE = (128, 128)
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong, "f": ctypes.c_float}


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
    nvcc = features.nvcc()
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


def check_tma_operands(what: str, *ts: torch.Tensor):
    """Raise ValueError unless every operand can back a TMA tensor map: a
    16-byte aligned base and rows of a multiple of 8 bf16 elements (16 bytes)."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: the bf16 route needs 16-byte aligned operands (TMA)")
        if t.shape[-1] % 8:
            raise ValueError(
                f"{what}: the bf16 route needs K and every row width a multiple of 8 elements "
                f"(16-byte TMA strides), got a row of {t.shape[-1]}"
            )


def weight_operands(what: str, x: torch.Tensor, w) -> tuple:
    """The weight pointers of a fused GEMM launch: ``(w, scale, zero)`` with
    scale and zero 0 (null) for a plain weight, or, for a
    :class:`~repro_torch.core.quant.PackedWeight`, its int8 codes and float32
    per-column scale and zero point (zeros when symmetric; the zeros tensor
    is returned last, to be kept alive over the launch).  Checks the plain
    weight like :func:`check_cuda_operands`; a packing must be contiguous,
    on ``x``'s device, with scale / zero of shape ``[W, n]``, and on the
    bf16 route 16-byte aligned with rows of a multiple of 16 codes (TMA)."""
    from repro_torch.core.quant import PackedWeight

    if not isinstance(w, PackedWeight):
        check_cuda_operands(what, x, w)
        if ROUTES[x.dtype] == "wgmma":
            check_tma_operands(what, x, w)
        return w.data_ptr(), 0, 0, None
    check_cuda_operands(what, x)
    q, scale = w.q, w.scale
    zero = w.zero if w.zero is not None else torch.zeros_like(scale)
    want = (q.shape[0], q.shape[-1])
    for t, dt in ((q, torch.int8), (scale, torch.float32), (zero, torch.float32)):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{what}: a packed weight needs contiguous int8 codes and float32 scale / zero on {x.device}"
            )
    if q.dim() != 3 or tuple(scale.shape) != want or tuple(zero.shape) != want:
        raise ValueError(f"{what}: packed codes [W, k, n] with scale / zero [W, n], got {tuple(q.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(zero.shape)}")  # fmt: skip
    if ROUTES[x.dtype] == "wgmma":
        check_tma_operands(what, x)
        if q.data_ptr() % 16 or q.shape[-1] % 16:
            raise ValueError(
                f"{what}: the bf16 route reads packed codes by TMA: 16-byte aligned rows of a multiple of 16 codes, "
                f"got a row of {q.shape[-1]}"
            )
    return q.data_ptr(), scale.data_ptr(), zero.data_ptr(), zero


def ptxas_report() -> str:
    """The compiler's per-kernel register / shared-memory report of the build."""
    log = _ROOT / "build" / "repro_torch" / _digest() / "nvcc.log"
    return log.read_text() if log.exists() else ""


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump") or str(Path(features.nvcc()).with_name("cuobjdump"))
    if Path(found).exists():
        return found
    if features.TRITON_DIR is not None:
        cand = features.TRITON_DIR / "backends" / "nvidia" / "bin" / "cuobjdump"
        if cand.exists():
            return str(cand)
    raise RuntimeError("repro_torch: cuobjdump not found (PATH, the CUDA toolkit or triton's copy)")


def sass_report(ops=("HGMMA", "UTMALDG")) -> dict:
    """Count SASS instructions of the built library per kernel symbol:
    ``{mangled name: {op: count}}`` from ``cuobjdump -sass``.  Builds first."""
    library()
    lib = _ROOT / "build" / "repro_torch" / _digest() / "libtilelink.so"
    res = subprocess.run([_cuobjdump(), "-sass", str(lib)], capture_output=True, text=True, check=True)
    counts, fn = {}, None
    for line in res.stdout.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                if op in line:
                    counts[fn][op] += 1
    return counts
