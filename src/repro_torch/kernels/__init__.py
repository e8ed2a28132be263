"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, bound with ctypes).

Each wrapper module holds the kernel's launch, its plain PyTorch version and
a launch counter (``<wrapper>.launches``, bumped only where the kernel
launches).  Nothing is compiled at import: the first launch on a CUDA tensor
builds ``csrc/`` (``build.library``).
"""

from repro_torch.kernels.ag_gemm import ag_gemm, ag_gemm_plain
from repro_torch.kernels.flash_attention import chunked_attention, flash_attention, flash_attention_plain
from repro_torch.kernels.gemm_rs import gemm_rs, gemm_rs_plain
from repro_torch.kernels.matmul import matmul, matmul_plain

__all__ = [
    "ag_gemm",
    "ag_gemm_plain",
    "gemm_rs",
    "gemm_rs_plain",
    "flash_attention",
    "flash_attention_plain",
    "chunked_attention",
    "matmul",
    "matmul_plain",
    "WRAPPERS",
    "launch_counts",
    "reset_launch_counts",
]

WRAPPERS = {"matmul": matmul, "ag_gemm": ag_gemm, "gemm_rs": gemm_rs, "flash_attention": flash_attention}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
