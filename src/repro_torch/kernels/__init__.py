"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``, bound with ctypes).

Each wrapper module holds the kernel's launch, its plain PyTorch version and
a launch counter (``<wrapper>.launches``, bumped only where the kernel
launches).  Nothing is compiled at import: the first launch on a CUDA tensor
builds ``csrc/`` (``build.library``).  ``ref`` holds every kernel's float32
oracle, independent of the kernels' schedules; ``ops`` the reference's
public names.
"""

from repro_torch.kernels.ag_gemm import ag_gemm, ag_gemm_plain
from repro_torch.kernels.flash_attention import chunked_attention, flash_attention, flash_attention_plain
from repro_torch.kernels.gemm_rs import gemm_rs, gemm_rs_plain
from repro_torch.kernels.grouped_matmul import grouped_matmul, grouped_matmul_plain
from repro_torch.kernels.mamba_ssd import ssd_chunked, ssd_intra_chunk, ssd_intra_chunk_plain
from repro_torch.kernels.matmul import matmul, matmul_plain
from repro_torch.kernels import ops, ref

__all__ = [
    "ag_gemm",
    "ag_gemm_plain",
    "gemm_rs",
    "gemm_rs_plain",
    "flash_attention",
    "flash_attention_plain",
    "chunked_attention",
    "grouped_matmul",
    "grouped_matmul_plain",
    "matmul",
    "matmul_plain",
    "ssd_chunked",
    "ssd_intra_chunk",
    "ssd_intra_chunk_plain",
    "ops",
    "ref",
    "WRAPPERS",
    "launch_counts",
    "reset_launch_counts",
    "prebuild",
]

WRAPPERS = {
    "matmul": matmul,
    "ag_gemm": ag_gemm,
    "gemm_rs": gemm_rs,
    "flash_attention": flash_attention,
    "grouped_matmul": grouped_matmul,
    "ssd_intra_chunk": ssd_intra_chunk,
}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0
    ag_gemm.packed_launches = gemm_rs.packed_launches = 0


def prebuild():
    """Build (or find) and load the kernel library now, launching nothing: a
    launcher of several processes calls it first, so that they load one
    library instead of each building it (``launch/train.run_replicas``)."""
    from repro_torch.kernels import build

    build.library()
