"""The kernels' public names — the port's counterpart of ``repro/kernels/ops.py``.

The reference's names and what stands for each here:

  reference                           port
  ----------------------------------  ----------------------------------------------
  matmul, flash_attention,            the same names (``kernels/matmul``,
  grouped_matmul, ssd_chunked,        ``flash_attention``, ``grouped_matmul``,
  ssd_intra_chunk                     ``mamba_ssd``)
  ag_gemm_shard (one rank's shard,    ag_gemm: every rank at once on the world-stacked
  inside shard_map)                   operands ``[W, *lead, m_loc, K]`` (``World``
                                      runs the ranks; there is no ``shard_map``)
  gemm_rs_shard                       gemm_rs, the same way: ``[W, *lead, M, k_loc]``
  auto_interpret (interpret mode      none: the tensor's device chooses.  A CPU tensor
  without a TPU)                      runs the kernel's plain version, a CUDA tensor
                                      launches the kernel or raises; there is no
                                      fallback from one to the other

The float32 oracles of every kernel are ``kernels/ref``.
"""

from repro_torch.kernels.ag_gemm import ag_gemm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gemm_rs import gemm_rs
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.kernels.mamba_ssd import ssd_chunked, ssd_intra_chunk
from repro_torch.kernels.matmul import matmul

__all__ = ["matmul", "flash_attention", "grouped_matmul", "ag_gemm", "gemm_rs", "ssd_chunked", "ssd_intra_chunk"]
