"""The launch surface — the port's counterpart of ``repro/backend/lowering.py``.

The reference routes every Pallas kernel through this module's
``pallas_call`` (the only path from its kernels to ``pltpu``).  The port's
kernels are CUDA C++ built by ``kernels/build`` and launched by their
wrappers, so that module is the launch surface; this one names each of the
reference's functions beside its counterpart and re-exports those (no
second copy of their code, and ``ctypes.CDLL`` stays in ``kernels/build``):

  reference (JAX / Pallas)          port (PyTorch / CUDA)
  --------------------------------  ------------------------------------------------
  compiler_params                   NVCC_FLAGS: ``-gencode arch=compute_90a,
                                    code=sm_90a -O3 ...``, one ``nvcc`` per source
  pallas_call                       library(): the built ``libtilelink.so``; each
                                    wrapper calls its C entry point (``tl_<kernel>``)
                                    on PyTorch's current stream (``stream``) and
                                    raises on its return code (``check``)
  interpret= / resolve_interpret    none: a CPU tensor runs the wrapper's plain
                                    version, a CUDA tensor the kernel (no fallback)
  BlockSpec / prefetch_grid_spec    ROUTES (the route by dtype) and the wrappers'
                                    operand rules: check_cuda_operands,
                                    check_tma_operands (16-byte TMA strides),
                                    weight_operands (a plain or packed weight)
  vmem_scratch / smem_scratch       shared memory declared in the kernels; scratch
                                    slots and flags allocated by the wrappers
  dma_semaphore / regular_semaphore int32 flags in device memory (zeroed per launch)
  semaphore_signal / semaphore_wait the tile primitives: ``producer_tile_notify`` /
                                    ``consumer_tile_wait`` in
                                    ``kernels/csrc/tile_sync.cuh``, ``core/primitives``
                                    on the host
  make_async_copy                   TMA boxes into the shared-memory ring
                                    (``kernels/csrc/wgmma_tile.cuh``)
  make_async_remote_copy            ``tile_push_data``: stores into the peer rank's
                                    slot (the ranks share one card)
  pl, ANY                           none (no Pallas frontend)
"""

from repro_torch.kernels.build import (
    NVCC_FLAGS,
    ROUTES,
    check,
    check_cuda_operands,
    check_tma_operands,
    dtype_code,
    library,
    stream,
    weight_operands,
)

__all__ = [
    "NVCC_FLAGS",
    "ROUTES",
    "check",
    "check_cuda_operands",
    "check_tma_operands",
    "dtype_code",
    "library",
    "stream",
    "weight_operands",
]
