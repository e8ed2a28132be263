// Device-side tile synchronisation: the Hopper form of notify / wait / push.
//
// Replaces src/repro/core/primitives.py (producer_tile_notify,
// consumer_tile_wait, make_tile_push, tile_push_data) over
// src/repro/backend/lowering.py (DMA semaphores, remote async copies).  On
// the TPU a tile travels by a remote DMA whose completion signals the
// receiver's semaphore.  Here the tensor-parallel ranks are emulated on one
// card and every rank's buffers live in one allocation, so:
//
//   * a peer push is plain global stores into the receiving rank's slot
//     (tl_push_rows, 16-byte vectors where the rows allow);
//   * notify is every thread's __threadfence(), a block barrier, then one
//     st.release.gpu of the flag (release: the slot's stores are visible at
//     GPU scope before the flag);
//   * wait is one thread spinning on ld.acquire.gpu, a fence, then a block
//     barrier; consumers read the slot with ld.global.cg (L2), so a stale L1
//     line cannot shadow the peer's stores.
//
// A block spins on flags other blocks set, so the fused kernels launch with
// cudaLaunchCooperativeKernel, which guarantees every block is resident or
// refuses the launch.  Flags are zeroed on the stream before each launch.
#pragma once

#include "tile_gemm.cuh"

__device__ __forceinline__ int tl_ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void tl_st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// consumer_tile_wait: the whole block waits until *flag >= target.
__device__ __forceinline__ void tl_wait_flag(const int* flag, int target) {
  if (threadIdx.x == 0) {
    while (tl_ld_acquire(flag) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// producer_tile_notify: publish this block's prior stores, then set the flag.
__device__ __forceinline__ void tl_notify(int* flag, int value) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) tl_st_release(flag, value);
}

__device__ __forceinline__ void tl_copy_elem(float* d, const float* s) { *d = __ldcg(s); }
__device__ __forceinline__ void tl_copy_elem(__nv_bfloat16* d, const __nv_bfloat16* s) {
  *reinterpret_cast<unsigned short*>(d) = __ldcg(reinterpret_cast<const unsigned short*>(s));
}

// tile_push_data: copy `rows` rows of `cols` elements from A (grouped rows)
// into the contiguous [rows][cols] slot at dst.  All threads of the block call it.
template <typename T>
__device__ void tl_push_rows(T* dst, const RowsA<T>& A, int rows, int cols) {
  const bool vec = (cols * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(A.base) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(dst) % 16) == 0 && (A.lda * sizeof(T)) % 16 == 0 &&
                   (A.gstride * sizeof(T)) % 16 == 0;
  if (vec) {
    const int vpr = static_cast<int>(cols * sizeof(T) / 16);
    const long total = static_cast<long>(rows) * vpr;
    for (long e = threadIdx.x; e < total; e += blockDim.x) {
      const int i = static_cast<int>(e / vpr);
      const int q = static_cast<int>(e % vpr);
      const uint4* s = reinterpret_cast<const uint4*>(A.row(i)) + q;
      uint4* d = reinterpret_cast<uint4*>(dst + static_cast<long>(i) * cols) + q;
      *d = __ldcg(s);
    }
  } else {
    const long total = static_cast<long>(rows) * cols;
    for (long e = threadIdx.x; e < total; e += blockDim.x) {
      const int i = static_cast<int>(e / cols);
      const int q = static_cast<int>(e % cols);
      tl_copy_elem(dst + e, A.row(i) + q);
    }
  }
}
