// The paper's tile-centric primitives (Table 3) on Hopper: notify, wait, push.
//
// Replaces src/repro/core/primitives.py (producer_tile_notify,
// consumer_tile_wait, peer_tile_notify / peer_tile_wait, tile_push_data)
// over src/repro/backend/lowering.py (DMA semaphores, remote async copies);
// core/primitives.py holds the same names over a host flag board, which the
// fused kernels' plain versions call.  On the TPU a tile travels by a remote
// DMA whose completion signals the receiver's semaphore.  Here the
// tensor-parallel ranks are emulated on one card and every rank's buffers
// live in one allocation, so:
//
//   * a peer push is plain global stores into the receiving rank's slot
//     (tile_push_data, 16-byte vectors where the rows allow);
//   * notify is a __threadfence() by every thread of the group, the group's
//     barrier, then one st.release.gpu of the flag (release: the slot's
//     stores are visible at GPU scope before the flag);
//   * wait is one thread spinning on ld.acquire.gpu, a fence, then the
//     group's barrier; consumers read the slot with ld.global.cg (L2), so a
//     stale L1 line cannot shadow the peer's stores.
//
// Each primitive comes in the forms the two routes need.  The float32 routes
// notify and wait with the whole block (__syncthreads()).  The bf16 wgmma
// routes run a TMA producer warp beside two consumer warpgroups: their
// producer waits with one thread (consumer_tile_wait_thread, no barrier:
// a block-wide barrier there would wait on warps that never reach it and
// hang the persistent grid), and their consumers wait and notify over their
// own named barrier (the *_synced forms, given that barrier).  A wait that
// precedes a TMA read of the slot also needs fence.proxy.async
// (wgmma_tile.cuh), which the caller issues after the wait.
//
// peer_tile_notify / peer_tile_wait are the same mechanism on a flag that
// another rank sets or reads (the ring's pushes), as in the reference.
//
// A block spins on flags other blocks set, so the fused kernels launch with
// cudaLaunchCooperativeKernel, which guarantees every block is resident or
// refuses the launch.  Flags are zeroed on the stream before each launch.
// ld.acquire / st.release appear nowhere but here (analysis/lint.py's
// flag-site rule).
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
__device__ __forceinline__ void consumer_tile_wait(const int* flag, int target) {
  if (threadIdx.x == 0) {
    while (tl_ld_acquire(flag) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// consumer_tile_wait, thread scope: the calling thread alone spins until the
// flag is set (acquire); no fence and no barrier.
__device__ __forceinline__ void consumer_tile_wait_thread(const int* flag) {
  while (tl_ld_acquire(flag) == 0) __nanosleep(32);
}

// consumer_tile_wait for a group with its own barrier `sync` (a callable):
// thread 0 waits until the flag is set and fences, then the group syncs.
template <typename Sync>
__device__ __forceinline__ void consumer_tile_wait_synced(const int* flag, Sync sync) {
  if (threadIdx.x == 0) {
    consumer_tile_wait_thread(flag);
    __threadfence();
  }
  sync();
}

// producer_tile_notify: publish this block's prior stores, then set the flag.
__device__ __forceinline__ void producer_tile_notify(int* flag, int value) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) tl_st_release(flag, value);
}

// producer_tile_notify for a group with its own barrier `sync` (a callable):
// every thread fences its stores, the group syncs, thread 0 sets the flag.
template <typename Sync>
__device__ __forceinline__ void producer_tile_notify_synced(int* flag, int value, Sync sync) {
  __threadfence();
  sync();
  if (threadIdx.x == 0) tl_st_release(flag, value);
}

// peers: the same mechanism on a flag of the ring (another rank's slot)
__device__ __forceinline__ void peer_tile_wait(const int* flag, int target) { consumer_tile_wait(flag, target); }
__device__ __forceinline__ void peer_tile_wait_thread(const int* flag) { consumer_tile_wait_thread(flag); }
template <typename Sync>
__device__ __forceinline__ void peer_tile_wait_synced(const int* flag, Sync sync) {
  consumer_tile_wait_synced(flag, sync);
}
__device__ __forceinline__ void peer_tile_notify(int* flag, int value) { producer_tile_notify(flag, value); }
template <typename Sync>
__device__ __forceinline__ void peer_tile_notify_synced(int* flag, int value, Sync sync) {
  producer_tile_notify_synced(flag, value, sync);
}

__device__ __forceinline__ void tl_copy_elem(float* d, const float* s) { *d = __ldcg(s); }
__device__ __forceinline__ void tl_copy_elem(__nv_bfloat16* d, const __nv_bfloat16* s) {
  *reinterpret_cast<unsigned short*>(d) = __ldcg(reinterpret_cast<const unsigned short*>(s));
}

// tile_push_data: copy `rows` rows of `cols` elements from A (grouped rows)
// into the contiguous [rows][cols] slot at dst.  All threads of the block call it.
template <typename T>
__device__ void tile_push_data(T* dst, const RowsA<T>& A, int rows, int cols) {
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

// tile_push_data, contiguous form for THREADS threads of a group: `elems` bf16
// values (a multiple of 8: whole 16-byte vectors) from src to dst, read from
// L2 (a peer's slot may have been written by other blocks), BATCH vectors in
// flight a thread.
template <int BATCH, int THREADS>
__device__ __forceinline__ void tile_push_data(__nv_bfloat16* dst, const __nv_bfloat16* src, long elems) {
  const long nv = elems / 8;
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (long e0 = threadIdx.x; e0 < nv; e0 += BATCH * THREADS) {
    uint4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (e0 + u * THREADS < nv) v[u] = __ldcg(s + e0 + u * THREADS);
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (e0 + u * THREADS < nv) d[e0 + u * THREADS] = v[u];
  }
}
