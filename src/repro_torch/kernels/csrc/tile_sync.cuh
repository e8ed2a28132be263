// The paper's tile-centric primitives (Table 3) on Hopper: notify, wait, push.
//
// Replaces src/repro/core/primitives.py (producer_tile_notify,
// consumer_tile_wait, peer_tile_notify / peer_tile_wait, tile_push_data)
// over src/repro/backend/lowering.py (DMA semaphores, remote async copies);
// core/primitives.py holds the same names over a host flag board, which the
// fused kernels' plain versions call.  On the TPU a tile travels by a remote
// DMA whose completion signals the receiver's semaphore.  Here a tile
// travels by plain global stores into the receiving rank's slot, found
// through a table of every rank's receive region (PeerTbl below): a region
// of this card, or a peer card's region mapped into this process over
// NVLink (CUDA IPC, kernels/csrc/peer.cu).  So:
//
//   * a peer push is plain global stores into the receiving rank's slot
//     (tile_push_data, 16-byte vectors where the rows allow);
//   * notify is a fence by every thread of the group, the group's barrier,
//     then one release store of the flag (the slot's stores are visible
//     before the flag);
//   * wait is one thread spinning on an acquire load, a fence, then the
//     group's barrier; consumers read the slot with ld.global.cg (L2), so a
//     stale L1 line cannot shadow the peer's stores.
//
// Scope: every primitive takes `sys`.  0 (the ranks emulated on one card
// in one allocation): ld.acquire.gpu / st.release.gpu / __threadfence().
// 1 (the peer route: a rank's region may be another card's memory):
// ld.acquire.sys / st.release.sys / __threadfence_system().
//
// Epochs instead of zeroing.  A peer-route pool's regions live for the
// process and are never zeroed between calls (one card's one-allocation
// regions are made for each call with zeroed control words: epoch 1 every
// call, no entry words, as before): a peer card's pushes of its next call
// could land before a rank's own memset.  Each launch reads its epoch e
// from the process's control words (tl_enter_epoch: the last call's epoch
// + 1; the launch's last block to finish records e, tl_exit_epoch), sets
// every flag to e and waits for >= e.  On entering call e, each held rank
// writes e into its entry word on every rank's region (peer_entry_notify,
// block 0, before any item); a pusher waits on its own region's copy of
// the receiver's entry word before its first store into the receiver's
// slots (peer_entry_wait), so no push overwrites a slot the receiver's
// call e - 1 may still read (stream order: a rank enters call e after its
// call e - 1 has finished).
//
// Bounded spins: a spin that lasts TL_SPIN_NS (read from %globaltimer)
// traps, so a rank that never launches, or a protocol fault, fails the
// run instead of hanging it.
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
// refuses the launch; across cards every process launches its own grid of
// its held ranks' items (the items are numbered in one global order, so the
// smallest unfinished one can always run).  ld.acquire / st.release and
// the system-scope fence appear nowhere but here (analysis/lint.py's
// flag-site rule).
#pragma once

#include "tile_gemm.cuh"

// a spin on a flag traps after this long (ns): no fused launch waits this long on a live peer
constexpr unsigned long long TL_SPIN_NS = 30ull * 1000000000ull;

__device__ __forceinline__ int tl_ld_acquire(const int* p, int sys) {
  int v;
  if (sys)
    asm volatile("ld.acquire.sys.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void tl_st_release(int* p, int v, int sys) {
  if (sys)
    asm volatile("st.release.sys.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void tl_fence(int sys) {
  if (sys)
    __threadfence_system();
  else
    __threadfence();
}

__device__ __forceinline__ unsigned long long tl_globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// the calling thread spins until *flag >= target (acquire); traps after TL_SPIN_NS
__device__ __forceinline__ void tl_spin(const int* flag, int target, int sys) {
  if (tl_ld_acquire(flag, sys) >= target) return;
  const unsigned long long t0 = tl_globaltimer();
  while (tl_ld_acquire(flag, sys) < target) {
    __nanosleep(64);
    if (tl_globaltimer() - t0 > TL_SPIN_NS) __trap();
  }
}

// consumer_tile_wait: the whole block waits until *flag >= target.
__device__ __forceinline__ void consumer_tile_wait(const int* flag, int target, int sys) {
  if (threadIdx.x == 0) {
    tl_spin(flag, target, sys);
    tl_fence(sys);
  }
  __syncthreads();
}

// consumer_tile_wait, thread scope: the calling thread alone spins until the
// flag reaches target (acquire); no fence and no barrier.
__device__ __forceinline__ void consumer_tile_wait_thread(const int* flag, int target, int sys) {
  tl_spin(flag, target, sys);
}

// consumer_tile_wait for a group with its own barrier `sync` (a callable):
// thread 0 waits until the flag reaches target and fences, then the group syncs.
template <typename Sync>
__device__ __forceinline__ void consumer_tile_wait_synced(const int* flag, int target, int sys, Sync sync) {
  if (threadIdx.x == 0) {
    tl_spin(flag, target, sys);
    tl_fence(sys);
  }
  sync();
}

// producer_tile_notify: publish this block's prior stores, then set the flag.
__device__ __forceinline__ void producer_tile_notify(int* flag, int value, int sys) {
  tl_fence(sys);
  __syncthreads();
  if (threadIdx.x == 0) tl_st_release(flag, value, sys);
}

// producer_tile_notify for a group with its own barrier `sync` (a callable):
// every thread fences its stores, the group syncs, thread 0 sets the flag.
template <typename Sync>
__device__ __forceinline__ void producer_tile_notify_synced(int* flag, int value, int sys, Sync sync) {
  tl_fence(sys);
  sync();
  if (threadIdx.x == 0) tl_st_release(flag, value, sys);
}

// peers: the same mechanism on a flag of the ring (another rank's slot)
__device__ __forceinline__ void peer_tile_wait(const int* flag, int target, int sys) {
  consumer_tile_wait(flag, target, sys);
}
__device__ __forceinline__ void peer_tile_wait_thread(const int* flag, int target, int sys) {
  consumer_tile_wait_thread(flag, target, sys);
}
template <typename Sync>
__device__ __forceinline__ void peer_tile_wait_synced(const int* flag, int target, int sys, Sync sync) {
  consumer_tile_wait_synced(flag, target, sys, sync);
}
__device__ __forceinline__ void peer_tile_notify(int* flag, int value, int sys) { producer_tile_notify(flag, value, sys); }
template <typename Sync>
__device__ __forceinline__ void peer_tile_notify_synced(int* flag, int value, int sys, Sync sync) {
  producer_tile_notify_synced(flag, value, sys, sync);
}

// ---- the receive regions of a launch: one per rank, found through a table

// Rank q's receive region: its slots at slot[q], and its control words at
// ctl[q]: the ready flags first, the W entry words at entry_off, the 2
// control words at ctl_off (bytes).  Addresses in this process: this card's
// memory, or a peer card's mapped over NVLink.  The table rides in the
// kernel's parameters (no device table to upload, so a CUDA graph may
// capture a launch whose regions were made for it).  The launch's items are
// the held ranks' [rank0, rank0 + held).
constexpr int TL_MAX_W = 16;  // ranks a world of the fused kernels may have
struct PeerTbl {
  unsigned long long slot[TL_MAX_W], ctl[TL_MAX_W];
  long long entry_off, ctl_off;
  int rank0, held, sys;

  template <typename T>
  __device__ __forceinline__ T* slots(int q) const {
    return reinterpret_cast<T*>(slot[q]);
  }
  __device__ __forceinline__ int* flags(int q) const { return reinterpret_cast<int*>(ctl[q]); }
  __device__ __forceinline__ int* entry(int q) const { return reinterpret_cast<int*>(ctl[q] + entry_off); }
  __device__ __forceinline__ int* control() const { return reinterpret_cast<int*>(ctl[rank0] + ctl_off); }
};

// Host: a launch's regions as kernels/peer.py's PeerArgs (a ctypes mirror)
// gives them: a table of 2W addresses (every rank's slots, then every
// rank's control words), or, with no table, rank q's slots at slot0 + q *
// slot_stride and its control words at ctl0 + q * ctl_stride (the ranks
// emulated in one process: one allocation of slots, one of control words).
struct PeerArgs {
  const unsigned long long* bases;
  unsigned long long slot0, ctl0;
  long long slot_stride, ctl_stride, entry_off, ctl_off;
  int rank0, held, sys, pad;
};

// Host: the table of a launch; false when the world is wider than TL_MAX_W
// or the held ranks fall outside it.
inline bool tl_peer_tbl(PeerTbl* t, const void* args, int W) {
  const PeerArgs* p = static_cast<const PeerArgs*>(args);
  if (W < 1 || W > TL_MAX_W || p->held < 1 || p->rank0 < 0 || p->rank0 + p->held > W) return false;
  for (int q = 0; q < TL_MAX_W; ++q) {
    const bool in = q < W;
    t->slot[q] = !in ? 0ull : p->bases ? p->bases[q] : p->slot0 + q * p->slot_stride;
    t->ctl[q] = !in ? 0ull : p->bases ? p->bases[W + q] : p->ctl0 + q * p->ctl_stride;
  }
  t->entry_off = p->entry_off;
  t->ctl_off = p->ctl_off;
  t->rank0 = p->rank0;
  t->held = p->held;
  t->sys = p->sys;
  return true;
}

// The one-allocation route (sys 0) makes its regions for the call, so it
// is always epoch 1 and has no entry words to set or wait on: the
// primitives below return at once there (t.sys is uniform over the grid),
// and that route does what it did before regions and epochs.

// The launch's epoch: the last finished call's + 1 (thread 0 of each block,
// before its first item; the caller shares it with the block).
__device__ __forceinline__ int tl_enter_epoch(const PeerTbl& t) {
  return t.sys ? *reinterpret_cast<volatile const int*>(t.control()) + 1 : 1;
}

// Thread 0 of each block, after the block's last item: the launch's last
// block to finish records the epoch for the next call on the pool.
__device__ __forceinline__ void tl_exit_epoch(const PeerTbl& t, int epoch, int blocks) {
  if (!t.sys) return;
  int* ctl = t.control();
  __threadfence();
  if (atomicAdd(ctl + 1, 1) == blocks - 1) {
    ctl[1] = 0;
    *reinterpret_cast<volatile int*>(ctl) = epoch;
    __threadfence();
  }
}

// peer_entry_notify (block 0, thread 0, before any item): every held rank
// has entered call `epoch`: its entry word on every rank's region.
__device__ __forceinline__ void peer_entry_notify(const PeerTbl& t, int W, int epoch) {
  if (!t.sys) return;
  for (int h = 0; h < t.held; ++h)
    for (int q = 0; q < W; ++q) tl_st_release(t.entry(q) + t.rank0 + h, epoch, t.sys);
}

// peer_entry_wait: before rank `src`'s first store into rank dst's slots in
// call `epoch`, wait on src's own copy of dst's entry word (dst's call
// epoch - 1 has finished reading them).  Block-wide, or over `sync`.
__device__ __forceinline__ void peer_entry_wait(const PeerTbl& t, int src, int dst, int epoch) {
  if (!t.sys) return;
  consumer_tile_wait(t.entry(src) + dst, epoch, t.sys);
}
template <typename Sync>
__device__ __forceinline__ void peer_entry_wait_synced(const PeerTbl& t, int src, int dst, int epoch, Sync sync) {
  if (!t.sys) return;
  consumer_tile_wait_synced(t.entry(src) + dst, epoch, t.sys, sync);
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
