// Fused AllGather + GEMM over W tensor-parallel ranks: every rank emulated
// on one card, or each process holding its block of ranks on its own card
// and pushing tiles into the peer cards' receive regions over NVLink.
//
// Replaces src/repro/kernels/ag_gemm.py::ag_gemm_shard (_ag_gemm_kernel).
// Per rank r: out[r] = all_gather(x) @ w[r], with x [H, B, m_loc, K] and
// w [H, K, n_loc] -> out [H, B, W*m_loc, n_loc] for the H = held ranks
// [rank0, rank0 + H) of this launch (H = W when one process emulates every
// rank); gathered rows of origin o, channel c land at out[r, b, o*m_loc +
// c*m_sub + i] for every batch row b.  Rank q's gather slots and ready flags
// live in its receive region (PeerTbl, tile_sync.cuh): slot (o, c) at
// slots(q) + (o*nch + c) * B*m_sub*K, flag (s, c[, mt]) in flags(q).
// The comm tile of channel c is the slot [B*m_sub, K] (the batch rows ride
// inside the tile).  Two routes, chosen by dtype in the wrapper:
//
// bf16 (ag_gemm_wgmma_kernel): a persistent grid of output tiles.
//
//   work item (s, r, c, nt, mt), numbered stage-major (mt fastest, s
//   slowest: wg_item), is the BM x BN tile (m-tile mt of the held slot,
//   n-tile nt of n_loc) of rank r at step s, channel c; src =
//   src_tbl[c, s, r] is the origin of the held slot (src, c) of rank r.
//   Only the held ranks' items run here: item numbers count (s, r - rank0,
//   c, nt, mt) over the H held ranks, the restriction of one global order.
//   G = min(items, resident blocks) blocks, one cooperative launch; block b
//   runs items b, b+G, ...
//
//   seed:  the n-tile-0 item of (0, r, c, mt) copies its BM rows of rank
//          r's own sub-chunk of x into gather slot (r, c) of rank r and
//          sets ready(r, 0, c, mt) with release;
//   GEMM:  every item's producer warp waits on ready(r, s, c, mt) (acquire,
//          then fence.proxy.async: the slot was written by generic stores
//          and TMA reads it through the async proxy), then streams the A box
//          from the slot and the B boxes from w[r] through the wgmma ring;
//          the epilogue stores the tile at the gathered rows (bf16, the
//          rounding of accum_bf16 included);
//   push:  for s < W-1 the n-tile-0 item of (s, r, c, mt) also stores each
//          A box, as it lands in shared memory, into slot (src, c) of rank
//          dst_tbl[c, s, r] (the held rows travel with the GEMM's own loads,
//          no second read of the slot), then sets ready(dst, s+1, c, mt).
//          With a packed weight the consumers instead wait on ready(r, s, c,
//          mt) themselves and copy the held rows from the slot first.
//
//   No deadlock: an item waits only on a flag set by an item with a smaller
//   number (step s+1 on the n-tile-0 items of step s; a step-0 item with
//   nt > 0 on the seed item of its m-tile, which comes first; the seed item
//   sets the flag it waits on itself, before it waits).  All G blocks are
//   resident and each walks its items in increasing order, so the smallest
//   unfinished item can always run, for any G >= 1.  work_items() in kernels/ag_gemm.py lists
//   the same items; tests/test_torch_fused_schedule.py checks this invariant
//   and the slot protocol on the CPU.
//
//   Across cards the argument holds over the union of the processes' items:
//   each grid walks its items in the global order, all its blocks resident.
//   Flags hold the call's epoch (tile_sync.cuh); a push first waits on the
//   receiver's entry word, which the receiver sets when its launch starts.
//
//   Buffer protocol (as analysis/protocol.py models the TPU kernel): one
//   gather slot per (origin, channel) per rank, written once per pass; one
//   ready flag per (rank, step, channel, m-tile).  The pushes are spread over
//   the m-tiles and ride the GEMM's loads, so the next step's tile travels
//   while this step computes; the W-1 pushes of an m-tile are a chain, each
//   as long as one item's main loop.
//
//   Bound: the GEMM, 2 * W * B*W*m_loc * K * n_loc flops on bf16 tensor cores
//   (989 TFLOP/s); the seed and pushes move W*B*m_loc*K elements per rank
//   through L2 with 16-byte stores.  The ring (wgmma_tile.cuh) overlaps loads
//   with wgmma; the persistent grid fills the 132 SMs at every serve shape.
//
// Packed weights (the reference's PackedWeight: int8 / int4 codes q [W, K,
// n_loc] in an int8 container, scale and zero [W, n_loc] float32, zeros when
// symmetric) are dequantized inside both routes, one launch, no pre-pass:
// the bf16 route loads each K block's codes by TMA (1 byte an element) and
// converts q - zero to bf16 in shared memory before the wgmma
// (wg_dequant_b), the scale multiplying the accumulator in the epilogue;
// the float32 route dequantizes (q - zero) * scale as it stages B (PackedB).
// n_loc must be a multiple of 16 on the bf16 route (16-byte int8 rows).
//
// float32 (ag_gemm_kernel): the tile_gemm.cuh FMA loop, exact f32 products.
//   Grid (n_tile j, channel c, rank r); block j == 0 pushes the held tile and
//   sets its peer's flag (s, c); every block computes its [B*m_sub, bn]
//   output tile on it at every step (the flag primitives in tile_sync.cuh).
//   Bound: fp32 FMA issue (67 TFLOP/s).  A float32 product on tensor cores
//   would be TF32, which the f32 fused-vs-eager checks exist to exclude.
#include "tile_sync.cuh"
#include "wgmma_tile.cuh"

template <typename T, typename WB>
__global__ void __launch_bounds__(TG_THREADS)
    ag_gemm_kernel(const T* __restrict__ x, const WB w, T* __restrict__ out, const __grid_constant__ PeerTbl t,
                   const int* __restrict__ src_tbl, const int* __restrict__ dst_tbl, int W, int nch, int B,
                   int m_loc, int m_sub, int K, int n_loc, int bn, int accum_bf16) {
  __shared__ __align__(16) TileGemmSmem sm;
  __shared__ int s_epoch;
  const int j = blockIdx.x;
  const int c = blockIdx.y;
  const int rl = blockIdx.z;  // held rank rank0 + rl
  const int r = t.rank0 + rl;
  const int rows = B * m_sub;
  const long slot_elems = static_cast<long>(rows) * K;
  const long m_glob = static_cast<long>(W) * m_loc;
  const int col_blk = j * bn;
  const WB wr = w.rank(rl, K).cols(col_blk);
  const int bn_here = min(bn, n_loc - col_blk);
  if (threadIdx.x == 0) {
    s_epoch = tl_enter_epoch(t);
    if (j == 0 && c == 0 && rl == 0) peer_entry_notify(t, W, s_epoch);
  }
  __syncthreads();
  const int e = s_epoch;

  for (int s = 0; s < W; ++s) {
    const int f = (c * W + s) * W + r;
    const int src = src_tbl[f];
    const int dst = dst_tbl[f];
    RowsA<T> A;
    if (s == 0) {
      // own sub-chunk, in place: row (b, i) -> x[rl, b, c*m_sub + i, :]
      A = RowsA<T>{x + (static_cast<long>(rl) * B * m_loc + static_cast<long>(c) * m_sub) * K, K, m_sub,
                   static_cast<long>(m_loc) * K};
    } else {
      peer_tile_wait(&t.flags(r)[(s - 1) * nch + c], e, t.sys);
      A = RowsA<T>{t.slots<T>(r) + (static_cast<long>(src) * nch + c) * slot_elems, K, rows, 0};
    }
    if (j == 0 && s < W - 1) {
      peer_entry_wait(t, r, dst, e);  // dst's last call has read its slots
      T* slot = t.slots<T>(dst) + (static_cast<long>(src) * nch + c) * slot_elems;
      tile_push_data(slot, A, rows, K);
      peer_tile_notify(&t.flags(dst)[s * nch + c], e, t.sys);
    }
    const long row_base = static_cast<long>(src) * m_loc + static_cast<long>(c) * m_sub;
    for (int r0 = 0; r0 < rows; r0 += TG_BM) {
      for (int c0 = 0; c0 < bn_here; c0 += TG_BN) {
        const int m = min(TG_BM, rows - r0);
        const int n = min(TG_BN, bn_here - c0);
        auto epi = [&](int i, int jj, float v) {
          const int b = i / m_sub;
          const int ii = i % m_sub;
          if (accum_bf16) v = __bfloat162float(__float2bfloat16(v));
          out[((static_cast<long>(rl) * B + b) * m_glob + row_base + ii) * n_loc + col_blk + c0 + jj] =
              tl_from_float<T>(v);
        };
        tile_gemm(A, r0, m, wr.cols(c0), n, K, sm, epi);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) tl_exit_epoch(t, e, gridDim.x * gridDim.y * gridDim.z);
}


struct AgArgs {
  const float* scale;  // packed weights: [H, n_loc] (else null)
  const float* zero;
  const __nv_bfloat16* x;
  __nv_bfloat16* out;
  PeerTbl t;  // gather slots [W*nch, rows, K] and ready flags [W, nch, MT] of every rank
  const int* src_tbl;
  const int* dst_tbl;
  int W, nch, B, m_loc, m_sub, K, n_loc, MT, NT, items;
};

// at most this many held ranks a launch.  The gather slots' TMA maps, N of
// them in the kernel's parameters: N = 1 over every held rank's slots when
// they lie at one stride (the ranks emulated in one allocation, or one held
// rank), as [H*W*nch slots, rows, K]; else N = TL_MAX_HELD, one a held rank,
// as [W*nch slots, rows, K] (separate allocations).  Two instantiations, so
// the common launch carries one map, not sixteen.
constexpr int TL_MAX_HELD = 16;
template <int N>
struct AgMaps {
  CUtensorMap a[N];
};

// The 256 consumer threads: the seed copy of a step-0 n-tile-0 item, rows
// [row0, row0 + nrows) of held rank rl's own sub-chunk of x (slot row i =
// (b, ii) -> x[rl, b, c*m_sub + ii, :]) into its own gather slot, 16-byte vectors.
// Each thread issues COPY_BATCH independent loads before it stores them, so
// the copy is not one L2 round trip per vector.
constexpr int COPY_BATCH = 8;

__device__ __forceinline__ void ag_seed_rows(const AgArgs& a, int rl, int c, int row0, int nrows, __nv_bfloat16* own) {
  const int vpr = a.K / 8;
  const int total = nrows * vpr;
  for (int e0 = threadIdx.x; e0 < total; e0 += COPY_BATCH * wg::CONSUMERS) {
    uint4 v[COPY_BATCH];
#pragma unroll
    for (int u = 0; u < COPY_BATCH; ++u) {
      const int e = e0 + u * wg::CONSUMERS;
      if (e >= total) break;
      const int i = row0 + e / vpr;
      const __nv_bfloat16* src =
          a.x + ((static_cast<long>(rl) * a.B + i / a.m_sub) * a.m_loc + static_cast<long>(c) * a.m_sub + i % a.m_sub) * a.K;
      v[u] = __ldcg(reinterpret_cast<const uint4*>(src) + e % vpr);
    }
#pragma unroll
    for (int u = 0; u < COPY_BATCH; ++u) {
      const int e = e0 + u * wg::CONSUMERS;
      if (e >= total) break;
      reinterpret_cast<uint4*>(own)[static_cast<long>(row0) * vpr + e] = v[u];
    }
  }
}

// The 256 consumers push a held slot (written by other blocks: L2 loads) to a
// peer's slot with tile_push_data, COPY_BATCH vectors in flight a thread.  A
// packed item pushes this way instead of from its A boxes, so its mainloop
// hook only converts the Q boxes (one hook doing both spilled registers).
// Stores to a gather slot are published for TMA readers: the proxy fence,
// then the consumers' notify (producer_tile_notify_synced over their barrier).

// PACKED: map_b holds the int8 codes (a Q box per stage, wg_dequant_b).
template <bool PACKED, int NMAPS>
__global__ void __launch_bounds__(wg::THREADS, 1)
    ag_gemm_wgmma_kernel(const __grid_constant__ AgMaps<NMAPS> maps, const __grid_constant__ CUtensorMap map_b,
                         const __grid_constant__ AgArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * wg::STAGES];
  __shared__ int s_epoch;
  const PeerTbl& t = a.t;
  const int W = a.W, nch = a.nch;
  if (threadIdx.x == 0) {
    s_epoch = tl_enter_epoch(t);
    if (blockIdx.x == 0) peer_entry_notify(t, W, s_epoch);
  }
  const WgRing ring = wg_ring_setup(smem_raw, bars, PACKED ? wg::STAGE_BYTES_Q : wg::STAGE_BYTES);  // syncs
  const int rows = a.B * a.m_sub;
  const long slot_elems = static_cast<long>(rows) * a.K;
  const int nk = (a.K + wg::BK - 1) / wg::BK;
  RingPos pos;

  if (threadIdx.x >= wg::CONSUMERS) {  // ---- producer warp: TMA loads
    if (threadIdx.x != wg::CONSUMERS) return;
    const int e = s_epoch;
    for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
      const WgItem x = wg_item(it, t.held, nch, a.NT, a.MT);
      const int s = x.s, rl = x.r, r = t.rank0 + x.r, c = x.c, nt = x.nt, mt = x.mt;
      const int src = a.src_tbl[(c * W + s) * W + r];
      const int* flag = &t.flags(r)[(s * nch + c) * a.MT + mt];
      consumer_tile_wait_thread(flag, e, t.sys);
      wg_fence_proxy_async();  // the slot is read through the async proxy (TMA)
      const int slot = (NMAPS == 1 ? rl * W * nch : 0) + src * nch + c;
      const CUtensorMap* map_a = &maps.a[NMAPS == 1 ? 0 : rl];
      auto load = [&](int kb, uint8_t* sa, uint8_t* sb, uint64_t* bar) {
        wg_tma_3d(sa, map_a, bar, kb * wg::BK, mt * wg::BM, slot);
        wg_tma_3d(sb, &map_b, bar, nt * wg::BN, kb * wg::BK, rl);  // PACKED: the whole Q box
        if (!PACKED) wg_tma_3d(sb + wg::B_BYTES / 2, &map_b, bar, nt * wg::BN + 64, kb * wg::BK, rl);
      };
      wg_produce(ring, pos, nk, load, PACKED ? wg::LOAD_BYTES_Q : wg::STAGE_BYTES);
    }
    return;
  }

  // ---- two consumer warpgroups: seed / push, wgmma, epilogue
  const int wgi = threadIdx.x / 128;
  const auto consumers = [] { wg_consumer_sync(); };
  // the epoch read from shared memory at each use: no register held across the main loop
  const auto epoch = [&] { return *static_cast<volatile int*>(&s_epoch); };
  const long m_glob = static_cast<long>(W) * a.m_loc;
  float acc[wg::ACC];
#pragma unroll
  for (int j = 0; j < wg::ACC; ++j) acc[j] = 0.f;
  for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
    const WgItem x = wg_item(it, t.held, nch, a.NT, a.MT);
    const int s = x.s, rl = x.r, r = t.rank0 + x.r, c = x.c, nt = x.nt, mt = x.mt;
    const int f = (c * W + s) * W + r;
    const int src = a.src_tbl[f];
    const int row0 = mt * wg::BM;
    const int nrows = min(wg::BM, rows - row0);
    const int col0 = nt * wg::BN;
    if (nt == 0 && s == 0) {  // seed: own sub-chunk -> own slot (r, c)
      __nv_bfloat16* own = t.slots<__nv_bfloat16>(r) + (static_cast<long>(r) * nch + c) * slot_elems;
      ag_seed_rows(a, rl, c, row0, nrows, own);
      wg_fence_proxy_async();
      producer_tile_notify_synced(&t.flags(r)[(0 * nch + c) * a.MT + mt], epoch(), t.sys, consumers);
    }
    const bool push = nt == 0 && s < W - 1;  // the held rows -> the peer's slot (src, c) of rank dst
    if constexpr (PACKED) {
      if (push) {  // copied from the held slot once it is ready, before the GEMM
        const int dst = a.dst_tbl[f];
        peer_tile_wait_synced(&t.flags(r)[(s * nch + c) * a.MT + mt], epoch(), t.sys, consumers);
        peer_entry_wait_synced(t, r, dst, epoch(), consumers);  // dst's last call has read its slots
        const long at = (static_cast<long>(src) * nch + c) * slot_elems + static_cast<long>(row0) * a.K;
        tile_push_data<COPY_BATCH, wg::CONSUMERS>(t.slots<__nv_bfloat16>(dst) + at, t.slots<__nv_bfloat16>(r) + at,
                                                  static_cast<long>(nrows) * a.K);
        wg_fence_proxy_async();
        peer_tile_notify_synced(&t.flags(dst)[((s + 1) * nch + c) * a.MT + mt], epoch(), t.sys, consumers);
      }
      const float* zrow = a.zero + static_cast<long>(rl) * a.n_loc + col0;
      auto dequant = [&](int kb, const uint8_t* box) {
        wg_dequant_b(box + wg::STAGE_BYTES, const_cast<uint8_t*>(box) + wg::A_BYTES, zrow, a.n_loc - col0,
                     kb * wg::BK, a.K);
      };
      wg_mainloop(ring, pos, nk, wgi, acc, dequant);
    } else if (push) {  // from the A boxes as they land
      const int dst = a.dst_tbl[f];
      peer_entry_wait_synced(t, r, dst, epoch(), consumers);  // dst's last call has read its slots
      __nv_bfloat16* peer =
          t.slots<__nv_bfloat16>(dst) + (static_cast<long>(src) * nch + c) * slot_elems + static_cast<long>(row0) * a.K;
      auto store = [&](int kb, const uint8_t* box) { wg_store_a_box(box, peer, a.K, nrows, kb * wg::BK, a.K); };
      wg_mainloop(ring, pos, nk, wgi, acc, store);
      wg_fence_proxy_async();
      peer_tile_notify_synced(&t.flags(dst)[((s + 1) * nch + c) * a.MT + mt], epoch(), t.sys, consumers);
    } else {
      wg_mainloop(ring, pos, nk, wgi, acc);
    }
    const long row_base = static_cast<long>(src) * a.m_loc + static_cast<long>(c) * a.m_sub;
    const float* srow = PACKED ? a.scale + static_cast<long>(rl) * a.n_loc + col0 : nullptr;
    auto epi = [&](int row, int col, float v0, float v1) {
      const int i = row0 + row;
      const int b = i / a.m_sub;
      const long o = ((static_cast<long>(rl) * a.B + b) * m_glob + row_base + i % a.m_sub) * a.n_loc + col0 + col;
      if constexpr (PACKED) {  // the per-column scale of the packed weight, on the float32 sum
        v0 *= __ldg(srow + col);
        v1 *= __ldg(srow + col + 1);
      }
      *reinterpret_cast<__nv_bfloat162*>(a.out + o) = __floats2bfloat162_rn(v0, v1);  // n_loc % 8 == 0
    };
    wg_epilogue(acc, wgi, nrows, a.n_loc - col0, epi);
  }
  consumers();
  if (threadIdx.x == 0) tl_exit_epoch(t, epoch(), gridDim.x);
}

template <typename WB>
static int launch_f32(int accum_bf16, const void* x, WB wb, void* out, PeerTbl t, const void* src_tbl,
                      const void* dst_tbl, int W, int nch, int n_tiles, int B, int m_loc, int m_sub, int K, int n_loc,
                      int bn, cudaStream_t st) {
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  const int* sp = static_cast<const int*>(src_tbl);
  const int* dp = static_cast<const int*>(dst_tbl);
  void* args[] = {&xp, &wb, &op, &t, &sp, &dp, &W, &nch, &B, &m_loc, &m_sub, &K, &n_loc, &bn, &accum_bf16};
  const dim3 grid(n_tiles, nch, t.held);
  // co-residency: every block spins on flags other blocks set
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(ag_gemm_kernel<float, WB>), grid,
                                              dim3(TG_THREADS), args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// float32 route; the bf16 route is tl_ag_gemm_wgmma.  scale / zero non-null:
// w is a packed weight's int8 codes [H, K, n_loc] with scale / zero [H, n_loc].
// regions: the W ranks' receive regions (a host PeerArgs, tile_sync.cuh); the
// launch runs its held ranks [rank0, rank0 + held).
extern "C" int tl_ag_gemm(int accum_bf16, const void* x, const void* w, const void* scale, const void* zero, void* out,
                          const void* regions, const void* src_tbl, const void* dst_tbl, int W, int nch,
                          int n_tiles, int B, int m_loc, int m_sub, int K, int n_loc, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PeerTbl t;
  if (!tl_peer_tbl(&t, regions, W)) return static_cast<int>(cudaErrorInvalidValue);
  if (scale != nullptr) {
    const PackedB wb{static_cast<const int8_t*>(w), static_cast<const float*>(scale), static_cast<const float*>(zero),
                     n_loc};
    return launch_f32(accum_bf16, x, wb, out, t, src_tbl, dst_tbl, W, nch, n_tiles, B, m_loc, m_sub, K, n_loc, bn,
                      st);
  }
  const PlainB<float> wb{static_cast<const float*>(w), n_loc};
  return launch_f32(accum_bf16, x, wb, out, t, src_tbl, dst_tbl, W, nch, n_tiles, B, m_loc, m_sub, K, n_loc, bn, st);
}

// bf16 route.  info (host int[2]) receives the grid G and the item count.
// K and n_loc must be multiples of 8 (16 with a packed weight) and the
// operands 16-byte aligned (the wrapper checks).  regions: as tl_ag_gemm's
// (the held ranks' slots also back the TMA maps).  scale / zero non-null: w
// is a packed weight's int8 codes [H, K, n_loc] with scale / zero [H, n_loc].
extern "C" int tl_ag_gemm_wgmma(const void* x, const void* w, const void* scale, const void* zero, void* out,
                                const void* regions, const void* src_tbl, const void* dst_tbl, void* info, int W,
                                int nch, int B, int m_loc, int m_sub, int K, int n_loc, void* stream) {
  const int rows = B * m_sub;
  const bool packed = scale != nullptr;
  AgArgs a{static_cast<const float*>(scale), static_cast<const float*>(zero),
           static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
           PeerTbl{}, static_cast<const int*>(src_tbl),
           static_cast<const int*>(dst_tbl), W, nch, B, m_loc, m_sub, K, n_loc,
           (rows + wg::BM - 1) / wg::BM, (n_loc + wg::BN - 1) / wg::BN, 0};
  if (!tl_peer_tbl(&a.t, regions, W) || a.t.held > TL_MAX_HELD) return static_cast<int>(cudaErrorInvalidValue);
  const int held = a.t.held, rank0 = a.t.rank0;
  const PeerArgs* p = static_cast<const PeerArgs*>(regions);
  const long long span = static_cast<long long>(W) * nch * rows * K * sizeof(__nv_bfloat16);  // a rank's slots
  const bool one = held == 1 || (p->bases == nullptr && p->slot_stride == span);
  a.items = held * W * nch * a.MT * a.NT;
  AgMaps<1> map1;
  AgMaps<TL_MAX_HELD> maps;
  CUtensorMap* ma = one ? map1.a : maps.a;
  CUtensorMap map_b;
  // A: the held ranks' gather slots as [H*W*nch slots, rows, K] (one map) or each as [W*nch, rows, K];
  // B: w as [H, K, n_loc]
  const cuuint64_t da[3] = {(cuuint64_t)K, (cuuint64_t)rows, (cuuint64_t)(one ? held : 1) * W * nch};
  const cuuint64_t sa[2] = {(cuuint64_t)K, (cuuint64_t)rows * K};
  const cuuint32_t ba[3] = {wg::BK, wg::BM, 1};
  const cuuint64_t db[3] = {(cuuint64_t)n_loc, (cuuint64_t)K, (cuuint64_t)held};
  const cuuint64_t sb[2] = {(cuuint64_t)n_loc, (cuuint64_t)K * n_loc};
  const cuuint32_t bb[3] = {packed ? static_cast<cuuint32_t>(wg::BN) : 64u, wg::BK, 1};  // packed: one int8 Q box
  int rc = 0;
  for (int h = 0; h < (one ? 1 : held) && rc == 0; ++h)
    rc = wg_tensor_map(&ma[h], reinterpret_cast<const void*>(a.t.slot[rank0 + h]), 3, da, sa, ba);
  if (rc == 0) rc = wg_tensor_map(&map_b, w, 3, db, sb, bb, packed);
  static int resident[2][2] = {{0, 0}, {0, 0}};
  const void* kernels[2][2] = {
      {reinterpret_cast<const void*>(ag_gemm_wgmma_kernel<false, TL_MAX_HELD>),
       reinterpret_cast<const void*>(ag_gemm_wgmma_kernel<false, 1>)},
      {reinterpret_cast<const void*>(ag_gemm_wgmma_kernel<true, TL_MAX_HELD>),
       reinterpret_cast<const void*>(ag_gemm_wgmma_kernel<true, 1>)}};
  const void* kernel = kernels[packed][one];
  const int smem = packed ? wg::SMEM_BYTES_Q : wg::SMEM_BYTES;
  int grid = 0;
  if (rc == 0) rc = wg_grid(kernel, a.items, &resident[packed][one], &grid, smem);
  if (rc != 0) return rc;
  static_cast<int*>(info)[0] = grid;
  static_cast<int*>(info)[1] = a.items;
  void* args[] = {one ? static_cast<void*>(&map1) : static_cast<void*>(&maps), &map_b, &a};
  cudaError_t e = cudaLaunchCooperativeKernel(const_cast<void*>(kernel), dim3(grid), dim3(wg::THREADS), args, smem,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
