// Fused GEMM + ReduceScatter over W tensor-parallel ranks (paper Fig. 4,
// plan-driven): every rank emulated on one card, or each process holding its
// block of ranks on its own card and pushing partials into the peer cards'
// receive regions over NVLink.
//
// Replaces src/repro/kernels/gemm_rs.py::gemm_rs_shard (_gemm_rs_kernel).
// Per rank r: out[r] = rank r's [B, M/W, N] segment of sum_q x[q] @ w[q],
// with x [H, B, M, k_loc] and w [H, k_loc, N] of the H = held ranks [rank0,
// rank0 + H) of this launch (H = W when one process emulates every rank).
// Channel c owns columns c*n_sub .. (c+1)*n_sub.  Rank q's recv slots and
// flags live in its receive region (PeerTbl, tile_sync.cuh): recv slot
// (stage, c) at slots(q) + (stage*nch + c) * B*m_loc*n_sub, its flags in
// flags(q); flags hold the call's epoch and a push first waits on the
// receiver's entry word (tile_sync.cuh).  Only the held ranks' items run
// here, numbered in the global order restricted to them.  Two routes,
// chosen by dtype in the wrapper:
//
// bf16 (gemm_rs_wgmma_kernel): a persistent grid of output tiles.
//
//   work item (s, r, c, nt, mt), numbered stage-major (mt fastest: wg_item), is a
//   BM x BN tile of the [B*m_loc, n_sub] partial of segment seg =
//   seg_tbl[c, s, r] of rank r at stage s.  m-tile mt = (batch pair bp, row
//   block ib): consumer warpgroup g holds batch row 2*bp + g, rows
//   ib*64 .. ib*64+63 of the segment (one 64-row block per batch row at
//   every serve shape, m_loc = 64).  A is a 4-D TMA box (64 of K, 64 rows, 2
//   batches, 1 rank) of x [W, B, M, k_loc]; rows past the segment or past B
//   are loaded (x is read-only) or zero-filled and masked in the epilogue.
//   The B boxes of channel c start at column c*n_sub rounded down to a
//   multiple of 8 (TMA needs 16-byte aligned box starts), `lead` columns
//   early; the epilogue shifts by lead and masks the columns outside the
//   channel, and the n-tiles cover n_sub plus the widest lead.
//   G = min(items, resident blocks) blocks, one cooperative launch; block b
//   runs items b, b+G, ...
//
//   epilogue: for s > 0 wait on flag (r, s-1, c, mt, nt) (acquire) and add
//             the partial received in recv slot (s-1, c); for s < W-1 store
//             the sum (accum dtype, the wire dtype of the identity
//             QuantSpec) into recv slot (s, c) of rank dst_tbl[c, s, r] and
//             set that rank's flag (s, c, mt, nt) (release); the last stage
//             stores the reduced home segment to out.  The producer warp
//             needs no flag: it reads only x and w.
//
//   No deadlock: an item waits only on a flag set by an item of the stage
//   before, which has a smaller number.  All G blocks are resident and each
//   walks its items in increasing order, so the smallest unfinished item
//   can always run, for any G >= 1 (work_items() in kernels/gemm_rs.py;
//   tests/test_torch_fused_schedule.py checks it on the CPU).
//
//   Each recv slot (stage, channel) is written exactly once per pass, so no
//   send credit is needed: the partial never sits in a staging buffer that a
//   later stage reuses (the per-channel send semaphore of the TPU kernel
//   guards exactly that reuse).  Flags are per (rank, stage, channel, m-tile,
//   n-tile).  Slots are written and read with generic accesses (L2, ld.cg).
//
//   Bound: the GEMM, 2 * W * B*M * k_loc * N flops on bf16 tensor cores;
//   partial traffic W*(W-1)*B*m_loc*N accum elements stays in L2.
//
// The wire dtype: the recv slots (rbuf) hold partials in the plan's wire
// dtype (QuantSpec.wire_dtype, the accumulation dtype by default): AccT
// below.  A partial is summed in float32 (the registers), stored in the
// wire dtype at the send edge and added back in float32 at the next stage,
// the reference's `split` path (bf16 partials under float32 accumulation).
//
// Packed weights (int8 / int4 codes q [W, k_loc, N], scale and zero [W, N]
// float32): dequantized inside both routes as in ag_gemm.cu (the bf16
// route's Q boxes by TMA and wg_dequant_b, the scale applied to the sum
// before the received partial is added; the float32 route's PackedB).  On
// the bf16 route a channel's B boxes then start at its first column rounded
// down to a multiple of 16 (16-byte int8 box starts), and N must be a
// multiple of 16.
//
// float32 (gemm_rs_kernel): the tile_gemm.cuh FMA loop, exact f32 products.
//   Grid (n_tile j, channel c, rank r); block (j, c, r) owns columns
//   c*n_sub + j*bn .. +bn of every stage, with flags per (stage, channel,
//   n-tile).  Bound: fp32 FMA issue (67 TFLOP/s).
#include "tile_sync.cuh"
#include "wgmma_tile.cuh"


template <typename T, typename AccT, typename WB>
__global__ void __launch_bounds__(TG_THREADS)
    gemm_rs_kernel(const T* __restrict__ x, const WB w, T* __restrict__ out, const __grid_constant__ PeerTbl t,
                   const int* __restrict__ seg_tbl, const int* __restrict__ dst_tbl, int W, int nch, int n_tiles,
                   int B, int M, int K, int N, int n_sub, int bn) {
  __shared__ __align__(16) TileGemmSmem sm;
  __shared__ int s_epoch;
  const int j = blockIdx.x;
  const int c = blockIdx.y;
  const int rl = blockIdx.z;  // held rank rank0 + rl
  const int r = t.rank0 + rl;
  const int m_loc = M / W;
  const int rows = B * m_loc;
  const long slot_elems = static_cast<long>(rows) * n_sub;
  const int ccol = j * bn;  // first column inside the channel
  const int bn_here = min(bn, n_sub - ccol);
  const WB wr = w.rank(rl, K).cols(c * n_sub + ccol);
  if (threadIdx.x == 0) {
    s_epoch = tl_enter_epoch(t);
    if (j == 0 && c == 0 && rl == 0) peer_entry_notify(t, W, s_epoch);
  }
  __syncthreads();
  // the epoch and the receiver read again at each use: no register held across the tile loop
  const auto epoch = [&] { return *static_cast<volatile int*>(&s_epoch); };

  for (int s = 0; s < W; ++s) {
    const int f = (c * W + s) * W + r;
    const int seg = seg_tbl[f];
    // rows (b, i) -> x[rl, b, seg*m_loc + i, :]
    const RowsA<T> A{x + (static_cast<long>(rl) * B * M + static_cast<long>(seg) * m_loc) * K, K, m_loc,
                     static_cast<long>(M) * K};
    const AccT* prev = nullptr;
    if (s > 0) {
      peer_tile_wait(&t.flags(r)[((s - 1) * nch + c) * n_tiles + j], epoch(), t.sys);
      prev = t.slots<AccT>(r) + (static_cast<long>(s - 1) * nch + c) * slot_elems;
    }
    AccT* send = nullptr;
    if (s < W - 1) {
      const int dst = dst_tbl[f];
      peer_entry_wait(t, r, dst, epoch());  // dst's last call has read its recv slots
      send = t.slots<AccT>(dst) + (static_cast<long>(s) * nch + c) * slot_elems;
    }
    for (int r0 = 0; r0 < rows; r0 += TG_BM) {
      for (int c0 = 0; c0 < bn_here; c0 += TG_BN) {
        const int m = min(TG_BM, rows - r0);
        const int n = min(TG_BN, bn_here - c0);
        auto epi = [&](int i, int jj, float v) {
          const int col = ccol + c0 + jj;
          if (prev != nullptr) v += tl_ldcg(prev + static_cast<long>(i) * n_sub + col);
          if (send != nullptr) {
            send[static_cast<long>(i) * n_sub + col] = tl_from_float<AccT>(v);
          } else {
            const int b = i / m_loc;
            const int ii = i % m_loc;
            out[(static_cast<long>(rl * B + b) * m_loc + ii) * N + static_cast<long>(c) * n_sub + col] =
                tl_from_float<T>(v);
          }
        };
        tile_gemm(A, r0, m, wr.cols(c0), n, K, sm, epi);
      }
    }
    if (send != nullptr) peer_tile_notify(&t.flags(dst_tbl[f])[(s * nch + c) * n_tiles + j], epoch(), t.sys);
  }
  __syncthreads();
  if (threadIdx.x == 0) tl_exit_epoch(t, epoch(), gridDim.x * gridDim.y * gridDim.z);
}


template <typename AccT>
struct RsArgs {
  const float* scale;  // packed weights: [H, N] (else null)
  const float* zero;
  __nv_bfloat16* out;
  PeerTbl t;  // recv slots [W*nch, B*m_loc*n_sub] and flags [W, nch, MT, NT] of every rank
  const int* seg_tbl;
  const int* dst_tbl;
  int W, nch, B, M, K, N, n_sub, m_loc, IB, MT, NT, items, align;  // align: box starts, 8 (bf16) or 16 (int8)
};

__device__ __forceinline__ void rs_store2(float* p, float v0, float v1) { *reinterpret_cast<float2*>(p) = make_float2(v0, v1); }
__device__ __forceinline__ void rs_store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// PACKED: map_b holds the int8 codes (a Q box per stage, wg_dequant_b).
template <typename AccT, bool PACKED>
__global__ void __launch_bounds__(wg::THREADS, 1)
    gemm_rs_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                         const __grid_constant__ RsArgs<AccT> a) {
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
  const int e = s_epoch;
  const int nk = (a.K + wg::BK - 1) / wg::BK;
  RingPos pos;

  if (threadIdx.x >= wg::CONSUMERS) {  // ---- producer warp: TMA loads of x and w
    if (threadIdx.x != wg::CONSUMERS) return;
    for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
      const WgItem x = wg_item(it, t.held, nch, a.NT, a.MT);
      const int s = x.s, rl = x.r, r = t.rank0 + x.r, c = x.c, nt = x.nt, mt = x.mt;
      const int seg = a.seg_tbl[(c * W + s) * W + r];
      const int bp = mt / a.IB, ib = mt % a.IB;
      const int col = c * a.n_sub - (c * a.n_sub) % a.align + nt * wg::BN;  // 16-byte aligned box start
      auto load = [&](int kb, uint8_t* sa, uint8_t* sb, uint64_t* bar) {
        wg_tma_4d(sa, &map_a, bar, kb * wg::BK, seg * a.m_loc + ib * 64, 2 * bp, rl);
        wg_tma_3d(sb, &map_b, bar, col, kb * wg::BK, rl);  // PACKED: the whole Q box
        if (!PACKED) wg_tma_3d(sb + wg::B_BYTES / 2, &map_b, bar, col + 64, kb * wg::BK, rl);
      };
      wg_produce(ring, pos, nk, load, PACKED ? wg::LOAD_BYTES_Q : wg::STAGE_BYTES);
    }
    return;
  }

  // ---- two consumer warpgroups: wgmma, then the reduce-scatter epilogue
  const int wgi = threadIdx.x / 128;
  const auto consumers = [] { wg_consumer_sync(); };  // their named barrier (the producer warp has returned)
  const long slot_elems = static_cast<long>(a.B) * a.m_loc * a.n_sub;
  float acc[wg::ACC];
#pragma unroll
  for (int j = 0; j < wg::ACC; ++j) acc[j] = 0.f;
  for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
    const WgItem x = wg_item(it, t.held, nch, a.NT, a.MT);
    const int s = x.s, rl = x.r, r = t.rank0 + x.r, c = x.c, nt = x.nt, mt = x.mt;
    const int dst = a.dst_tbl[(c * W + s) * W + r];
    const int bp = mt / a.IB, ib = mt % a.IB;
    const int lead = (c * a.n_sub) % a.align;  // the box starts `lead` columns before the channel
    const int col0 = nt * wg::BN - lead;        // channel column of tile column 0
    if constexpr (PACKED) {
      const long wcol = static_cast<long>(rl) * a.N + c * a.n_sub + col0;  // [H, N] index of tile column 0
      auto dequant = [&](int kb, const uint8_t* box) {
        wg_dequant_b(box + wg::STAGE_BYTES, const_cast<uint8_t*>(box) + wg::A_BYTES, a.zero + wcol,
                     a.N - (c * a.n_sub + col0), kb * wg::BK, a.K);
      };
      wg_mainloop(ring, pos, nk, wgi, acc, dequant);
    } else {
      wg_mainloop(ring, pos, nk, wgi, acc);
    }

    const int fl = (c * a.MT + mt) * a.NT + nt;  // flag offset inside (rank, stage)
    const AccT* prev = nullptr;
    if (s > 0) {
      peer_tile_wait_synced(&t.flags(r)[(s - 1) * nch * a.MT * a.NT + fl], e, t.sys, consumers);
      prev = t.slots<AccT>(r) + (static_cast<long>(s - 1) * nch + c) * slot_elems;
    }
    AccT* send = nullptr;
    if (s < W - 1) {
      peer_entry_wait_synced(t, r, dst, e, consumers);  // dst's last call has read its recv slots
      send = t.slots<AccT>(dst) + (static_cast<long>(s) * nch + c) * slot_elems;
    }
    // rows and the channel column of a tile element; false where it is masked
    auto at = [&](int row, int col, int& b, int& i, int& cc) {
      b = 2 * bp + row / 64;
      i = ib * 64 + row % 64;
      cc = col0 + col;  // even (n_sub and lead are), < n_sub
      return b < a.B && i < a.m_loc && cc >= 0;
    };
    if constexpr (PACKED) {  // pass 0: the packed weight's per-column scale on the float32 sum
      const float* srow = a.scale + static_cast<long>(rl) * a.N + c * a.n_sub;
      auto scale = [&](int row, int col, float& v0, float& v1) {
        int b, i, cc;
        if (!at(row, col, b, i, cc)) return;
        v0 *= __ldg(srow + cc);
        v1 *= __ldg(srow + cc + 1);
      };
      wg_epilogue(acc, wgi, wg::BM, a.n_sub - col0, scale);
    }
    if (prev != nullptr) {  // pass 1: add the partial received last stage (loads only)
      auto add = [&](int row, int col, float& v0, float& v1) {
        int b, i, cc;
        if (!at(row, col, b, i, cc)) return;
        const long pe = (static_cast<long>(b) * a.m_loc + i) * a.n_sub + cc;
        v0 += tl_ldcg(prev + pe);
        v1 += tl_ldcg(prev + pe + 1);
      };
      wg_epilogue(acc, wgi, wg::BM, a.n_sub - col0, add);
    }
    auto epi = [&](int row, int col, float& v0, float& v1) {  // pass 2: store
      int b, i, cc;
      if (!at(row, col, b, i, cc)) return;
      if (send != nullptr) {
        rs_store2(send + (static_cast<long>(b) * a.m_loc + i) * a.n_sub + cc, v0, v1);
      } else {
        rs_store2(a.out + ((static_cast<long>(rl) * a.B + b) * a.m_loc + i) * a.N + static_cast<long>(c) * a.n_sub + cc,
                  v0, v1);
      }
    };
    wg_epilogue(acc, wgi, wg::BM, a.n_sub - col0, epi);
    if (send != nullptr) {
      peer_tile_notify_synced(&t.flags(dst)[s * nch * a.MT * a.NT + fl], e, t.sys, consumers);
    }
  }
  consumers();
  if (threadIdx.x == 0) tl_exit_epoch(t, e, gridDim.x);
}

template <typename AccT>
static int launch_wgmma(const void* x, const void* w, const void* scale, const void* zero, void* out, PeerTbl t,
                        const void* seg_tbl, const void* dst_tbl, int* info, int W, int nch, int B, int M, int K,
                        int N, int n_sub, cudaStream_t st) {
  const bool packed = scale != nullptr;
  const int align = packed ? 16 : 8;  // a 16-byte box start, in elements of the B operand
  const int m_loc = M / W;
  const int IB = (m_loc + 63) / 64;
  int lead = 0;  // widest shift of a channel's first column down to a 16-byte boundary
  for (int c = 1; c < nch; ++c) lead = max(lead, (c * n_sub) % align);
  RsArgs<AccT> a{static_cast<const float*>(scale), static_cast<const float*>(zero), static_cast<__nv_bfloat16*>(out),
                 t, static_cast<const int*>(seg_tbl), static_cast<const int*>(dst_tbl), W, nch, B, M, K, N, n_sub,
                 m_loc, IB, (B + 1) / 2 * IB, (n_sub + lead + wg::BN - 1) / wg::BN, 0, align};
  a.items = t.held * W * nch * a.MT * a.NT;
  CUtensorMap map_a, map_b;
  // A: x as [H, B, M, K] in boxes of (64 of K, 64 rows, 2 batches, 1 rank); B: w as [H, K, N]
  const cuuint64_t da[4] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)B, (cuuint64_t)t.held};
  const cuuint64_t sa[3] = {(cuuint64_t)K, (cuuint64_t)M * K, (cuuint64_t)B * M * K};
  const cuuint32_t ba[4] = {wg::BK, 64, 2, 1};
  const cuuint64_t db[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)t.held};
  const cuuint64_t sb[2] = {(cuuint64_t)N, (cuuint64_t)K * N};
  const cuuint32_t bb[3] = {packed ? static_cast<cuuint32_t>(wg::BN) : 64u, wg::BK, 1};  // packed: one int8 Q box
  int rc = wg_tensor_map(&map_a, x, 4, da, sa, ba);
  if (rc == 0) rc = wg_tensor_map(&map_b, w, 3, db, sb, bb, packed);
  static int resident[2] = {0, 0};
  const void* kernel = packed ? reinterpret_cast<const void*>(gemm_rs_wgmma_kernel<AccT, true>)
                              : reinterpret_cast<const void*>(gemm_rs_wgmma_kernel<AccT, false>);
  const int smem = packed ? wg::SMEM_BYTES_Q : wg::SMEM_BYTES;
  int grid = 0;
  if (rc == 0) rc = wg_grid(kernel, a.items, &resident[packed], &grid, smem);
  if (rc != 0) return rc;
  info[0] = grid;
  info[1] = a.items;
  void* args[] = {&map_a, &map_b, &a};
  cudaError_t e = cudaLaunchCooperativeKernel(const_cast<void*>(kernel), dim3(grid), dim3(wg::THREADS), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename AccT, typename WB>
static int launch_f32(const void* x, WB wb, void* out, PeerTbl t, const void* seg_tbl, const void* dst_tbl, int W,
                      int nch, int n_tiles, int B, int M, int K, int N, int n_sub, int bn, cudaStream_t st) {
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  const int* sp = static_cast<const int*>(seg_tbl);
  const int* dp = static_cast<const int*>(dst_tbl);
  void* args[] = {&xp, &wb, &op, &t, &sp, &dp, &W, &nch, &n_tiles, &B, &M, &K, &N, &n_sub, &bn};
  const dim3 grid(n_tiles, nch, t.held);
  // co-residency: every block spins on flags other blocks set
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gemm_rs_kernel<float, AccT, WB>), grid,
                                              dim3(TG_THREADS), args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename AccT>
static int launch_f32_w(const void* x, const void* w, const void* scale, const void* zero, void* out, PeerTbl t,
                        const void* seg_tbl, const void* dst_tbl, int W, int nch, int n_tiles, int B, int M, int K,
                        int N, int n_sub, int bn, cudaStream_t st) {
  if (scale != nullptr) {
    const PackedB wb{static_cast<const int8_t*>(w), static_cast<const float*>(scale), static_cast<const float*>(zero),
                     N};
    return launch_f32<AccT>(x, wb, out, t, seg_tbl, dst_tbl, W, nch, n_tiles, B, M, K, N, n_sub, bn, st);
  }
  const PlainB<float> wb{static_cast<const float*>(w), N};
  return launch_f32<AccT>(x, wb, out, t, seg_tbl, dst_tbl, W, nch, n_tiles, B, M, K, N, n_sub, bn, st);
}

// float32 route, wire dtype wire_dtype (0 float32, 1 bfloat16: the recv slots'
// dtype); the bf16 route is tl_gemm_rs_wgmma.  scale / zero non-null: w is a
// packed weight's int8 codes [H, K, N] with scale / zero [H, N].  regions:
// the W ranks' receive regions (a host PeerArgs, tile_sync.cuh); the launch
// runs its held ranks [rank0, rank0 + held).
extern "C" int tl_gemm_rs(int wire_dtype, const void* x, const void* w, const void* scale, const void* zero, void* out,
                          const void* regions, const void* seg_tbl, const void* dst_tbl, int W, int nch, int n_tiles,
                          int B, int M, int K, int N, int n_sub, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PeerTbl t;
  if (!tl_peer_tbl(&t, regions, W)) return static_cast<int>(cudaErrorInvalidValue);
  if (wire_dtype == 0)
    return launch_f32_w<float>(x, w, scale, zero, out, t, seg_tbl, dst_tbl, W, nch, n_tiles, B, M, K, N, n_sub, bn,
                               st);
  if (wire_dtype == 1)
    return launch_f32_w<__nv_bfloat16>(x, w, scale, zero, out, t, seg_tbl, dst_tbl, W, nch, n_tiles, B, M, K, N,
                                       n_sub, bn, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 route, wire dtype wire_dtype (0 float32, 1 bfloat16).  info (host
// int[2]) receives the grid G and the item count.  K and N must be multiples
// of 8 (N of 16 with a packed weight), N / nch even and the operands 16-byte
// aligned (the wrapper checks).  scale / zero non-null: w is a packed
// weight's int8 codes [H, K, N] with scale / zero [H, N].  regions: as tl_gemm_rs's.
extern "C" int tl_gemm_rs_wgmma(int wire_dtype, const void* x, const void* w, const void* scale, const void* zero,
                                void* out, const void* regions, const void* seg_tbl, const void* dst_tbl, void* info,
                                int W, int nch, int B, int M, int K, int N, int n_sub, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* inf = static_cast<int*>(info);
  PeerTbl t;
  if (!tl_peer_tbl(&t, regions, W)) return static_cast<int>(cudaErrorInvalidValue);
  if (wire_dtype == 0)
    return launch_wgmma<float>(x, w, scale, zero, out, t, seg_tbl, dst_tbl, inf, W, nch, B, M, K, N, n_sub, st);
  if (wire_dtype == 1)
    return launch_wgmma<__nv_bfloat16>(x, w, scale, zero, out, t, seg_tbl, dst_tbl, inf, W, nch, B, M, K, N, n_sub,
                                       st);
  return static_cast<int>(cudaErrorInvalidValue);
}
