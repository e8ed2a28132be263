// Mamba-2 SSD intra-chunk term: y = (CB * exp(cum_i - cum_j) * [i >= j]) @ xdt
// per tile.
//
// Replaces src/repro/kernels/mamba_ssd.py::ssd_intra_chunk (_ssd_intra_kernel):
// a grid of T tiles (T = batch x chunks x heads), each tile cum [Q], the C.B
// scores cb [Q, Q] and the dt-weighted inputs xdt [Q, P]; fp32 math, the
// output cast to xdt's dtype.  On the TPU one grid step holds the tile in
// VMEM, forms the decay-masked matrix G and hands G @ xdt to the MXU.
//
// Bound on this card: at the serve path's shapes (T = 1280, Q = P = 64) the
// triangle is T x 2080 x 64 x 2 = 0.34 GFLOP, 0.005 ms of the card's
// 67 TFLOP/s of f32 FMA, against 4 (Q + Q^2 + 2 Q P) bytes a tile read and
// written once: 63 MB in f32 (0.0189 ms at 3.35 TB/s), 32 MB in bf16
// (0.0094 ms).  By that roofline the bytes bound it, so the products stay
// f32 FMAs in both dtypes and the design keeps loads in flight.  Measured on
// the H100 (PERF.md) it runs at about 2x (f32) and 3.5x (bf16) that bound,
// and taking the loads out changes little: forming G and the FMA products,
// issued by 8 (f32) or 16 (bf16) warps an SM, hold it, not the bytes.
//
//   * a persistent grid: G = min(T, resident blocks x SMs) blocks of 128
//     threads; block b walks tiles b, b + G, b + 2G, ...;
//   * a tile's raw bytes (cum, cb, xdt in the input dtype, in their own
//     layouts) land in a shared-memory stage while the block computes the
//     tile before.  Two staging paths, chosen by shape before the launch:
//       - bulk (Q and P times the element size multiples of 16 bytes,
//         16-byte aligned bases: the mamba2 path in f32 and bf16): a ring of
//         2 stages filled by three 1-D cp.async.bulk copies on an mbarrier;
//         a stage is refilled, two tiles ahead, as soon as its tile is done;
//       - registers (any other Q, P, such as 37 x 23): each thread loads its
//         share of tile t + G's cum and cb into registers at the start of
//         tile t, while tile t's G is formed, and writes it to the one stage
//         before tile t's products (the registers are free again for them);
//         x is copied into the stage as G is formed;
//   * from the stage, G[i][j] = cb[i][j] * exp(cum[i] - cum[j]) is formed in
//     f32 once per element and only for j <= i (the upper triangle is never
//     exponentiated, so a large positive difference cannot overflow, and
//     never read); the products read x from the stage in its own dtype (one
//     16- or 8-byte load per quad on the bulk path) and convert in registers;
//   * thread (a, c) of the 16 x 8 thread grid owns rows a, 31 - a, 32 + a,
//     63 - a and the column quads 4c and 32 + 4c (8 threads read 128 or 64
//     contiguous bytes of an x row: no bank conflict): the rows' lengths add
//     to 130 for every a, and the j loop runs in four segments (4, 3, 2, then
//     1 live rows), so every thread computes the same 130 x 8 products of the
//     triangle and none above it (mamba_ssd.thread_pairs models it); each
//     step's loads are issued a step ahead;
//   * Q <= 64 and P <= 64 are any values: rows at or past Q get G = 0 and
//     are not stored, columns past P are not stored; stores are float4 /
//     4 x bf16 where P is a multiple of 4, else scalar.
#include "tile_gemm.cuh"
#include "wgmma_tile.cuh"

constexpr int SSD_Q = 64;  // largest chunk length
constexpr int SSD_P = 64;  // largest head dim
constexpr int SSD_THREADS = 128;
constexpr int SSD_GS = SSD_Q + 1;  // padded G row: the 4 rows a warp reads per j sit in 4 banks
constexpr int SSD_G_BYTES = 4 * SSD_Q * SSD_GS;

template <typename E>
struct SsdStage {
  static constexpr int CUM = 256;  // bytes kept for cum (64 x 4)
  static constexpr int CB = SSD_Q * SSD_Q * sizeof(E);
  static constexpr int X = SSD_Q * SSD_P * sizeof(E);
  static constexpr int BYTES = CUM + CB + X;
};

template <bool BULK, typename E>
constexpr int ssd_smem_bytes() {
  return SSD_G_BYTES + (BULK ? 2 : 1) * SsdStage<E>::BYTES;
}

// a 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned), completing on `bar`
__device__ __forceinline__ void ssd_bulk(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                   wg_smem(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(wg_smem(bar))
               : "memory");
}

// four x values at p as f32: one 16-byte (f32) or 8-byte (bf16) load where
// the row is aligned (VEC: the bulk path), else four scalar loads
template <bool VEC>
__device__ __forceinline__ float4 ssd_quad(const float* p) {
  if constexpr (VEC) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}
template <bool VEC>
__device__ __forceinline__ float4 ssd_quad(const __nv_bfloat16* p) {
  if constexpr (VEC) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return make_float4(tl_ld(p), tl_ld(p + 1), tl_ld(p + 2), tl_ld(p + 3));
}

// acc[r][c] += G[row[r]][j] x[j][col c] for the live rows FIRST..3 over j in
// [j0, j1); x rows are ld elements apart and the thread's columns are the
// quads at x0 and x0 + 32.  The loads of step j + 1 are issued before the
// products of step j.
template <int FIRST, bool VEC, typename E>
__device__ __forceinline__ void ssd_rows(float (&acc)[4][8], const float* gs, const int (&row)[4], const E* x0, int ld,
                                         int j0, int j1) {
  if (j0 >= j1) return;
  float4 xa = ssd_quad<VEC>(x0 + j0 * ld), xb = ssd_quad<VEC>(x0 + j0 * ld + 32);
  float g[4];
#pragma unroll
  for (int r = FIRST; r < 4; ++r) g[r] = gs[row[r] * SSD_GS + j0];
  for (int j = j0; j < j1; ++j) {
    const int jn = min(j + 1, j1 - 1);  // the last step loads its own operands again
    const float4 na = ssd_quad<VEC>(x0 + jn * ld), nb = ssd_quad<VEC>(x0 + jn * ld + 32);
    float ng[4];
#pragma unroll
    for (int r = FIRST; r < 4; ++r) ng[r] = gs[row[r] * SSD_GS + jn];
    const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int r = FIRST; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(g[r], xv[c], acc[r][c]);
      g[r] = ng[r];
    }
    xa = na;
    xb = nb;
  }
}

__device__ __forceinline__ void ssd_store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void ssd_store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]), __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <typename E, bool BULK>
__global__ void __launch_bounds__(SSD_THREADS)
    ssd_intra_kernel(const E* __restrict__ cum, const E* __restrict__ cb, const E* __restrict__ xdt,
                     E* __restrict__ y, int T, int Q, int P) {
  using St = SsdStage<E>;
  extern __shared__ __align__(16) uint8_t ssd_smem[];
  __shared__ __align__(8) uint64_t full[2];
  float* gs = reinterpret_cast<float*>(ssd_smem);  // [SSD_Q][SSD_GS] f32, j <= i only
  uint8_t* stages = ssd_smem + SSD_G_BYTES;
  const int tid = threadIdx.x;
  const int G = gridDim.x;
  const int QQ = Q * Q, QP = Q * P;

  // ---- staging: bulk copies two tiles ahead, or a register prefetch of the next tile
  constexpr int NCB = SSD_Q * SSD_Q / SSD_THREADS;
  E pre_cum, pre_cb[NCB];  // the register path's prefetch of cum and cb (unused by the bulk path)
  auto issue = [&](int tile, int s) {
    uint8_t* st = stages + s * St::BYTES;
    const uint32_t b_cum = Q * sizeof(E), b_cb = QQ * sizeof(E), b_x = QP * sizeof(E);
    wg_mbar_expect_tx(&full[s], b_cum + b_cb + b_x);
    ssd_bulk(st, cum + static_cast<long>(tile) * Q, b_cum, &full[s]);
    ssd_bulk(st + St::CUM, cb + static_cast<long>(tile) * QQ, b_cb, &full[s]);
    ssd_bulk(st + St::CUM + St::CB, xdt + static_cast<long>(tile) * QP, b_x, &full[s]);
  };
  auto write_stage = [&](uint8_t* st) {
    E* w_cb = reinterpret_cast<E*>(st + St::CUM);
    if (tid < Q) reinterpret_cast<E*>(st)[tid] = pre_cum;
#pragma unroll
    for (int k = 0; k < NCB; ++k)
      if (tid + k * SSD_THREADS < QQ) w_cb[tid + k * SSD_THREADS] = pre_cb[k];
  };
  auto prefetch = [&](int tile) {
    if (tid < Q) pre_cum = cum[static_cast<long>(tile) * Q + tid];
#pragma unroll
    for (int k = 0; k < NCB; ++k)
      if (tid + k * SSD_THREADS < QQ) pre_cb[k] = cb[static_cast<long>(tile) * QQ + tid + k * SSD_THREADS];
  };
  if constexpr (BULK) {
    if (tid == 0) {
      wg_mbar_init(&full[0], 1);
      wg_mbar_init(&full[1], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      issue(blockIdx.x, 0);
      if (blockIdx.x + G < T) issue(blockIdx.x + G, 1);
    }
  } else {
    prefetch(blockIdx.x);
    write_stage(stages);
    __syncthreads();
  }

  const int tx = tid & 7, a = tid >> 3;
  const int row[4] = {a, 31 - a, 32 + a, 63 - a};
  for (int k = 0, tile = blockIdx.x; tile < T; ++k, tile += G) {
    const int s = BULK ? (k & 1) : 0;
    uint8_t* st = stages + s * St::BYTES;
    const E* cum_s = reinterpret_cast<const E*>(st);
    const E* cb_s = reinterpret_cast<const E*>(st + St::CUM);
    E* x_s = reinterpret_cast<E*>(st + St::CUM + St::CB);  // [Q][P] as in device memory
    if constexpr (BULK) {
      wg_mbar_wait(&full[s], (k >> 1) & 1);
    } else {
      if (tile + G < T) prefetch(tile + G);  // in flight while this tile's G is formed
      const E* x_t = xdt + static_cast<long>(tile) * QP;
      for (int idx = tid; idx < QP; idx += SSD_THREADS) x_s[idx] = x_t[idx];
    }
    // G in f32, j <= i only; rows at or past Q are zero
#pragma unroll
    for (int idx = tid; idx < SSD_Q * SSD_Q; idx += SSD_THREADS) {
      const int i = idx >> 6, j = idx & 63;
      if (j <= i) gs[i * SSD_GS + j] = i < Q ? tl_ld(cb_s + i * Q + j) * expf(tl_ld(cum_s + i) - tl_ld(cum_s + j)) : 0.f;
    }
    __syncthreads();
    if constexpr (!BULK) {
      if (tile + G < T) write_stage(st);  // cum and cb are read: the next tile's go in
    }

    // the products, x read from the stage (rows past Q and columns past P
    // read stage bytes that are never stored)
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
    const E* x0 = x_s + 4 * tx;
    ssd_rows<0, BULK>(acc, gs, row, x0, P, 0, row[0] + 1);
    ssd_rows<1, BULK>(acc, gs, row, x0, P, row[0] + 1, row[1] + 1);
    ssd_rows<2, BULK>(acc, gs, row, x0, P, row[1] + 1, row[2] + 1);
    ssd_rows<3, BULK>(acc, gs, row, x0, P, row[2] + 1, row[3] + 1);

    E* y_t = y + static_cast<long>(tile) * QP;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (row[r] >= Q) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c0 = 32 * h + 4 * tx;
        if (c0 >= P) continue;
        if (P % 4 == 0) {
          ssd_store4(y_t + row[r] * P + c0, &acc[r][4 * h]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + c < P) y_t[row[r] * P + c0 + c] = tl_from_float<E>(acc[r][4 * h + c]);
        }
      }
    }
    __syncthreads();  // G and the stage are read before they are rewritten
    if constexpr (BULK) {
      if (tid == 0 && tile + 2 * G < T) issue(tile + 2 * G, s);  // refill the stage just read
    }
  }
}

// The persistent grid of one instantiation: min(T, co-resident blocks); the
// resident count is cached (one card per process).
template <typename E, bool BULK>
static int ssd_launch(const void* cum, const void* cb, const void* xdt, void* y, int T, int Q, int P, int* info,
                      cudaStream_t st) {
  auto kernel = ssd_intra_kernel<E, BULK>;
  constexpr int smem = ssd_smem_bytes<BULK, E>();
  static int resident = 0;
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0, dev = 0, sms = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SSD_THREADS, smem)) != cudaSuccess)
      return static_cast<int>(e);
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident = per_sm * sms;
  }
  const int grid = T < resident ? T : resident;
  info[0] = grid;
  info[1] = BULK ? 1 : 0;
  kernel<<<grid, SSD_THREADS, smem, st>>>(static_cast<const E*>(cum), static_cast<const E*>(cb),
                                          static_cast<const E*>(xdt), static_cast<E*>(y), T, Q, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
static int ssd_dispatch(const void* cum, const void* cb, const void* xdt, void* y, int T, int Q, int P, int* info,
                        cudaStream_t st) {
  // the bulk path: every slab of a tile and every x row a 16-byte multiple at 16-byte aligned addresses
  const bool aligned = (reinterpret_cast<uintptr_t>(cum) | reinterpret_cast<uintptr_t>(cb) |
                        reinterpret_cast<uintptr_t>(xdt)) % 16 == 0;
  if (aligned && (Q * sizeof(E)) % 16 == 0 && (P * sizeof(E)) % 16 == 0)
    return ssd_launch<E, true>(cum, cb, xdt, y, T, Q, P, info, st);
  return ssd_launch<E, false>(cum, cb, xdt, y, T, Q, P, info, st);
}

// dtype: 0 = float32, 1 = bfloat16 (cum, cb, xdt and y all of it); info (host
// int[2]) receives the grid G and the staging path (1 bulk, 0 registers).
extern "C" int tl_ssd_intra_chunk(int dtype, const void* cum, const void* cb, const void* xdt, void* y, int T, int Q,
                                  int P, void* info, void* stream) {
  if (T < 1 || Q < 1 || Q > SSD_Q || P < 1 || P > SSD_P) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* inf = static_cast<int*>(info);
  if (dtype == 0) return ssd_dispatch<float>(cum, cb, xdt, y, T, Q, P, inf, st);
  if (dtype == 1) return ssd_dispatch<__nv_bfloat16>(cum, cb, xdt, y, T, Q, P, inf, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
