// Mamba-2 SSD intra-chunk term: y = (CB * exp(cum_i - cum_j) * [i >= j]) @ xdt
// per tile.
//
// Replaces src/repro/kernels/mamba_ssd.py::ssd_intra_chunk (_ssd_intra_kernel):
// a grid of T tiles (T = batch x chunks x heads), each tile cum [Q], the C.B
// scores cb [Q, Q] and the dt-weighted inputs xdt [Q, P]; fp32 math, the
// output cast to xdt's dtype.  On the TPU one grid step holds the tile in
// VMEM, forms the decay-masked matrix G and hands G @ xdt to the MXU.  Here
// one block of 256 threads owns one tile:
//
//   * cum, G and xdt are staged in shared memory as fp32 (about 33 KB at
//     Q = P = 64; G rows padded by one word so the two row groups of a warp
//     read different banks);
//   * G[i][j] = cb[i][j] * exp(cum[i] - cum[j]) is formed once per element,
//     and exp is taken only where i >= j: the upper triangle is stored as 0
//     and never exponentiated, so a positive difference cannot overflow;
//   * each thread accumulates a 4 x 4 register tile of y with fp32 FMAs —
//     rows ty, ty + 16, ty + 32, ty + 48 (strided, so every thread gets an
//     even share of the triangle) and columns tx, tx + 16, tx + 32, tx + 48 —
//     looping j only up to its last row (G is 0 above the diagonal);
//   * Q <= 64 and P <= 64 are any values (chunk 16 and headdim 16 in the CPU
//     tests' config, 64 and 64 on the mamba2-2.7b path); staging is
//     zero-filled past Q and P, and stores are masked.
//
// Bound on this card: at the serve path's shapes (T = 1280, Q = P = 64,
// fp32) the work is 2 Q^2 P + 2 Q^2 flops per tile against 4 (Q + Q^2 + 2 Q P)
// bytes, about 10 flops per byte — the bytes (63 MB in all, 0.019 ms at
// 3.35 TB/s) bound it, not the 67 TFLOP/s of fp32 FMA.  This first version
// spends half its FMAs on the zero upper triangle of the rows it owns and
// stages through shared memory without cp.async; skipping masked work and a
// TMA / wgmma pipeline are later work.
#include "tile_gemm.cuh"

constexpr int SSD_Q = 64;  // largest chunk length
constexpr int SSD_P = 64;  // largest head dim
constexpr int SSD_THREADS = 256;
constexpr int SSD_GS = SSD_Q + 1;  // padded G row

template <typename T>
__global__ void __launch_bounds__(SSD_THREADS)
    ssd_intra_kernel(const T* __restrict__ cum, const T* __restrict__ cb, const T* __restrict__ xdt,
                     T* __restrict__ y, int Q, int P) {
  __shared__ float s_cum[SSD_Q];
  __shared__ float s_g[SSD_Q][SSD_GS];
  __shared__ __align__(16) float s_x[SSD_Q][SSD_P];
  const long t = blockIdx.x;
  const T* cum_t = cum + t * Q;
  const T* cb_t = cb + t * Q * Q;
  const T* x_t = xdt + t * Q * P;
  T* y_t = y + t * Q * P;
  const int tid = threadIdx.x;

  for (int i = tid; i < SSD_Q; i += SSD_THREADS) s_cum[i] = i < Q ? tl_ld(cum_t + i) : 0.f;
  for (int idx = tid; idx < SSD_Q * SSD_P; idx += SSD_THREADS) {
    const int j = idx / SSD_P, p = idx % SSD_P;
    s_x[j][p] = (j < Q && p < P) ? tl_ld(x_t + j * P + p) : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < SSD_Q * SSD_Q; idx += SSD_THREADS) {
    const int i = idx / SSD_Q, j = idx % SSD_Q;
    float g = 0.f;
    if (i < Q && j <= i) g = tl_ld(cb_t + i * Q + j) * expf(s_cum[i] - s_cum[j]);
    s_g[i][j] = g;
  }
  __syncthreads();

  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4] = {};
  const int last = min(Q - 1, ty + 48);  // the highest row this thread owns
  for (int j = 0; j <= last; ++j) {
    float g[4], xv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) g[a] = s_g[ty + 16 * a][j];
#pragma unroll
    for (int c = 0; c < 4; ++c) xv[c] = s_x[j][tx + 16 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(g[a], xv[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = tx + 16 * c;
      if (i < Q && p < P) y_t[i * P + p] = tl_from_float<T>(acc[a][c]);
    }
  }
}

template <typename T>
static int launch(const void* cum, const void* cb, const void* xdt, void* y, int T_, int Q, int P, cudaStream_t st) {
  ssd_intra_kernel<T><<<T_, SSD_THREADS, 0, st>>>(static_cast<const T*>(cum), static_cast<const T*>(cb),
                                                  static_cast<const T*>(xdt), static_cast<T*>(y), Q, P);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16 (cum, cb, xdt and y all of it)
extern "C" int tl_ssd_intra_chunk(int dtype, const void* cum, const void* cb, const void* xdt, void* y, int T, int Q,
                                  int P, void* stream) {
  if (T < 1 || Q < 1 || Q > SSD_Q || P < 1 || P > SSD_P) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(cum, cb, xdt, y, T, Q, P, st);
  if (dtype == 1) return launch<__nv_bfloat16>(cum, cb, xdt, y, T, Q, P, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
