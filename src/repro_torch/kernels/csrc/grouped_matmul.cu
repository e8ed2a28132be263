// Grouped (MoE expert) GEMM driven by an on-device tile -> expert table.
//
// Replaces src/repro/kernels/grouped_matmul.py::grouped_matmul: rows of x are
// expert-sorted and tile-aligned, and row tile t is multiplied by the weight
// of expert tile_expert[t] — the paper's dynamic mapping f_R.  On the TPU the
// table is a scalar-prefetch operand that the BlockSpec index map reads to
// pick the weight block to DMA; here the kernel reads each tile's entry from
// device memory and points its loads at that expert's weight, so one launch
// covers every expert and no host code splits the work per expert.  An
// entry outside [0, E) marks an empty tile: its rows are stored as 0.  Two
// routes, chosen by dtype:
//
// bf16: the persistent wgmma GEMM of wgmma_gemm.cu (TMA ring, 128 x 128
//   tiles, every SM, the expert's weight through a 3-D tensor map); it
//   stores float32 (the MoE gate|up product stays float32 for the SiLU-mul
//   that follows it, as in the JAX package) or bf16.  Its design and bound
//   are noted there.  K and N must be multiples of 8.
//
// float32 (grouped_matmul_kernel): grid (row tile, 128-column tile); a row
//   tile of bm rows is walked in 64-row sub-tiles of tile_gemm.cuh, with the
//   K loop inside.  Bound: fp32 FMA issue (67 TFLOP/s); the products stay
//   exact float32.
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

__global__ void __launch_bounds__(TG_THREADS)
    grouped_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const int* __restrict__ tile_expert, float* __restrict__ out, int N, int K, int E, int bm) {
  __shared__ __align__(16) TileGemmSmem sm;
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * TG_BN;
  const int n = min(TG_BN, N - c0);
  const int e = tile_expert[t];  // f_R: the routing table, read on the device
  const int row_end = (t + 1) * bm;
  if (e < 0 || e >= E) {
    for (int idx = threadIdx.x; idx < bm * n; idx += TG_THREADS) {
      out[static_cast<long>(t * bm + idx / n) * N + c0 + idx % n] = 0.f;
    }
    return;
  }
  const float* B = w + static_cast<long>(e) * K * N + c0;
  const RowsA<float> A{x, K, 1 << 30, 0};
  auto epi = [&](int i, int j, float v) { out[static_cast<long>(i) * N + c0 + j] = v; };
  for (int r0 = t * bm; r0 < row_end; r0 += TG_BM) {
    tile_gemm(A, r0, min(TG_BM, row_end - r0), B, N, n, K, sm, epi);
  }
}

// dtype / out_dtype: 0 = float32, 1 = bfloat16; float32 stores float32,
// bfloat16 stores float32 or bfloat16.  info (host int[2]) receives the bf16
// route's grid G and item count.
extern "C" int tl_grouped_matmul(int dtype, int out_dtype, const void* x, const void* w, const void* tile_expert,
                                 void* out, void* info, int n_tiles, int N, int K, int E, int bm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (out_dtype == 0 || out_dtype == 1))
    return wgmma_gemm(out_dtype == 0, x, w, tile_expert, out, n_tiles, bm, N, K, E, static_cast<int*>(info), st);
  if (dtype != 0 || out_dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_tiles, (N + TG_BN - 1) / TG_BN);
  grouped_matmul_kernel<<<grid, TG_THREADS, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                                     static_cast<const int*>(tile_expert), static_cast<float*>(out),
                                                     N, K, E, bm);
  return static_cast<int>(cudaGetLastError());
}
