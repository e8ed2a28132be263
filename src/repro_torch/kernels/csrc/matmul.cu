// Standalone tile GEMM: out[M, N] = x[M, K] @ w[K, N], fp32 accumulation,
// cast at store.
//
// Replaces src/repro/kernels/matmul.py::matmul (_matmul_kernel): a
// (M/bm, N/bn, K/bk) grid with the K dimension innermost and a VMEM fp32
// accumulator.  Two routes, chosen by dtype:
//
// bf16: the persistent wgmma GEMM of wgmma_gemm.cu (TMA ring, 128 x 128
//   tiles, every SM), with one row tile of M rows and one expert; its
//   design and bound are noted there.  K and N must be multiples of 8.
//
// float32 (matmul_kernel): one block owns a (bm, bn) output region and walks
//   it in 64 x 128 tiles of tile_gemm.cuh, with the K loop inside the tile;
//   unlike the TPU kernel, bm / bn need not divide M / N (ragged edges are
//   masked).  Bound: fp32 FMA issue (67 TFLOP/s); the products stay exact
//   float32 (on tensor cores they would be TF32).
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

__global__ void __launch_bounds__(TG_THREADS)
    matmul_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out, int M, int N,
                  int K, int bm, int bn) {
  __shared__ __align__(16) TileGemmSmem sm;
  const int m0 = blockIdx.y * bm;
  const int n0 = blockIdx.x * bn;
  const int m_end = min(m0 + bm, M);
  const int n_end = min(n0 + bn, N);
  const RowsA<float> A{x, K, 1 << 30, 0};
  for (int r0 = m0; r0 < m_end; r0 += TG_BM) {
    for (int c0 = n0; c0 < n_end; c0 += TG_BN) {
      const int m = min(TG_BM, m_end - r0);
      const int n = min(TG_BN, n_end - c0);
      auto epi = [&](int i, int j, float v) { out[static_cast<long>(i) * N + c0 + j] = v; };
      tile_gemm(A, r0, m, w + c0, N, n, K, sm, epi);
    }
  }
}

extern "C" const char* tl_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// dtype: 0 = float32 (bm, bn: the block region), 1 = bfloat16 (info, host
// int[2], receives the grid G and the item count).
extern "C" int tl_matmul(int dtype, const void* x, const void* w, void* out, void* info, int M, int N, int K, int bm,
                         int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return wgmma_gemm(0, x, w, nullptr, out, 1, M, N, K, 1, static_cast<int*>(info), st);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  matmul_kernel<<<grid, TG_THREADS, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                             static_cast<float*>(out), M, N, K, bm, bn);
  return static_cast<int>(cudaGetLastError());
}
