// Standalone tile GEMM: out[M, N] = x[M, K] @ w[K, N], fp32 accumulation,
// cast at store.
//
// Replaces src/repro/kernels/matmul.py::matmul (_matmul_kernel): a
// (M/bm, N/bn, K/bk) grid with the K dimension innermost and a VMEM fp32
// accumulator.  Here one block owns a (bm, bn) output region and walks it in
// 64 x 128 tiles of tile_gemm.cuh, with the K loop inside the tile; unlike
// the TPU kernel, bm / bn need not divide M / N (ragged edges are masked).
//
// Bound on this card: for the shapes it runs (the LM head, K = 960) the
// arithmetic (2MNK) dominates the bytes, so fp32 FMA issue bounds it; the
// design keeps the K loop in shared memory and registers, reading each
// input element from device memory once per block.
#include "tile_gemm.cuh"

template <typename T>
__global__ void __launch_bounds__(TG_THREADS)
    matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int M, int N, int K,
                  int bm, int bn) {
  __shared__ __align__(16) TileGemmSmem sm;
  const int m0 = blockIdx.y * bm;
  const int n0 = blockIdx.x * bn;
  const int m_end = min(m0 + bm, M);
  const int n_end = min(n0 + bn, N);
  const RowsA<T> A{x, K, 1 << 30, 0};
  for (int r0 = m0; r0 < m_end; r0 += TG_BM) {
    for (int c0 = n0; c0 < n_end; c0 += TG_BN) {
      const int m = min(TG_BM, m_end - r0);
      const int n = min(TG_BN, n_end - c0);
      auto epi = [&](int i, int j, float v) { out[static_cast<long>(i) * N + c0 + j] = tl_from_float<T>(v); };
      tile_gemm(A, r0, m, w + c0, N, n, K, sm, epi);
    }
  }
}

extern "C" const char* tl_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

extern "C" int tl_matmul(int dtype, const void* x, const void* w, void* out, int M, int N, int K, int bm, int bn,
                         void* stream) {
  const dim3 grid((N + bn - 1) / bn, (M + bm - 1) / bm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    matmul_kernel<float><<<grid, TG_THREADS, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                                      static_cast<float*>(out), M, N, K, bm, bn);
  } else if (dtype == 1) {
    matmul_kernel<__nv_bfloat16><<<grid, TG_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, N, K, bm, bn);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
