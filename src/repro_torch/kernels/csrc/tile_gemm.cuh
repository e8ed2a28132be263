// Block-level tile GEMM — the consumer body every GEMM-shaped kernel runs.
//
// Replaces the TPU tile loop of src/repro/kernels/matmul.py::_matmul_kernel
// (fp32 accumulator across the K grid dimension, cast at store), which the
// fused ag_gemm / gemm_rs kernels also run on every step.  On the TPU the
// whole (bm, bk) x (bk, bn) block sits in VMEM and the MXU takes it at once;
// here one thread block of 256 threads computes a 64 x 128 output tile:
//
//   * the K loop stages a 64 x 32 slice of A and a 32 x 128 slice of B in
//     shared memory (converted to fp32), and each thread accumulates a 4 x 8
//     register micro-tile with fused multiply-adds;
//   * every load is bounds-checked and zero-filled, so the tile takes any
//     m <= 64, n <= 128 and any K: non-power-of-two tiles (bn = 120 on the
//     smollm path) and ragged edges need no padding by the caller;
//   * A rows may come in groups (batch rows of a comm tile sit m_sub rows
//     apart in the activation), described by RowsA;
//   * the result goes to an epilogue functor epi(i, j, value), so each
//     kernel fuses its own store, cast, partial add or peer store.
//
// Bound on this card: fp32 FMA issue (67 TFLOP/s for the whole card,
// about 0.5 per SM), not the tensor cores (989 TFLOP/s bf16) — this is the
// simple, right first version.  A wgmma + TMA pipeline is later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int TG_BM = 64;
constexpr int TG_BN = 128;
constexpr int TG_BK = 32;
constexpr int TG_THREADS = 256;

struct TileGemmSmem {
  float a[TG_BK][TG_BM + 4];  // A slice, k-major (transposed on load)
  float b[TG_BK][TG_BN + 4];  // B slice, row-major
};

// ---- element access ---------------------------------------------------------

__device__ __forceinline__ float tl_ld(const float* p) { return *p; }
__device__ __forceinline__ float tl_ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// L2-coherent load (ld.global.cg): for data another block stored during this
// launch, which a stale L1 line must not shadow
__device__ __forceinline__ float tl_ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float tl_ldcg(const __nv_bfloat16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

template <typename T>
__device__ __forceinline__ T tl_from_float(float v);
template <>
__device__ __forceinline__ float tl_from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 tl_from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Rows of an A operand: row i starts at base + (i / grp) * gstride + (i % grp) * lda.
template <typename T>
struct RowsA {
  const T* base;
  long lda;
  int grp;
  long gstride;
  __device__ __forceinline__ const T* row(int i) const {
    return base + static_cast<long>(i / grp) * gstride + static_cast<long>(i % grp) * lda;
  }
};

// C[m x n] = A[row0 : row0 + m, 0 : k] @ B[0 : k, 0 : n] in fp32; m <= TG_BM, n <= TG_BN.
// Calls epi(row0 + i, j, c_ij) for every i < m, j < n.  B is row-major with
// leading dimension ldb.  All TG_THREADS threads of the block must call it.
template <typename T, typename Epi>
__device__ void tile_gemm(const RowsA<T>& A, int row0, int m, const T* B, long ldb, int n, int k,
                          TileGemmSmem& sm, Epi& epi) {
  const int tid = threadIdx.x;
  const int tr = tid / 16;  // micro-tile rows tr*4 .. tr*4+3
  const int tc = tid % 16;  // micro-tile cols tc + 16*u, u < 8

  float acc[4][8];
#pragma unroll
  for (int v = 0; v < 4; ++v)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[v][u] = 0.f;

  // this thread loads A rows tid/32 + 8q (q < 8) at k offset tid%32 ...
  const int la_k = tid % 32;
  const T* arow[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int r = tid / 32 + 8 * q;
    arow[q] = (r < m) ? A.row(row0 + r) : nullptr;
  }
  // ... and B rows tid/128 + 2q (q < 16) at column tid%128
  const int lb_c = tid % 128;
  const int lb_k = tid / 128;

  for (int k0 = 0; k0 < k; k0 += TG_BK) {
    const int ka = k0 + la_k;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v = 0.f;
      if (arow[q] != nullptr && ka < k) v = tl_ldcg(arow[q] + ka);
      sm.a[la_k][tid / 32 + 8 * q] = v;
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int kr = lb_k + 2 * q;
      float v = 0.f;
      if (k0 + kr < k && lb_c < n) v = tl_ld(B + static_cast<long>(k0 + kr) * ldb + lb_c);
      sm.b[kr][lb_c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int t = 0; t < TG_BK; ++t) {
      const float4 a4 = *reinterpret_cast<const float4*>(&sm.a[t][tr * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      float b[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) b[u] = sm.b[t][tc + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[v][u] = fmaf(a[v], b[u], acc[v][u]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int i = tr * 4 + v;
    if (i >= m) continue;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = tc + 16 * u;
      if (j < n) epi(row0 + i, j, acc[v][u]);
    }
  }
}
