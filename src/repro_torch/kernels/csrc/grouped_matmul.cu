// Grouped (MoE expert) GEMM driven by an on-device tile -> expert table.
//
// Replaces src/repro/kernels/grouped_matmul.py::grouped_matmul: rows of x are
// expert-sorted and tile-aligned, and row tile t is multiplied by the weight
// of expert tile_expert[t] — the paper's dynamic mapping f_R.  On the TPU the
// table is a scalar-prefetch operand that the BlockSpec index map reads to
// pick the weight block to DMA; here every block reads its own table entry
// from device memory and points the tile loop of tile_gemm.cuh at that
// expert's weight, so one launch covers every expert and no host code splits
// the work per expert.
//
//   * grid (row tile, 128-column tile); a row tile of bm rows is walked in
//     64-row sub-tiles of tile_gemm.cuh, with the K loop inside;
//   * the fp32 accumulator is cast at store to the output type, which is
//     float32 or the input type (the MoE gate|up product stays float32 for
//     the SiLU-mul that follows it, as in the JAX package);
//   * an entry outside [0, E) marks an empty tile: its rows are stored as 0.
//
// Bound on this card: on the serve path (gate|up [3840, 1536] x [40, 1536,
// 1024], down [3840, 512] x [40, 512, 1536]) the work is about 80 flops per
// byte moved, so the tensor cores would leave it bytes-bound; this first
// version runs on fp32 FMA units and is bound by their issue rate.  Groups of
// 96 rows (4 batch rows x capacity 24) give 48-row tiles, 3/4 of the
// 64-row micro-tile.  wgmma + TMA is later work.
#include "tile_gemm.cuh"

template <typename T, typename OutT>
__global__ void __launch_bounds__(TG_THREADS)
    grouped_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w, const int* __restrict__ tile_expert,
                          OutT* __restrict__ out, int N, int K, int E, int bm) {
  __shared__ __align__(16) TileGemmSmem sm;
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * TG_BN;
  const int n = min(TG_BN, N - c0);
  const int e = tile_expert[t];  // f_R: the routing table, read on the device
  const int row_end = (t + 1) * bm;
  if (e < 0 || e >= E) {
    for (int idx = threadIdx.x; idx < bm * n; idx += TG_THREADS) {
      out[static_cast<long>(t * bm + idx / n) * N + c0 + idx % n] = tl_from_float<OutT>(0.f);
    }
    return;
  }
  const T* B = w + static_cast<long>(e) * K * N + c0;
  const RowsA<T> A{x, K, 1 << 30, 0};
  auto epi = [&](int i, int j, float v) { out[static_cast<long>(i) * N + c0 + j] = tl_from_float<OutT>(v); };
  for (int r0 = t * bm; r0 < row_end; r0 += TG_BM) {
    tile_gemm(A, r0, min(TG_BM, row_end - r0), B, N, n, K, sm, epi);
  }
}

template <typename T, typename OutT>
static int launch(const void* x, const void* w, const void* tile_expert, void* out, int n_tiles, int N, int K,
                  int E, int bm, cudaStream_t st) {
  const dim3 grid(n_tiles, (N + TG_BN - 1) / TG_BN);
  grouped_matmul_kernel<T, OutT><<<grid, TG_THREADS, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                                               static_cast<const int*>(tile_expert),
                                                               static_cast<OutT*>(out), N, K, E, bm);
  return static_cast<int>(cudaGetLastError());
}

// dtype / out_dtype: 0 = float32, 1 = bfloat16 (out_dtype is float32 or dtype)
extern "C" int tl_grouped_matmul(int dtype, int out_dtype, const void* x, const void* w, const void* tile_expert,
                                 void* out, int n_tiles, int N, int K, int E, int bm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0) return launch<float, float>(x, w, tile_expert, out, n_tiles, N, K, E, bm, st);
  if (dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, tile_expert, out, n_tiles, N, K, E, bm, st);
  if (dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, tile_expert, out, n_tiles, N, K, E, bm, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
