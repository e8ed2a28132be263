// Persistent bf16 GEMM on the wgmma body (wgmma_tile.cuh): the bf16 route of
// the standalone tile GEMM (matmul.cu) and of the grouped expert GEMM
// (grouped_matmul.cu).
//
// Replaces, for bf16 operands:
//   * src/repro/kernels/matmul.py::matmul (_matmul_kernel): out[M, N] =
//     x[M, K] @ w[K, N], fp32 accumulation, cast at store (the LM head);
//   * src/repro/kernels/grouped_matmul.py::grouped_matmul: row tile t of x
//     (bm rows) times w[tile_expert[t]] of w [E, K, N]; an entry outside
//     [0, E) stores zero rows.  The table is read on the device, as the TPU
//     kernel's scalar prefetch reads it: the paper's dynamic mapping f_R.
// The plain GEMM is the grouped one with one row tile of M rows and one
// expert.
//
// Work item (m-tile mi, n-tile nt), numbered with mi fastest, so the blocks
// that run together share one B strip: a weight strip read from device
// memory serves every m-tile from L2.  m-tile mi is sub-tile j of row tile t
// (mi = t * SUB + j, SUB = ceil(bm / BM)): rows j*BM .. of the row tile, at
// most BM of them and never past it.  G = min(items, resident blocks)
// blocks; block b runs items b, b+G, ...  No block waits on another, so the
// launch is a plain one.
//
//   producer warp: reads tile_expert[t] (a plain load: nothing in the launch
//     writes the table); for a valid expert e it streams the A box (TMA map
//     [M, K] from row t*bm + j*BM; rows past M are zero-filled) and the two
//     B boxes (3-D map [E, K, N], box origin (n0, k0, e)) through the ring;
//     for an empty tile it loads nothing.
//   consumers: read the same entry.  A warpgroup with rows to store runs
//     wgmma over the K blocks (an empty tile: zeros); one whose 64 rows all
//     lie past the item's rows (the decode LM head, M = 4; row tiles of <= 64
//     rows) skips its wgmma and its store but frees the stages (wg_skip).
//   store: float2 / bf16x2 pairs straight from the accumulator (N is a
//     multiple of 8), rows below the item's row count only: the A box may
//     run into the next row tile (another expert's rows), which is computed
//     and never stored.  Staging the tile in shared memory for a TMA store
//     measured no faster on the H100 (PERF.md).
//
// Bound on this card (roofline): the prefill LM head ([1024, d] x [d, ~49k])
// does about 1000 flops per weight byte, above the card's ridge (295), so
// its bound is the tensor cores'; the decode head ([4, d] x [d, V]) reads
// its whole weight for 4 rows and the grouped expert GEMMs (granite: one
// 96-row group per expert) read each expert's weight for 96 rows, so theirs
// is the bytes'.  The persistent grid keeps all 132 SMs loading; each item
// reads its B strip from device memory once and its A rows (a few MB) from
// L2.  What holds the prefill head back on the H100 is that L2 traffic:
// every item loads its A rows and B strip into shared memory, 2MNK (1/BM +
// 1/BN) bytes in all (1.5 GB for smollm's head), at about 7 TB/s (PERF.md);
// wider tiles or a cluster multicast of B would cut it.
#include "wgmma_gemm.cuh"
#include "wgmma_tile.cuh"

struct WgGemmArgs {
  void* out;
  const int* tile_expert;  // [T], or null: expert 0 for every tile
  int N, K, E, bm, sub, MT, items;
};

struct WgGemmItem {
  int row0, rows, col0, expert;  // expert -1: an empty tile
};

__device__ __forceinline__ WgGemmItem wg_gemm_item(const WgGemmArgs& a, int it) {
  const int mi = it % a.MT;
  const int t = mi / a.sub, j = mi % a.sub;
  const int e = a.tile_expert != nullptr ? a.tile_expert[t] : 0;  // f_R, read on the device
  return WgGemmItem{t * a.bm + j * wg::BM, min(wg::BM, a.bm - j * wg::BM), (it / a.MT) * wg::BN,
                    (e >= 0 && e < a.E) ? e : -1};
}

__device__ __forceinline__ void wg_store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void wg_store_pair(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename OutT>
__global__ void __launch_bounds__(wg::THREADS, 1)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                      const WgGemmArgs a) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * wg::STAGES];
  const WgRing ring = wg_ring_setup(smem_raw, bars);
  const int nk = (a.K + wg::BK - 1) / wg::BK;
  RingPos pos;

  if (threadIdx.x >= wg::CONSUMERS) {  // ---- producer warp: TMA loads
    if (threadIdx.x != wg::CONSUMERS) return;
    for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
      const WgGemmItem x = wg_gemm_item(a, it);
      if (x.expert < 0) continue;
      auto load = [&](int kb, uint8_t* sa, uint8_t* sb, uint64_t* bar) {
        wg_tma_2d(sa, &map_a, bar, kb * wg::BK, x.row0);
        wg_tma_3d(sb, &map_b, bar, x.col0, kb * wg::BK, x.expert);
        wg_tma_3d(sb + wg::B_BYTES / 2, &map_b, bar, x.col0 + 64, kb * wg::BK, x.expert);
      };
      wg_produce(ring, pos, nk, load);
    }
    return;
  }

  // ---- two consumer warpgroups: wgmma and the store
  const int wgi = threadIdx.x / 128;
  float acc[wg::ACC];
#pragma unroll
  for (int j = 0; j < wg::ACC; ++j) acc[j] = 0.f;
  for (int it = blockIdx.x; it < a.items; it += gridDim.x) {
    const WgGemmItem x = wg_gemm_item(a, it);
    if (x.rows <= wgi * 64) {  // no row of this warpgroup is stored
      if (x.expert >= 0) wg_skip(ring, pos, nk);
      continue;
    }
    if (x.expert >= 0) {
      wg_mainloop(ring, pos, nk, wgi, acc);
    } else {
#pragma unroll
      for (int j = 0; j < wg::ACC; ++j) acc[j] = 0.f;
    }
    OutT* out = static_cast<OutT*>(a.out) + static_cast<long>(x.row0) * a.N + x.col0;
    auto store = [&](int row, int col, float v0, float v1) {
      wg_store_pair(out + static_cast<long>(row) * a.N + col, v0, v1);
    };
    wg_epilogue(acc, wgi, x.rows, a.N - x.col0, store);
  }
}

int wgmma_gemm(int out_f32, const void* x, const void* w, const void* tile_expert, void* out, int T, int bm, int N,
               int K, int E, int* info, cudaStream_t stream) {
  WgGemmArgs a{out, static_cast<const int*>(tile_expert), N, K, E, bm, (bm + wg::BM - 1) / wg::BM, 0, 0};
  a.MT = T * a.sub;
  a.items = a.MT * ((N + wg::BN - 1) / wg::BN);
  CUtensorMap map_a, map_b;
  // A: x as [T*bm, K]; B: w as [E, K, N]
  const cuuint64_t da[2] = {(cuuint64_t)K, (cuuint64_t)T * bm};
  const cuuint64_t sa[1] = {(cuuint64_t)K};
  const cuuint32_t ba[2] = {wg::BK, wg::BM};
  const cuuint64_t db[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)E};
  const cuuint64_t sb[2] = {(cuuint64_t)N, (cuuint64_t)K * N};
  const cuuint32_t bb[3] = {64, wg::BK, 1};
  int rc = wg_tensor_map(&map_a, x, 2, da, sa, ba);
  if (rc == 0) rc = wg_tensor_map(&map_b, w, 3, db, sb, bb);
  const void* kernel = out_f32 ? reinterpret_cast<const void*>(wgmma_gemm_kernel<float>)
                               : reinterpret_cast<const void*>(wgmma_gemm_kernel<__nv_bfloat16>);
  static int resident[2] = {0, 0};
  int grid = 0;
  if (rc == 0) rc = wg_grid(kernel, a.items, &resident[out_f32 ? 1 : 0], &grid);
  if (rc != 0) return rc;
  info[0] = grid;
  info[1] = a.items;
  void* args[] = {&map_a, &map_b, &a};
  cudaError_t e = cudaLaunchKernel(kernel, dim3(grid), dim3(wg::THREADS), args, wg::SMEM_BYTES, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
