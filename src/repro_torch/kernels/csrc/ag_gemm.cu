// Fused AllGather + GEMM over W tensor-parallel ranks emulated on one card.
//
// Replaces src/repro/kernels/ag_gemm.py::ag_gemm_shard (_ag_gemm_kernel).
// Per rank r: out[r] = all_gather(x) @ w[r], with x [W, B, m_loc, K] and
// w [W, K, n_loc] -> out [W, B, W*m_loc, n_loc]; gathered rows of origin o,
// channel c land at out[r, b, o*m_loc + c*m_sub + i] for every batch row b.
//
// Grid (n_tile j, channel c, rank r), one launch for all ranks.  The comm
// tile of channel c is [B, m_sub, K] (the batch rows ride inside the tile,
// not the grid).  The plan's tables drive it, as on the TPU:
//
//   step s:  src = src_tbl[c, s, r] is the origin of the held tile; at s = 0
//            it is the own sub-chunk, read in place from x; later it is the
//            gather slot (src, c) of rank r, read once its recv flag
//            (s-1, c) is set (acquire);
//            block j == 0 pushes the held tile into gather slot (src, c) of
//            rank dst_tbl[c, s, r] and sets that rank's flag (s, c) (release);
//            every block computes its [B*m_sub, bn] output tile on it.
//
// Buffer protocol (as analysis/protocol.py models the TPU kernel): one
// gather slot per (origin, channel) per rank, written once per pass; one
// recv flag per (step, channel) per rank.
//
// Bound on this card: the GEMM (2 * W * B*W*m_loc * K * n_loc flops) on
// fp32 FMA; the pushes move W*(W-1)*B*m_loc*K elements at L2 bandwidth.
// The push happens before the step's GEMM, so the next step's tile travels
// while this step computes.
#include "tile_sync.cuh"

template <typename T>
__global__ void __launch_bounds__(TG_THREADS)
    ag_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, T* gbuf, int* flags,
                   const int* __restrict__ src_tbl, const int* __restrict__ dst_tbl, int W, int nch, int B,
                   int m_loc, int m_sub, int K, int n_loc, int bn, int accum_bf16) {
  __shared__ __align__(16) TileGemmSmem sm;
  const int j = blockIdx.x;
  const int c = blockIdx.y;
  const int r = blockIdx.z;
  const int rows = B * m_sub;
  const long slot_elems = static_cast<long>(rows) * K;
  const long m_glob = static_cast<long>(W) * m_loc;
  const int col_blk = j * bn;
  const T* wr = w + static_cast<long>(r) * K * n_loc + col_blk;
  const int bn_here = min(bn, n_loc - col_blk);

  for (int s = 0; s < W; ++s) {
    const int f = (c * W + s) * W + r;
    const int src = src_tbl[f];
    const int dst = dst_tbl[f];
    RowsA<T> A;
    if (s == 0) {
      // own sub-chunk, in place: row (b, i) -> x[r, b, c*m_sub + i, :]
      A = RowsA<T>{x + (static_cast<long>(r) * B * m_loc + static_cast<long>(c) * m_sub) * K, K, m_sub,
                   static_cast<long>(m_loc) * K};
    } else {
      tl_wait_flag(&flags[(r * W + (s - 1)) * nch + c], 1);
      A = RowsA<T>{gbuf + (static_cast<long>(r * W + src) * nch + c) * slot_elems, K, rows, 0};
    }
    if (j == 0 && s < W - 1) {
      T* slot = gbuf + (static_cast<long>(dst * W + src) * nch + c) * slot_elems;
      tl_push_rows(slot, A, rows, K);
      tl_notify(&flags[(dst * W + s) * nch + c], 1);
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
          out[((static_cast<long>(r) * B + b) * m_glob + row_base + ii) * n_loc + col_blk + c0 + jj] =
              tl_from_float<T>(v);
        };
        tile_gemm(A, r0, m, wr + c0, n_loc, n, K, sm, epi);
      }
    }
  }
}

template <typename T>
static int launch(int accum_bf16, const void* x, const void* w, void* out, void* gbuf, void* flags,
                  const void* src_tbl, const void* dst_tbl, int W, int nch, int n_tiles, int B, int m_loc, int m_sub,
                  int K, int n_loc, int bn, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  T* gp = static_cast<T*>(gbuf);
  int* fp = static_cast<int*>(flags);
  const int* sp = static_cast<const int*>(src_tbl);
  const int* dp = static_cast<const int*>(dst_tbl);
  void* args[] = {&xp, &wp, &op, &gp, &fp, &sp, &dp, &W, &nch, &B, &m_loc, &m_sub, &K, &n_loc, &bn, &accum_bf16};
  const dim3 grid(n_tiles, nch, W);
  // co-residency: every block spins on flags other blocks set
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(ag_gemm_kernel<T>), grid, dim3(TG_THREADS),
                                              args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tl_ag_gemm(int dtype, int accum_bf16, const void* x, const void* w, void* out, void* gbuf,
                          void* flags, const void* src_tbl, const void* dst_tbl, int W, int nch, int n_tiles, int B,
                          int m_loc, int m_sub, int K, int n_loc, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(accum_bf16, x, w, out, gbuf, flags, src_tbl, dst_tbl, W, nch, n_tiles, B, m_loc, m_sub, K,
                         n_loc, bn, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(accum_bf16, x, w, out, gbuf, flags, src_tbl, dst_tbl, W, nch, n_tiles, B, m_loc,
                                 m_sub, K, n_loc, bn, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
