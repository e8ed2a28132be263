// Fused GEMM + ReduceScatter over W tensor-parallel ranks emulated on one card
// (paper Fig. 4, plan-driven).
//
// Replaces src/repro/kernels/gemm_rs.py::gemm_rs_shard (_gemm_rs_kernel).
// Per rank r: out[r] = rank r's [B, M/W, N] segment of sum_q x[q] @ w[q],
// with x [W, B, M, k_loc] and w [W, k_loc, N].
//
// Grid (n_tile j, channel c, rank r), one launch for all ranks.  Block
// (j, c, r) owns columns c*n_sub + j*bn .. +bn of every stage:
//
//   stage s: seg = seg_tbl[c, s, r]; compute the [B*m_loc, bn] partial of
//            rows seg*m_loc.. of every batch; for s > 0 wait for recv flag
//            (s-1, c, j) and add the partial received in slot (s-1, c);
//            for s < W-1 store the sum (accum dtype, the wire dtype of the
//            identity QuantSpec) into recv slot (s, c) of rank
//            dst_tbl[c, s, r] and set that rank's flag (s, c, j) (release);
//            the last stage stores the reduced home segment to out.
//
// Each recv slot (stage, channel) is written exactly once per pass, so no
// send credit is needed: the partial never sits in a staging buffer that a
// later stage reuses (the per-channel send semaphore of the TPU kernel
// guards exactly that reuse).  Several n-tile blocks feed one slot, so the
// flags are per (stage, channel, tile).
//
// Bound on this card: the GEMM (2 * W * B*M * k_loc * N flops) on fp32 FMA;
// partial traffic W*(W-1)*B*m_loc*N accum elements stays in L2.
#include "tile_sync.cuh"

template <typename T, typename AccT>
__global__ void __launch_bounds__(TG_THREADS)
    gemm_rs_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, AccT* rbuf, int* flags,
                   const int* __restrict__ seg_tbl, const int* __restrict__ dst_tbl, int W, int nch, int n_tiles,
                   int B, int M, int K, int N, int n_sub, int bn) {
  __shared__ __align__(16) TileGemmSmem sm;
  const int j = blockIdx.x;
  const int c = blockIdx.y;
  const int r = blockIdx.z;
  const int m_loc = M / W;
  const int rows = B * m_loc;
  const long slot_elems = static_cast<long>(rows) * n_sub;
  const int ccol = j * bn;  // first column inside the channel
  const int bn_here = min(bn, n_sub - ccol);
  const T* wr = w + static_cast<long>(r) * K * N + static_cast<long>(c) * n_sub + ccol;

  for (int s = 0; s < W; ++s) {
    const int f = (c * W + s) * W + r;
    const int seg = seg_tbl[f];
    const int dst = dst_tbl[f];
    // rows (b, i) -> x[r, b, seg*m_loc + i, :]
    const RowsA<T> A{x + (static_cast<long>(r) * B * M + static_cast<long>(seg) * m_loc) * K, K, m_loc,
                     static_cast<long>(M) * K};
    const AccT* prev = nullptr;
    if (s > 0) {
      tl_wait_flag(&flags[((r * W + (s - 1)) * nch + c) * n_tiles + j], 1);
      prev = rbuf + (static_cast<long>(r * W + (s - 1)) * nch + c) * slot_elems;
    }
    AccT* send = (s < W - 1) ? rbuf + (static_cast<long>(dst * W + s) * nch + c) * slot_elems : nullptr;
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
            out[(static_cast<long>(r * B + b) * m_loc + ii) * N + static_cast<long>(c) * n_sub + col] =
                tl_from_float<T>(v);
          }
        };
        tile_gemm(A, r0, m, wr + c0, N, n, K, sm, epi);
      }
    }
    if (send != nullptr) tl_notify(&flags[((dst * W + s) * nch + c) * n_tiles + j], 1);
  }
}

template <typename T, typename AccT>
static int launch(const void* x, const void* w, void* out, void* rbuf, void* flags, const void* seg_tbl,
                  const void* dst_tbl, int W, int nch, int n_tiles, int B, int M, int K, int N, int n_sub, int bn,
                  cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  AccT* rp = static_cast<AccT*>(rbuf);
  int* fp = static_cast<int*>(flags);
  const int* sp = static_cast<const int*>(seg_tbl);
  const int* dp = static_cast<const int*>(dst_tbl);
  void* args[] = {&xp, &wp, &op, &rp, &fp, &sp, &dp, &W, &nch, &n_tiles, &B, &M, &K, &N, &n_sub, &bn};
  const dim3 grid(n_tiles, nch, W);
  // co-residency: every block spins on flags other blocks set
  cudaError_t e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(gemm_rs_kernel<T, AccT>), grid,
                                              dim3(TG_THREADS), args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tl_gemm_rs(int dtype, int acc_dtype, const void* x, const void* w, void* out, void* rbuf,
                          void* flags, const void* seg_tbl, const void* dst_tbl, int W, int nch, int n_tiles, int B,
                          int M, int K, int N, int n_sub, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TL_RS(T, A) \
  return launch<T, A>(x, w, out, rbuf, flags, seg_tbl, dst_tbl, W, nch, n_tiles, B, M, K, N, n_sub, bn, st)
  if (dtype == 0 && acc_dtype == 0) TL_RS(float, float);
  if (dtype == 0 && acc_dtype == 1) TL_RS(float, __nv_bfloat16);
  if (dtype == 1 && acc_dtype == 0) TL_RS(__nv_bfloat16, float);
  if (dtype == 1 && acc_dtype == 1) TL_RS(__nv_bfloat16, __nv_bfloat16);
#undef TL_RS
  return static_cast<int>(cudaErrorInvalidValue);
}
