// Flash attention: online softmax, GQA, causal and sliding-window masks; the
// FMA route (float32 at every head dim, bf16 at 16 and 32; bf16 at 64, 80,
// 128 and 256 runs flash_attention_wgmma.cu).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (_fa_kernel).
// q [BH, Sq, D], k/v [BHkv, Sk, D] -> o [BH, Sq, D]; head b reads KV head
// b / (BH / BHkv); queries are right-aligned to keys (query i sits at key
// position i + Sk - Sq); m, l and the output accumulator are fp32 and the
// output is cast to q's dtype.
//
// One block per (q tile of 64 rows, head).  The TPU's sequential KV grid
// dimension becomes a loop inside the block over 64-key tiles, and the loop
// bounds skip every fully masked tile (keys after the last query's causal
// limit, keys before the first query's window).  Per tile: S = Q K^T into
// registers (each thread a 4 x 4 block), the row max / sum reduced across
// the 16 threads of a row group with warp shuffles, P staged in shared
// memory, then O += P V (each thread 4 rows x D/16 columns).
//
// Ring steps (flash_map.cuh): one launch may cover W emulated ranks with
// their own position and KV head offsets, and carry the f32 state (m, l, O;
// m in natural-log units, the scale folded into Q) in from the previous
// launch and out to the next instead of O / l.  A row that met no visible key
// keeps m = -1e30 and is wiped by its first one (alpha = exp(-1e30 - m) = 0).
//
// Bound on this card: the QK^T and PV products (4 * Sq * Sk_visible * D
// flops per head) on fp32 FMA, plus the exponentials; K and V tiles are read
// once per q tile, so bytes are ~Sk*D*(Sq/64) per head — FMA-bound at D = 64.
// At D = 256 (paligemma's float32 checks) the block's shared memory is
// 215 KB (Q, K^T, V and P in f32, padded rows): one block per SM.
#include <cfloat>

#include "tile_gemm.cuh"
// after tile_gemm.cuh (the CUDA runtime)
#include "flash_map.cuh"

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 256;
constexpr float FA_NEG = -1e30f;

template <int D>
constexpr int fa_smem_floats() {
  return FA_BQ * (D + 4) + D * (FA_BK + 4) + FA_BK * (D + 4) + FA_BQ * (FA_BK + 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o, int Sq,
              int Sk, float scale, int causal, int window, const __grid_constant__ FaMap fmap, const FaState st) {
  extern __shared__ __align__(16) float fa_smem[];
  constexpr int QS = D + 4, KS = FA_BK + 4, VS = D + 4, PS = FA_BK + 4;
  constexpr int DC = D / 16;  // output columns per thread
  float* Qs = fa_smem;             // [BQ][QS]   scaled queries
  float* Kt = Qs + FA_BQ * QS;     // [D][KS]    keys, transposed
  float* Vs = Kt + D * KS;         // [BK][VS]
  float* Ps = Vs + FA_BK * VS;     // [BQ][PS]   probabilities

  int bh, bkv, off;  // off: query row 0's position less key 0's
  fa_place(fmap, blockIdx.y, bh, bkv, off);
  const int q0 = blockIdx.x * FA_BQ;
  const int tid = threadIdx.x;
  const int tr = tid / 16;
  const int tc = tid % 16;
  const T* qb = q + static_cast<long>(bh) * Sq * D;
  const T* kb = k + static_cast<long>(bkv) * Sk * D;
  const T* vb = v + static_cast<long>(bkv) * Sk * D;

  for (int e = tid; e < FA_BQ * D; e += FA_THREADS) {
    const int i = e / D, d = e % D;
    Qs[i * QS + d] = (q0 + i < Sq) ? tl_ld(qb + static_cast<long>(q0 + i) * D + d) * scale : 0.f;
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_i[a] = FA_NEG;
    l_i[a] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DC; ++dd) acc[a][dd] = 0.f;
    const int i = q0 + tr * 4 + a;
    if (st.load && i < Sq) {  // the carried state
      const long row = static_cast<long>(bh) * Sq + i;
      m_i[a] = st.m[row];
      l_i[a] = st.l[row];
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) acc[a][dd] = st.o[row * D + tc + 16 * dd];
    }
  }

  // KV tiles that hold at least one visible key for some query of this tile
  int kv_hi = Sk;
  if (causal) kv_hi = min(Sk, q0 + FA_BQ + off);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 + off - window + 1);
  kv_lo = (kv_lo / FA_BK) * FA_BK;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += FA_BK) {
    __syncthreads();  // previous tile's Kt / Vs / Ps reads are done (and Qs is written)
    for (int e = tid; e < FA_BK * D; e += FA_THREADS) {
      const int jk = e / D, d = e % D;
      const bool in = k0 + jk < Sk;
      const long idx = static_cast<long>(k0 + jk) * D + d;
      Kt[d * KS + jk] = in ? tl_ld(kb + idx) : 0.f;
      Vs[jk * VS + d] = in ? tl_ld(vb + idx) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int u = 0; u < 4; ++u) sc[a][u] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = Qs[(tr * 4 + a) * QS + d];
#pragma unroll
      for (int u = 0; u < 4; ++u) kc[u] = Kt[d * KS + tc + 16 * u];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int u = 0; u < 4; ++u) sc[a][u] = fmaf(qa[a], kc[u], sc[a][u]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + tr * 4 + a + off;
      float mx = FA_NEG;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int kpos = k0 + tc + 16 * u;
        bool ok = kpos < Sk;
        if (causal) ok = ok && (qpos >= kpos);
        if (window > 0) ok = ok && (qpos - kpos < window);
        if (!ok) sc[a][u] = FA_NEG;
        mx = fmaxf(mx, sc[a][u]);
      }
#pragma unroll
      for (int sh = 8; sh >= 1; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m_i[a], mx);
      const float alpha = expf(m_i[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // keys past Sk contribute nothing (their V rows are zero-filled, and
        // they are excluded from the row sum)
        const bool real = k0 + tc + 16 * u < Sk;
        const float p = real ? expf(sc[a][u] - m_new) : 0.f;
        Ps[(tr * 4 + a) * PS + tc + 16 * u] = p;
        rs += p;
      }
#pragma unroll
      for (int sh = 8; sh >= 1; sh >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, sh);
      l_i[a] = l_i[a] * alpha + rs;
      m_i[a] = m_new;
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) acc[a][dd] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int jk = 0; jk < FA_BK; ++jk) {
      float pa[4], vv[DC];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = Ps[(tr * 4 + a) * PS + jk];
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) vv[dd] = Vs[jk * VS + tc + 16 * dd];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int dd = 0; dd < DC; ++dd) acc[a][dd] = fmaf(pa[a], vv[dd], acc[a][dd]);
    }
  }

  if (st.store) {  // the state for the next launch, unnormalised
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = q0 + tr * 4 + a;
      if (i >= Sq) continue;
      const long row = static_cast<long>(bh) * Sq + i;
      if (tc == 0) {
        st.m[row] = m_i[a];
        st.l[row] = l_i[a];
      }
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) st.o[row * D + tc + 16 * dd] = acc[a][dd];
    }
    return;
  }
  T* ob = o + static_cast<long>(bh) * Sq * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + tr * 4 + a;
    if (i >= Sq) continue;
    const float inv = 1.f / fmaxf(l_i[a], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DC; ++dd) ob[static_cast<long>(i) * D + tc + 16 * dd] = tl_from_float<T>(acc[a][dd] * inv);
  }
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Sk, float scale,
                  int causal, int window, const FaMap& fmap, const FaState& fst, cudaStream_t st) {
  const size_t smem = sizeof(float) * fa_smem_floats<D>();
  cudaError_t e = cudaFuncSetAttribute(fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, BH);
  fa_kernel<T, D><<<grid, FA_THREADS, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                  static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, scale, causal,
                                                  window, fmap, fst);
  return static_cast<int>(cudaGetLastError());
}

// WIDE: head dims 64, 80, 128 and 256 too (float32; bf16 takes them on the wgmma route)
template <typename T, bool WIDE>
static int dispatch_d(const void* q, const void* k, const void* v, void* o, int BH, int Sq, int Sk, int D,
                      float scale, int causal, int window, const FaMap& fmap, const FaState& fst, cudaStream_t st) {
  if (D == 16) return launch<T, 16>(q, k, v, o, BH, Sq, Sk, scale, causal, window, fmap, fst, st);
  if (D == 32) return launch<T, 32>(q, k, v, o, BH, Sq, Sk, scale, causal, window, fmap, fst, st);
  if constexpr (WIDE) {
    if (D == 64) return launch<T, 64>(q, k, v, o, BH, Sq, Sk, scale, causal, window, fmap, fst, st);
    if (D == 80) return launch<T, 80>(q, k, v, o, BH, Sq, Sk, scale, causal, window, fmap, fst, st);
    if (D == 128) return launch<T, 128>(q, k, v, o, BH, Sq, Sk, scale, causal, window, fmap, fst, st);
    if (D == 256) return launch<T, 256>(q, k, v, o, BH, Sq, Sk, scale, causal, window, fmap, fst, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 = float32 (D 16, 32, 64, 80, 128, 256), 1 = bfloat16 (D 16, 32;
// 64, 80, 128 and 256 run tl_flash_attention_wgmma).  map places W ranks' heads and positions
// (flash_map.cuh); m / l / so are the f32 state (load: read it; store: write
// it instead of o; null when neither).
extern "C" int tl_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o, void* m, void* l,
                                  void* so, int BH, int BHkv, int Sq, int Sk, int D, float scale, int causal,
                                  int window, int W, const void* map, int load, int store, void* stream) {
  if (BH < 1 || BHkv < 1 || Sq < 1 || Sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  FaMap fmap;
  int rc = fa_make_map(&fmap, static_cast<const int*>(map), W, BH, BHkv);
  if (rc != 0) return rc;
  const FaState fst{static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(so), load, store};
  if ((load || store) && (m == nullptr || l == nullptr || so == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (!store && o == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float, true>(q, k, v, o, BH, Sq, Sk, D, scale, causal, window, fmap, fst, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, false>(q, k, v, o, BH, Sq, Sk, D, scale, causal, window, fmap, fst, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
