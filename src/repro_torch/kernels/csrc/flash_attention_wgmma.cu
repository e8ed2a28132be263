// Flash attention, bf16 route for Hopper: TMA -> shared-memory ring -> wgmma,
// online softmax in registers.
//
// Replaces, for bf16 operands at head dims 64, 80, 128 and 256, the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_fa_kernel): q [BH,
// Sq, D], k/v [BHkv, Sk, D] -> o [BH, Sq, D]; head b reads KV head b / (BH /
// BHkv); queries right-aligned to keys (query i sits at key position i + Sk -
// Sq); causal and sliding-window masks; m, l and the output accumulator in
// f32.  float32 (and bf16 at D 16 / 32) stays on the FMA kernel of
// flash_attention.cu; the wrapper picks the route from its table before the
// launch.
//
// One CTA of 160 threads per (64-row query tile, query head); the grid is
// (ceil(Sq / 64), BH), query tiles with the most KV tiles first.  At the
// serve path's shapes (Sq = Sk = 256, BH = 64 and 96) that is 256 and 384
// CTAs on 132 SMs, several resident on each.  K/V loads are not shared
// between the query heads of one KV head: each CTA loads its own tiles
// (64 KB per KV head at the path's shapes, served from L2 after the first).
//
//   * warp 4, one lane, is the producer: it loads the Q tile once, then the K
//     and V tiles of the visible KV range into a ring of FA_STAGES stages
//     (cp.async.bulk.tensor from 3-D maps [BH or BHkv, S, D], 64 x 64 boxes
//     of 8 KB with 128-byte swizzle, two boxes across D = 128); rows past Sq
//     or Sk are zero-filled by the map;
//   * warps 0-3 are one consumer warpgroup.  Per KV tile: S = Q K^T by
//     wgmma m64n64k16 (A = Q and B = K, both K-major: K is stored [Sk, D]
//     with D contiguous), f32 into 32 registers a thread; the causal / window
//     mask and the Sk edge only on tiles that straddle them; the online
//     softmax on the accumulator fragment (row max over the 4 lanes of a
//     quad, exp2 with the scale folded in, the row sum kept per thread and
//     reduced once at the end); P rounded to bf16 in registers, where the S
//     accumulator layout is the A-operand layout of the next product, so
//     O += P V runs wgmma with A from registers (V is [Sk, D], N-major: the
//     transpose bit, as the weights of wgmma_tile.cuh); O stays f32 in
//     registers, scaled by alpha per row; at the end O / l, cast, stored.
//   * The KV loop visits only tiles with a visible key, as the TPU kernel's
//     block skip: keys after the tile's last query (causal), before its first
//     query's window.  Masked entries take -1e30 (as the plain version),
//     keys past Sk take p = 0.
//
// Head dim 80 (zamba2) runs the D-128 pipeline: the maps carry the true
// width of 80 (160-byte rows, a 16-byte multiple), the two 64-column boxes
// stay, and TMA fills columns 80-127 of the second box with zeros, so S = Q
// K^T takes 5 k-steps of 16 (the zero columns would add nothing) and O += P
// V runs at N = 128 with zero columns 80-127, which are never stored: O, the
// state and the no-key rows take 80 columns only.  No padded copy of q / k /
// v exists in memory.
//
// Ring steps (flash_map.cuh): one launch may cover W emulated ranks, each
// with its own query / key position offset and KV head offset; the block skip
// and the masks take the rank's offset, blockIdx.y walks the ranks busiest
// first.  The f32 state (m in the log2 domain, l, O) can come in from the
// previous launch and go out to the next instead of O / l: a row that met no
// visible key yet keeps m = -1e30 (its l and O hold the masked keys' p = 1),
// and the first visible key wipes it (alpha = exp2(-1e30 - m) = 0); the
// kernel never divides a carried state except at the last launch.
//
// Head dim 256 (paligemma) runs a 256-wide pipeline: four 64-column boxes
// per tile, so a stage (K and V) is 64 KB and the Q tile 32 KB, ~161 KB of
// shared memory with two stages (one CTA per SM); S = Q K^T takes 16 k-steps
// and O += P V one m64n256k16 wgmma per k-step, whose accumulator fragment
// (the n128 layout extended: column 8 (j / 4) + 2 (t % 4) + j % 2) holds 128
// f32 registers a consumer thread beside S's 32; the build phase reports the
// kernel's registers and spills.
//
// Numerics: P in bf16 before P V is what the reference's attn_p_bf16 option
// does on its unfused path; l sums the f32 P.  No atomics, a fixed order:
// relaunches are bitwise equal.
//
// Bound on this card: at the path's shapes the work is 4 Sq Sk_visible D
// flops per head (0.0013 ms of bf16 tensor-core time for smollm) against the
// bytes of q, k, v and o (0.0019 ms at 3.35 TB/s), so it is bound by bytes,
// and at 256 keys a CTA visits at most 4 KV tiles: the kernel is latency-
// bound (TMA round trips, the softmax between the two products).
#include "wgmma_tile.cuh"
// after wgmma_tile.cuh (the CUDA runtime)
#include "flash_map.cuh"

constexpr int FW_BQ = 64;
constexpr int FW_BK = 64;
constexpr int FW_STAGES = 2;
constexpr int FW_CONSUMERS = 128;
constexpr int FW_THREADS = FW_CONSUMERS + 32;
constexpr int FW_BOX = 64 * 64 * 2;  // one 64 x 64 bf16 box
constexpr float FW_NEG = -1e30f;

// DP: the pipeline's width, D rounded up to 64-column boxes
template <int DP>
struct FwSmem {
  static constexpr int BOXES = DP / 64;
  static constexpr int Q_BYTES = BOXES * FW_BOX;
  static constexpr int KV_BYTES = BOXES * FW_BOX;  // one of K or V
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BYTES = Q_BYTES + FW_STAGES * STAGE_BYTES + 1024;  // + slack to align to 1024 B
};

// ---- wgmma forms: S = Q K^T (both from shared memory, K-major), O += P V
// (P from registers, V N-major: the transpose bit)

__device__ __forceinline__ void fa_mma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fa_mma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fa_mma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void fa_mma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The KV range [lo, hi) of keys visible to some query of the tile at q0
// (the plain version's tiles: flash_attention.kv_tiles).
struct FwRange {
  int lo, n;
};

__device__ __forceinline__ FwRange fw_range(int q0, int Sk, int off, int causal, int window) {
  int hi = Sk;
  if (causal) hi = min(Sk, q0 + FW_BQ + off);
  int lo = 0;
  if (window > 0) lo = max(0, q0 + off - window + 1);
  lo = (lo / FW_BK) * FW_BK;
  return FwRange{lo, hi > lo ? (hi - lo + FW_BK - 1) / FW_BK : 0};
}

// D: the head dim in memory; DP: the pipeline's width (64, 128 or 256, >= D)
template <int D, int DP>
__global__ void __launch_bounds__(FW_THREADS)
    fa_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o, int Sq, int Sk,
                    float scale_log2, int causal, int window, const __grid_constant__ FaMap fmap,
                    const FaState st) {
  using SM = FwSmem<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * FW_STAGES + 1];
  uint64_t* full = bars;
  uint64_t* empty = bars + FW_STAGES;
  uint64_t* qbar = bars + 2 * FW_STAGES;
  const uint32_t base = wg_smem(smem_raw);
  uint8_t* q_s = smem_raw + ((1024 - (base & 1023)) & 1023);
  uint8_t* ring = q_s + SM::Q_BYTES;

  int bh, bkv, off;  // off: query row 0's position less key 0's
  fa_place(fmap, blockIdx.y, bh, bkv, off);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FW_BQ;  // the longest KV ranges first
  const FwRange r = fw_range(q0, Sk, off, causal, window);

  if (threadIdx.x == 0) {
    for (int s = 0; s < FW_STAGES; ++s) {
      wg_mbar_init(&full[s], 1);
      wg_mbar_init(&empty[s], FW_CONSUMERS / 32);
    }
    wg_mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (r.n == 0) {  // no visible key: the state passes through, or the rows are final
    if (st.store && st.load) return;
    for (int e = threadIdx.x; e < FW_BQ * D; e += FW_THREADS) {
      const int i = e / D;
      if (q0 + i >= Sq) continue;
      const long row = static_cast<long>(bh) * Sq + q0 + i;
      if (st.store) {  // a fresh state: nothing seen yet
        st.o[row * D + e % D] = 0.f;
        if (e % D == 0) {
          st.m[row] = FW_NEG;
          st.l[row] = 0.f;
        }
      } else {  // the plain version's zero rows, or the carried state normalised
        const float val = st.load ? st.o[row * D + e % D] / fmaxf(st.l[row], 1e-30f) : 0.f;
        o[row * D + e % D] = __float2bfloat16(val);
      }
    }
    return;
  }

  if (threadIdx.x >= FW_CONSUMERS) {  // ---- producer: TMA loads
    if (threadIdx.x != FW_CONSUMERS) return;
    wg_mbar_expect_tx(qbar, SM::Q_BYTES);
#pragma unroll
    for (int b = 0; b < SM::BOXES; ++b) wg_tma_3d(q_s + b * FW_BOX, &map_q, qbar, b * 64, q0, bh);
    for (int t = 0; t < r.n; ++t) {
      const int s = t % FW_STAGES, round = t / FW_STAGES;
      wg_mbar_wait(&empty[s], (round & 1) ^ 1);
      wg_mbar_expect_tx(&full[s], SM::STAGE_BYTES);
      uint8_t* k_s = ring + s * SM::STAGE_BYTES;
      const int k0 = r.lo + t * FW_BK;
#pragma unroll
      for (int b = 0; b < SM::BOXES; ++b) {
        wg_tma_3d(k_s + b * FW_BOX, &map_k, &full[s], b * 64, k0, bkv);
        wg_tma_3d(k_s + SM::KV_BYTES + b * FW_BOX, &map_v, &full[s], b * 64, k0, bkv);
      }
    }
    return;
  }

  // ---- the consumer warpgroup
  const int t = threadIdx.x;
  const int rl = (t >> 5) * 16 + ((t & 31) >> 2);  // this thread's rows rl and rl + 8 of the tile
  const int cl = 2 * (t & 3);                      // and its column pairs cl + 8 n
  constexpr int OACC = DP / 2;
  float oacc[OACC];
#pragma unroll
  for (int j = 0; j < OACC; ++j) oacc[j] = 0.f;
  float m_r[2] = {FW_NEG, FW_NEG}, l_r[2] = {0.f, 0.f};
  if (st.load) {  // the carried state; l whole in lane 0 of each quad (summed over the quad at the end)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rl + 8 * h;
      if (row < Sq) {
        m_r[h] = st.m[static_cast<long>(bh) * Sq + row];
        if ((t & 3) == 0) l_r[h] = st.l[static_cast<long>(bh) * Sq + row];
      }
    }
#pragma unroll
    for (int j = 0; j < OACC; j += 2) {
      const int row = q0 + rl + 8 * ((j >> 1) & 1);
      if (row < Sq && cl + 8 * (j >> 2) < D) {
        const float2 p = *reinterpret_cast<const float2*>(st.o + (static_cast<long>(bh) * Sq + row) * D + cl + 8 * (j >> 2));
        oacc[j] = p.x;
        oacc[j + 1] = p.y;
      }
    }
  }
  const int qpos0 = q0 + rl + off;  // key position of row rl (row rl + 8: + 8)
  const bool signal = (t & 31) == 0;
  const uint32_t q_addr = wg_smem(q_s);

  wg_mbar_wait(qbar, 0);
  for (int kt = 0; kt < r.n; ++kt) {
    const int s = kt % FW_STAGES, round = kt / FW_STAGES;
    const int k0 = r.lo + kt * FW_BK;
    wg_mbar_wait(&full[s], round & 1);
    const uint32_t k_addr = wg_smem(ring + s * SM::STAGE_BYTES);
    const uint32_t v_addr = k_addr + SM::KV_BYTES;

    // S = Q K^T: 64 x 64, f32
    float sacc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sacc[j] = 0.f;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {  // columns D..DP are zero: no k-step reads them
      const uint32_t boff = (kk / 4) * FW_BOX + (kk % 4) * 32;
      fa_mma_ss_n64(sacc, wg_desc_a(q_addr + boff), wg_desc_a(k_addr + boff), kk != 0);
    }
    wg_commit();
    wg_wait<0>();

    // mask only where the tile straddles the causal diagonal, the window's
    // edge or the end of the keys
    const bool edge = k0 + FW_BK > Sk || (causal && k0 + FW_BK - 1 > q0 + off) ||
                      (window > 0 && q0 + FW_BQ - 1 + off - k0 >= window);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float v = sacc[j] * scale_log2;
      if (edge) {
        const int kpos = k0 + cl + 8 * (j >> 2) + (j & 1);
        const int qpos = qpos0 + 8 * ((j >> 1) & 1);
        bool ok = true;
        if (causal) ok = qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos < window);
        if (!ok) v = FW_NEG;
        if (kpos >= Sk) v = __int_as_float(0xff800000);  // -inf, no key: p = 0
      }
      sacc[j] = v;
    }
    // online softmax, rows rl (h = 0) and rl + 8 (h = 1), log2 domain
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = FW_NEG;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (((j >> 1) & 1) == h) mx = fmaxf(mx, sacc[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[h], mx);
      alpha[h] = exp2f(m_r[h] - m_new);
      m_r[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if (((j >> 1) & 1) == h) {
          sacc[j] = exp2f(sacc[j] - m_new);
          sum += sacc[j];
        }
      l_r[h] = l_r[h] * alpha[h] + sum;
    }
#pragma unroll
    for (int j = 0; j < OACC; ++j) oacc[j] *= alpha[(j >> 1) & 1];
    // P in bf16: the accumulator pairs (8 kk + 2 i, + 1) are the A registers of k-step kk
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 pr = __floats2bfloat162_rn(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1]);
        pa[kk][i] = *reinterpret_cast<const uint32_t*>(&pr);
      }
    // O += P V
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = wg_desc(v_addr + kk * 2048, FW_BOX, 1024);
      if constexpr (DP == 64) {
        fa_mma_rs_n64(oacc, pa[kk], db, 1);
      } else if constexpr (DP == 128) {
        fa_mma_rs_n128(oacc, pa[kk], db, 1);
      } else {
        fa_mma_rs_n256(oacc, pa[kk], db, 1);
      }
    }
    wg_commit();
    wg_wait<0>();
    if (signal) wg_mbar_arrive(&empty[s]);
  }

  // O / l, cast, stored as bf16 pairs; rows past Sq are not stored
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[h] = 1.f / fmaxf(l, 1e-30f);
    l_r[h] = l;
  }
  if (st.store) {  // the state for the next launch, unnormalised
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + rl + 8 * h;
      if (row < Sq && (t & 3) == 0) {
        st.m[static_cast<long>(bh) * Sq + row] = m_r[h];
        st.l[static_cast<long>(bh) * Sq + row] = l_r[h];
      }
    }
#pragma unroll
    for (int j = 0; j < OACC; j += 2) {
      const int row = q0 + rl + 8 * ((j >> 1) & 1);
      if (row < Sq && cl + 8 * (j >> 2) < D)
        *reinterpret_cast<float2*>(st.o + (static_cast<long>(bh) * Sq + row) * D + cl + 8 * (j >> 2)) =
            make_float2(oacc[j], oacc[j + 1]);
    }
    return;
  }
  __nv_bfloat16* ob = o + static_cast<long>(bh) * Sq * D;
#pragma unroll
  for (int j = 0; j < OACC; j += 2) {
    const int h = (j >> 1) & 1;
    const int row = q0 + rl + 8 * h;
    const int col = cl + 8 * (j >> 2);
    if (row < Sq && col < D)
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long>(row) * D + col) =
          __floats2bfloat162_rn(oacc[j] * inv[h], oacc[j + 1] * inv[h]);
  }
}

template <int D, int DP>
static int fw_launch(const void* q, const void* k, const void* v, void* o, int BH, int BHkv, int Sq, int Sk,
                     float scale, int causal, int window, const FaMap& fmap, const FaState& fst, int* info,
                     cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  const cuuint64_t dq[3] = {(cuuint64_t)D, (cuuint64_t)Sq, (cuuint64_t)BH};
  const cuuint64_t dk[3] = {(cuuint64_t)D, (cuuint64_t)Sk, (cuuint64_t)BHkv};
  const cuuint64_t sq[2] = {(cuuint64_t)D, (cuuint64_t)Sq * D};
  const cuuint64_t sk[2] = {(cuuint64_t)D, (cuuint64_t)Sk * D};
  const cuuint32_t box[3] = {64, 64, 1};
  int rc = wg_tensor_map(&mq, q, 3, dq, sq, box);
  if (rc == 0) rc = wg_tensor_map(&mk, k, 3, dk, sk, box);
  if (rc == 0) rc = wg_tensor_map(&mv, v, 3, dk, sk, box);
  if (rc != 0) return rc;
  static bool opted = false;  // one card per process
  if (!opted) {
    cudaError_t e = cudaFuncSetAttribute(fa_wgmma_kernel<D, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         FwSmem<DP>::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted = true;
  }
  const dim3 grid((Sq + FW_BQ - 1) / FW_BQ, BH);
  info[0] = static_cast<int>(grid.x * grid.y);
  const float scale_log2 = scale * 1.4426950408889634f;
  fa_wgmma_kernel<D, DP><<<grid, FW_THREADS, FwSmem<DP>::BYTES, st>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), Sq, Sk,
                                                                  scale_log2, causal, window, fmap, fst);
  return static_cast<int>(cudaGetLastError());
}

// bf16 q [BH, Sq, D], k/v [BHkv, Sk, D] -> o; D 64, 80, 128 or 256; bases 16-byte
// aligned (TMA).  map (host int table, flash_map.cuh) places W ranks' heads
// and positions; m / l / so are the f32 state (load: read it; store: write
// it instead of o; null when neither).  info (host int[1]) receives the
// number of CTAs.
extern "C" int tl_flash_attention_wgmma(const void* q, const void* k, const void* v, void* o, void* m, void* l,
                                        void* so, int BH, int BHkv, int Sq, int Sk, int D, float scale, int causal,
                                        int window, int W, const void* map, int load, int store, void* info,
                                        void* stream) {
  if (BH < 1 || BHkv < 1 || Sq < 1 || Sk < 1) return static_cast<int>(cudaErrorInvalidValue);
  FaMap fmap;
  int rc = fa_make_map(&fmap, static_cast<const int*>(map), W, BH, BHkv);
  if (rc != 0) return rc;
  const FaState fst{static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(so), load, store};
  if ((load || store) && (m == nullptr || l == nullptr || so == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (!store && o == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* inf = static_cast<int*>(info);
  if (D == 64) return fw_launch<64, 64>(q, k, v, o, BH, BHkv, Sq, Sk, scale, causal, window, fmap, fst, inf, st);
  if (D == 80) return fw_launch<80, 128>(q, k, v, o, BH, BHkv, Sq, Sk, scale, causal, window, fmap, fst, inf, st);
  if (D == 128) return fw_launch<128, 128>(q, k, v, o, BH, BHkv, Sq, Sk, scale, causal, window, fmap, fst, inf, st);
  if (D == 256) return fw_launch<256, 256>(q, k, v, o, BH, BHkv, Sq, Sk, scale, causal, window, fmap, fst, inf, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
