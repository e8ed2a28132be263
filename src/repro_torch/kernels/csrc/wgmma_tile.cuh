// Hopper tile GEMM body for bf16 operands: TMA -> shared-memory ring -> wgmma.
//
// The body of every bf16 kernel: ag_gemm.cu, gemm_rs.cu and the plain and
// grouped GEMM of wgmma_gemm.cu.  It replaces, for bf16, the TPU tile loop
// those kernels run (src/repro/kernels/matmul.py::_matmul_kernel: fp32
// accumulator over the K grid dimension, cast at store).  tile_gemm.cuh
// stays the float32 body.
//
// One block of 288 threads computes BM x BN = 128 x 128 output tiles:
//
//   * a ring of STAGES shared-memory stages, each one A box (BM rows x BK =
//     64 of K, K-major, 16 KB) and one B box (BK rows of K x BN, N-major, two
//     64-column TMA boxes of 8 KB), filled by cp.async.bulk.tensor from
//     CUtensorMaps with 128-byte swizzle; completion on a "full" mbarrier
//     per stage (expect_tx), release on an "empty" mbarrier per stage;
//   * warp 8 (one lane) is the producer: it waits for a free stage and issues
//     the TMA loads (wg_produce);
//   * warps 0-7 are two consumer warpgroups, rows 0-63 and 64-127 of the
//     tile; each issues wgmma.mma_async m64n128k16 bf16 x bf16 -> f32 with A
//     K-major and B N-major (the transpose bit: the weights stay [K, N] with
//     N contiguous), keeps one wgmma group in flight and frees a stage when
//     the group that read it has retired (wg_mainloop);
//   * the f32 accumulator stays in registers (64 a thread) and goes to an
//     epilogue functor epi(row, col, v_col, v_col+1) for every pair with
//     row < m and col < n (col is even; every width is a multiple of 8), so
//     each kernel fuses its own store, partial add or peer store
//     (wg_epilogue).
//
// The producer and the consumers walk the same sequence of K blocks (item
// after item in a persistent kernel), so one RingPos each stays in step.
// TMA zero-fills every element outside the tensor map's bounds: ragged M, N
// and K edges need no padding by the caller; the global strides must be
// multiples of 16 bytes (K and row widths multiples of 8 bf16 elements) and
// the base 16-byte aligned (checked by the wrappers).
//
// Packed weights (weight-only int8 / int4, the reference's PackedWeight):
// a packed kernel's stage also holds a Q box, the BK x BN int8 codes of the
// weight (N-major, no swizzle: row k at k*BN bytes), which the producer
// loads by TMA in place of the bf16 B boxes.  Once the stage lands, the 256
// consumer threads convert it (wg_dequant_b): each code minus its column's
// zero point, rounded to bf16 (exact for |q - z| <= 256), stored into the
// stage's B region in the 128-byte swizzle the wgmma descriptor expects;
// then a proxy fence and the consumer barrier, and the wgmma reads it as it
// reads a TMA-loaded B box.  The per-column scale multiplies the float32
// accumulator in the kernel's epilogue.  So HBM -> shared memory moves one
// byte per weight element, and the product is exact up to the order of the
// sums (and the bf16 rounding of q - z beyond 256).
//
// Bound on this card: bf16 tensor cores (989 TFLOP/s dense for the card,
// about 7.5 per SM) once the ring hides the loads; a 128 x 128 tile reads
// 32 KB of shared memory per 2 MFLOP, under the SM's shared-memory rate.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;  // 128 bytes of bf16: one swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;           // two warpgroups of 64 rows
constexpr int THREADS = CONSUMERS + 32;  // + the producer warp
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BK * BN * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + slack to align the ring to 1024 B
constexpr int QB_BYTES = BK * BN;                          // a packed stage's int8 Q box
constexpr int STAGE_BYTES_Q = STAGE_BYTES + QB_BYTES;      // A | B (converted) | Q
constexpr int LOAD_BYTES_Q = A_BYTES + QB_BYTES;           // what TMA brings to a packed stage
constexpr int SMEM_BYTES_Q = STAGES * STAGE_BYTES_Q + 1024;
constexpr int ACC = BN / 2;                              // f32 accumulators a thread (m64n128)
constexpr int CONSUMER_BAR = 1;                          // named barrier of the 256 consumer threads
}  // namespace wg

__device__ __forceinline__ uint32_t wg_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void wg_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(wg_smem(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void wg_mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(wg_smem(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void wg_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(wg_smem(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void wg_mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(wg_smem(bar)), "r"(parity)
        : "memory");
  }
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void wg_tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::
          "r"(wg_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(wg_smem(bar))
      : "memory");
}

__device__ __forceinline__ void wg_tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::
          "r"(wg_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(wg_smem(bar))
      : "memory");
}

__device__ __forceinline__ void wg_tma_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];" ::"r"(wg_smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(wg_smem(bar))
      : "memory");
}

// Order this thread's generic-proxy accesses (e.g. a flag just acquired, or
// stores to a gather slot) against its async-proxy (TMA) accesses after it.
__device__ __forceinline__ void wg_fence_proxy_async() { asm volatile("fence.proxy.async;" ::: "memory"); }

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo_bytes & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo_bytes & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// A: K-major, rows of 128 bytes, 8-row groups 1024 B apart (LBO unused).
__device__ __forceinline__ uint64_t wg_desc_a(uint32_t addr) { return wg_desc(addr, 16, 1024); }
// B: N-major (transposed), K rows of 128 bytes (64 columns); the second
// 64-column box lies B_BYTES / 2 further (LBO), 8-row K groups 1024 B apart (SBO).
__device__ __forceinline__ uint64_t wg_desc_b(uint32_t addr) { return wg_desc(addr, wg::B_BYTES / 2, 1024); }

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[64] (+)= A[64 x 16] (K-major) x B[16 x 128] (N-major), bf16 -> f32
__device__ __forceinline__ void wg_mma_m64n128k16(float (&d)[wg::ACC], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the ring --------------------------------------------------------------

struct WgRing {
  uint8_t* tiles;  // STAGES x (A box | B box [| Q box]), 1024-byte aligned
  uint64_t* full;
  uint64_t* empty;
  int stride;  // bytes of a stage: STAGE_BYTES, or STAGE_BYTES_Q with a Q box
  __device__ __forceinline__ uint8_t* a(int s) const { return tiles + s * stride; }
  __device__ __forceinline__ uint8_t* b(int s) const { return tiles + s * stride + wg::A_BYTES; }
  __device__ __forceinline__ uint8_t* q(int s) const { return tiles + s * stride + wg::STAGE_BYTES; }
};

struct RingPos {
  int stage = 0;
  int phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == wg::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// All THREADS threads call it (it ends in __syncthreads).  smem_raw is the
// dynamic shared memory (SMEM_BYTES, or SMEM_BYTES_Q for stride
// STAGE_BYTES_Q), bars 2 * STAGES static mbarriers.
__device__ __forceinline__ WgRing wg_ring_setup(uint8_t* smem_raw, uint64_t* bars, int stride = wg::STAGE_BYTES) {
  const uint32_t base = wg_smem(smem_raw);
  WgRing ring{smem_raw + ((1024 - (base & 1023)) & 1023), bars, bars + wg::STAGES, stride};
  if (threadIdx.x == 0) {
    for (int s = 0; s < wg::STAGES; ++s) {
      wg_mbar_init(&ring.full[s], 1);                        // the producer's expect_tx
      wg_mbar_init(&ring.empty[s], wg::CONSUMERS / 32);  // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// Producer (one thread): nk stages; load(kb, a_box, b_box, full_bar) issues
// the TMA loads of K block kb, `bytes` in all (STAGE_BYTES; a packed kernel
// passes its Q box as b_box and LOAD_BYTES_Q).
template <typename Load>
__device__ __forceinline__ void wg_produce(const WgRing& ring, RingPos& pos, int nk, Load& load,
                                           int bytes = wg::STAGE_BYTES) {
  for (int kb = 0; kb < nk; ++kb) {
    wg_mbar_wait(&ring.empty[pos.stage], pos.phase ^ 1);
    wg_mbar_expect_tx(&ring.full[pos.stage], bytes);
    load(kb, ring.a(pos.stage), bytes == wg::STAGE_BYTES ? ring.b(pos.stage) : ring.q(pos.stage),
         &ring.full[pos.stage]);
    pos.advance();
  }
}

struct WgNoHook {
  __device__ __forceinline__ void operator()(int, const uint8_t*) const {}
};

// Consumer warpgroup wgi (0 or 1): acc = A[64 rows of wgi] x B over nk K
// blocks.  hook(kb, a_box) runs on every consumer thread once K block kb's
// stage has landed, before the stage can be refilled (the AG push reads the
// A box there).
template <typename Hook = WgNoHook>
__device__ __forceinline__ void wg_mainloop(const WgRing& ring, RingPos& pos, int nk, int wgi,
                                            float (&acc)[wg::ACC], const Hook& hook = Hook()) {
  const bool signal = (threadIdx.x & 31) == 0;
  int prev = -1;
  for (int kb = 0; kb < nk; ++kb) {
    wg_mbar_wait(&ring.full[pos.stage], pos.phase);
    hook(kb, ring.a(pos.stage));
    wg_fence();
    const uint32_t a = wg_smem(ring.a(pos.stage)) + wgi * (64 * wg::BK * 2);
    const uint32_t b = wg_smem(ring.b(pos.stage));
#pragma unroll
    for (int kk = 0; kk < wg::BK / 16; ++kk)  // A: 32 bytes along the row; B: 16 rows of 128 bytes
      wg_mma_m64n128k16(acc, wg_desc_a(a + kk * 32), wg_desc_b(b + kk * 2048), (kb | kk) != 0);
    wg_commit();
    wg_wait<1>();  // the group of K block kb - 1 has retired: its stage is free
    if (prev >= 0 && signal) wg_mbar_arrive(&ring.empty[prev]);
    prev = pos.stage;
    pos.advance();
  }
  wg_wait<0>();
  if (prev >= 0 && signal) wg_mbar_arrive(&ring.empty[prev]);
}

// The 256 consumer threads of a packed kernel, once K block k0 / BK's stage
// has landed: B[k][j] = bf16(q[k][j] - zero[col0 + j]) for the BK x BN Q box
// (row k at k*BN bytes), stored in the B box layout of wg_desc_b (two
// 64-column boxes, 128-byte swizzle: 16-byte chunk c of row k at k*128 +
// (c ^ k%8)*16).  Columns at or past ncols and rows at or past K are 0.
// Thread t converts the 16 columns (t%8)*16.. of rows t/8 and t/8 + 32,
// 8 columns (one 16-byte chunk) at a time, to keep its registers few
// beside the 64 of the accumulator.
// Ends with the proxy fence and the consumer barrier: the wgmma (async
// proxy) then reads what the generic stores wrote.
__device__ __forceinline__ void wg_dequant_b(const uint8_t* qbox, uint8_t* bbox, const float* zero, int ncols,
                                             int k0, int K) {
  const int cc = threadIdx.x & 7;
#pragma unroll 1
  for (int u = 0; u < 2; ++u) {
    const int k = (threadIdx.x >> 3) + 32 * u;
    uint8_t* row = bbox + (cc >> 2) * (wg::B_BYTES / 2) + k * 128;  // box (cc / 4), K row k
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // two 16-byte chunks of 8 columns: chunk (cc % 4) * 2 + h of the row
      const int j0 = cc * 16 + h * 8;
      const uint2 raw = *reinterpret_cast<const uint2*>(qbox + k * wg::BN + j0);
      uint32_t out[4];
#pragma unroll
      for (int i = 0; i < 8; i += 2) {
        const uint32_t word = i < 4 ? raw.x : raw.y;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + i + e;
          const int code = static_cast<int8_t>((word >> (8 * ((i + e) & 3))) & 0xff);
          v[e] = (j < ncols && k0 + k < K) ? static_cast<float>(code) - __ldg(zero + j) : 0.f;
        }
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[0], v[1]);
        out[i >> 1] = *reinterpret_cast<const uint32_t*>(&b2);
      }
      const int c = (cc & 3) * 2 + h;
      *reinterpret_cast<uint4*>(row + ((c ^ (k & 7)) << 4)) = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, %1;" ::"n"(wg::CONSUMER_BAR), "n"(wg::CONSUMERS) : "memory");
}

// A consumer warpgroup with no rows to compute in an item walks its nk
// stages all the same, so the ring stays in step: it waits for each stage
// to land (or it could free a stage of the next round early) and frees it.
__device__ __forceinline__ void wg_skip(const WgRing& ring, RingPos& pos, int nk) {
  const bool signal = (threadIdx.x & 31) == 0;
  for (int kb = 0; kb < nk; ++kb) {
    wg_mbar_wait(&ring.full[pos.stage], pos.phase);
    if (signal) wg_mbar_arrive(&ring.empty[pos.stage]);
    pos.advance();
  }
}

// The 256 consumer threads store rows [0, rows) of an A box (BM rows x BK
// columns, 128-byte swizzle: 16-byte chunk j of row i sits at
// i*128 + (j ^ i%8)*16) to dst + i*ld + k0, columns k0 .. min(k0 + BK, K).
__device__ __forceinline__ void wg_store_a_box(const uint8_t* box, __nv_bfloat16* dst, long ld, int rows, int k0,
                                               int K) {
  for (int q = threadIdx.x; q < wg::BM * (wg::BK / 8); q += wg::CONSUMERS) {
    const int i = q / (wg::BK / 8), j = q % (wg::BK / 8);
    if (i < rows && k0 + j * 8 < K) {
      const uint4 v = *reinterpret_cast<const uint4*>(box + i * (wg::BK * 2) + ((j ^ (i & 7)) << 4));
      *reinterpret_cast<uint4*>(dst + i * ld + k0 + j * 8) = v;
    }
  }
}

// Accumulator layout of m64nNk16: thread t of the warpgroup holds rows
// 16*(t/32) + (t%32)/4 (+8) and column pairs 8*j + 2*(t%4).  epi may take
// the two values by reference to update the accumulator in place (a pass of
// loads only, which the compiler can keep in flight together).
template <typename Epi>
__device__ __forceinline__ void wg_epilogue(float (&acc)[wg::ACC], int wgi, int m, int n, Epi& epi) {
  const int t = threadIdx.x & 127;
  const int r0 = wgi * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
  const int c0 = 2 * (t & 3);
#pragma unroll
  for (int j = 0; j < wg::ACC; j += 2) {
    const int row = r0 + 8 * ((j >> 1) & 1);
    const int col = c0 + 8 * (j >> 2);
    if (row < m && col < n) epi(row, col, acc[j], acc[j + 1]);
  }
}

// A work item of the persistent fused kernels: step / stage s, rank r,
// channel c, n-tile nt, m-tile mt.  Items are numbered stage-major with the
// m-tile fastest, so blocks that run at the same time share a B strip (one
// weight read from memory serves every m-tile) and a step's items all come
// before the next step's.
struct WgItem {
  int s, r, c, nt, mt;
};

__device__ __forceinline__ WgItem wg_item(int it, int W, int nch, int NT, int MT) {
  WgItem x;
  x.mt = it % MT;
  it /= MT;
  x.nt = it % NT;
  it /= NT;
  x.c = it % nch;
  it /= nch;
  x.r = it % W;
  x.s = it / W;
  return x;
}

__device__ __forceinline__ void wg_consumer_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(wg::CONSUMER_BAR), "n"(wg::CONSUMERS) : "memory");
}

// ---- host: tensor maps and the persistent grid ------------------------------

typedef CUresult (*WgEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static WgEncodeTiled wg_encoder() {
  static WgEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<WgEncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first), element strides
// strides[0..rank-2] of dims 1.., box `box`, 128-byte swizzle, zero fill.
// int8 = true: a map of int8 codes (bytes), no swizzle (packed weights).
static int wg_tensor_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                         const cuuint64_t* strides_elems, const cuuint32_t* box, bool int8 = false) {
  WgEncodeTiled enc = wg_encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t strides[4];
  cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  for (int i = 0; i < rank - 1; ++i) strides[i] = strides_elems[i] * (int8 ? 1 : 2);
  CUresult r = enc(map, int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                   const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   int8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The persistent grid: G = min(items, co-resident blocks), after opting the
// kernel into `smem` bytes of dynamic shared memory (SMEM_BYTES, or
// SMEM_BYTES_Q for a packed kernel).  `resident` caches the co-resident
// block count of the calling kernel (one card per process).
static int wg_grid(const void* kernel, int items, int* resident, int* grid, int smem = wg::SMEM_BYTES) {
  if (*resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    int per_sm = 0, dev = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, wg::THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    *resident = per_sm * sms;
  }
  *grid = items < *resident ? items : *resident;
  return 0;
}
