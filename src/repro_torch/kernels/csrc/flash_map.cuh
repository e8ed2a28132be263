// Where a flash-attention launch's heads sit, shared by both routes
// (flash_attention_wgmma.cu, flash_attention.cu).
//
// A launch covers W ranks folded into the head dimension (the sequence-
// parallel ring of core/overlap.ring_attention runs one launch per plan step
// and channel for all W emulated ranks).  Rank r owns gpr groups (its batch
// rows) of hq query heads and of hk KV heads, in that order; head h of group g
// reads KV head g * hk + hoff[r] + h / rep (the per-KV-group GQA ring reads
// only its group of the held tile, with no copy).  Query row i of rank r sits
// delta[r] positions after key i: the causal / window masks and the block
// skip compare q position - k position only.  The default launch is one rank,
// one group of BH heads, delta Sk - Sq (queries right-aligned to keys).
//
// order[] lists the ranks by descending work (visible KV tiles, counted on the
// host): blockIdx.y walks the ranks in that order, so the longest ranges are
// issued first.
#pragma once

constexpr int FA_MAX_RANKS = 32;

struct FaMap {
  int hq, hk, rep, gpr;
  int delta[FA_MAX_RANKS];
  int hoff[FA_MAX_RANKS];
  int order[FA_MAX_RANKS];
};

// blockIdx.y -> (query head bh, KV head bkv, delta)
__device__ __forceinline__ void fa_place(const FaMap& m, int y, int& bh, int& bkv, int& delta) {
  const int per_rank = m.hq * m.gpr;
  const int r = m.order[y / per_rank];
  bh = r * per_rank + y % per_rank;
  const int g = bh / m.hq;
  bkv = g * m.hk + m.hoff[r] + (bh % m.hq) / m.rep;
  delta = m.delta[r];
}

// The host table {hq, hk, rep, gpr, delta[W], hoff[W], order[W]} -> FaMap,
// checked against the launch's head counts.  Returns 0 or cudaErrorInvalidValue.
static inline int fa_make_map(FaMap* m, const int* tbl, int W, int BH, int BHkv) {
  if (W < 1 || W > FA_MAX_RANKS || tbl == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  m->hq = tbl[0];
  m->hk = tbl[1];
  m->rep = tbl[2];
  m->gpr = tbl[3];
  if (m->hq < 1 || m->hk < 1 || m->rep < 1 || m->gpr < 1 || W * m->gpr * m->hq != BH || W * m->gpr * m->hk != BHkv)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int r = 0; r < FA_MAX_RANKS; ++r) {
    m->delta[r] = r < W ? tbl[4 + r] : 0;
    m->hoff[r] = r < W ? tbl[4 + W + r] : 0;
    m->order[r] = r < W ? tbl[4 + 2 * W + r] : 0;
    if (r < W && (m->hoff[r] < 0 || m->hoff[r] + (m->hq - 1) / m->rep >= m->hk || m->order[r] < 0 ||
                  m->order[r] >= W))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The float32 online-softmax state carried between launches: m and l [BH,
// Sq], o [BH, Sq, D] (unnormalised).  load: read it before the first KV tile;
// store: write it back instead of the normalised output.
struct FaState {
  float* m;
  float* l;
  float* o;
  int load, store;
};
