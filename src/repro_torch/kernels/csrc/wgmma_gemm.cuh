// The persistent bf16 GEMM of wgmma_gemm.cu: the bf16 route of tl_matmul
// (one row tile of M rows, one expert, no table) and of tl_grouped_matmul.
#pragma once

#include <cuda_runtime.h>

// out[rows of tile t] = x[rows of tile t] @ w[tile_expert[t]] for x [T*bm, K]
// and w [E, K, N] in bf16, out [T*bm, N] in float32 (out_f32) or bf16; a
// null table is expert 0 for every tile.  K and N must be multiples of 8 and
// the bases 16-byte aligned (TMA).  info (host int[2]) receives the grid G
// and the item count.  Returns a CUDA error code (0 on success).
int wgmma_gemm(int out_f32, const void* x, const void* w, const void* tile_expert, void* out, int T, int bm, int N,
               int K, int E, int* info, cudaStream_t stream);
