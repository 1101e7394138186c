// Shared pieces of the persistent kernels (unroll.cu traj_persistent and
// unroll_persistent, unroll_bwd.cu bwd_chain and bwd_weights): one T x T
// output tile of a phase's fp32 GEMM over a depth slice, with the next
// step's loads in flight while the current step is computed, and the
// split-K reduction that sums a tile's slice partials in slice order
// without float atomics. ops/schedule.py decides the tiles and slices
// (TILE or the serving plan's tile, BK). T is 32 (2 x 2 outputs a
// thread) everywhere but the serving kernel's 64 (4 x 4); BF16 rounds
// both operands to bf16 as they are staged (the layer step's option).
// The operands arrive as fp32 whatever their storage (the serving
// kernel's bf16 storage widens them as it loads them).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBK = 16;              // depth of one shared-memory step (ops/schedule.py BK)
constexpr int kT = 32;               // output tile edge but the serving kernel's (ops/schedule.py TILE)
constexpr int kPT = 256;             // threads a block
constexpr int kPR = 16, kPC = 16;    // thread grid; each thread owns T/16 x T/16 outputs
constexpr int kWarps = kPT / 32;

__device__ __forceinline__ int dcdiv(int a, int b) { return (a + b - 1) / b; }

struct Split {
  int slices, len;                   // depth slices of a phase and their length
};

template <int T>
struct TileSmemT {
  float op[2][T][kBK + 1];           // double-buffered operand and weight steps
  float w[2][T][kBK + 1];
  float col[kPR][T];                 // column sums of a tile (the backward's gtheta)
  double red[kWarps];                // block sums (the backward's gbeta)
  int last;                          // this block finishes the tile (split-K)
};
using TileSmem = TileSmemT<kT>;

// acc = OPERAND[row0:+T, k_lo:k_hi] * W[k_lo:k_hi, col0:+T] for one
// tile (W^T where the weight is stored by output column); op(r, k) and
// wt(c, k) give one element (called in bounds only; zero outside).
// Thread (tr, tc) owns rows tr + i*kPR and columns tc + j*kPC.
// OP_K / W_K: the operand / weight is contiguous along
// the depth (else along rows / columns), which picks the coalesced
// staging order. The next step's loads go to registers while the current
// step is computed from the other shared-memory buffer: one barrier a
// step.
template <bool OP_K, bool W_K, int T = kT, bool BF16 = false, class OpF, class WF>
__device__ __forceinline__ void tile_gemm(TileSmemT<T>& sm, int rows, int cols, int row0, int col0,
                                          int k_lo, int k_hi, const OpF& op, const WF& wt,
                                          float (&acc)[T / kPR][T / kPC]) {
  constexpr int TM = T / kPR, TN = T / kPC, E = T * kBK / kPT;  // E: staged elements a thread
  const int tid = threadIdx.x, tr = tid / kPC, tc = tid % kPC;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float ro[E], rw[E];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = tid + e * kPT;
      const int r = OP_K ? i / kBK : i % T, kr = OP_K ? i % kBK : i / T;
      const int c = W_K ? i / kBK : i % T, kc = W_K ? i % kBK : i / T;
      ro[e] = (row0 + r < rows && k0 + kr < k_hi) ? op(row0 + r, k0 + kr) : 0.0f;
      rw[e] = (col0 + c < cols && k0 + kc < k_hi) ? wt(col0 + c, k0 + kc) : 0.0f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = tid + e * kPT;
      const int r = OP_K ? i / kBK : i % T, kr = OP_K ? i % kBK : i / T;
      const int c = W_K ? i / kBK : i % T, kc = W_K ? i % kBK : i / T;
      sm.op[buf][r][kr] = BF16 ? __bfloat162float(__float2bfloat16_rn(ro[e])) : ro[e];
      sm.w[buf][c][kc] = BF16 ? __bfloat162float(__float2bfloat16_rn(rw[e])) : rw[e];
    }
  };
  __syncthreads();  // the previous item may still read the buffers or sm.last
  fetch(k_lo);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    const bool more = k0 + kBK < k_hi;
    if (more) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float o[TM], w[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) o[i] = sm.op[buf][tr + i * kPR][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = sm.w[buf][tc + j * kPC][kk];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(o[i], w[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
}

// Split-K: each slice writes its partial tile; the last block to arrive
// at the tile's counter sums the partials in slice order into acc and
// resets the counter. Returns whether this block now holds the tile's
// full sum (always, for one slice). Block-uniform.
template <int T = kT>
__device__ __forceinline__ bool reduce_slices(TileSmemT<T>& sm, float (&acc)[T / kPR][T / kPC],
                                              float* part, int* cnt, int tile, int slice, int slices) {
  constexpr int TM = T / kPR, TN = T / kPC;
  if (slices == 1) return true;
  const int tid = threadIdx.x, tr = tid / kPC, tc = tid % kPC;
  float* p = part + (size_t)tile * slices * (T * T);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      __stcg(p + (size_t)slice * (T * T) + (tr + i * kPR) * T + tc + j * kPC, acc[i][j]);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(cnt + tile, 1);
    sm.last = done == slices - 1;
    if (sm.last) cnt[tile] = 0;  // next used after a grid barrier or launch
  }
  __syncthreads();
  if (!sm.last) return false;
  __threadfence();
  // Each output's sum runs in slice order; the loads of several slices
  // and of the thread's outputs are in flight together.
  const float* q = p + tr * T + tc;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = __ldcg(q + i * kPR * T + j * kPC);
#pragma unroll 4
  for (int z = 1; z < slices; ++z) {
    const float* qz = q + (size_t)z * (T * T);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += __ldcg(qz + i * kPR * T + j * kPC);
  }
  return true;
}

}  // namespace
