// Shared pieces of the persistent kernels (unroll.cu traj_persistent,
// unroll_bwd.cu bwd_chain and bwd_weights): one 32 x 32 output tile of a
// phase's fp32 GEMM over a depth slice, with the next step's loads in
// flight while the current step is computed, and the split-K reduction
// that sums a tile's slice partials in slice order without float
// atomics. ops/schedule.py decides the tiles and slices (TILE, BK).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBK = 16;              // depth of one shared-memory step (ops/schedule.py BK)
constexpr int kT = 32;               // output tile edge (ops/schedule.py TILE)
constexpr int kPT = 256;             // threads a block
constexpr int kPR = 16, kPC = 16;    // thread grid; each thread owns 2 x 2 outputs
constexpr int kWarps = kPT / 32;

__device__ __forceinline__ int dcdiv(int a, int b) { return (a + b - 1) / b; }

struct Split {
  int slices, len;                   // depth slices of a phase and their length
};

struct TileSmem {
  float op[2][kT][kBK + 1];          // double-buffered operand and weight steps
  float w[2][kT][kBK + 1];
  float col[kPR][kT];                // column sums of a tile (the backward's gtheta)
  double red[kWarps];                // block sums (the backward's gbeta)
  int last;                          // this block finishes the tile (split-K)
};

// acc = OPERAND[row0:+32, k_lo:k_hi] * W[k_lo:k_hi, col0:+32] for one
// tile (W^T where the weight is stored by output column); op(r, k) and
// wt(c, k) give one element (called in bounds only; zero outside).
// OP_K / W_K: the operand / weight is contiguous along
// the depth (else along rows / columns), which picks the coalesced
// staging order. The next step's loads go to registers while the current
// step is computed from the other shared-memory buffer: one barrier a
// step.
template <bool OP_K, bool W_K, class OpF, class WF>
__device__ __forceinline__ void tile_gemm(TileSmem& sm, int rows, int cols, int row0, int col0,
                                          int k_lo, int k_hi, const OpF& op, const WF& wt,
                                          float (&acc)[2][2]) {
  const int tid = threadIdx.x, tr = tid / kPC, tc = tid % kPC;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j] = 0.0f;
  float ro[2], rw[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kPT;
      const int r = OP_K ? i / kBK : i % kT, kr = OP_K ? i % kBK : i / kT;
      const int c = W_K ? i / kBK : i % kT, kc = W_K ? i % kBK : i / kT;
      ro[e] = (row0 + r < rows && k0 + kr < k_hi) ? op(row0 + r, k0 + kr) : 0.0f;
      rw[e] = (col0 + c < cols && k0 + kc < k_hi) ? wt(col0 + c, k0 + kc) : 0.0f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = tid + e * kPT;
      const int r = OP_K ? i / kBK : i % kT, kr = OP_K ? i % kBK : i / kT;
      const int c = W_K ? i / kBK : i % kT, kc = W_K ? i % kBK : i / kT;
      sm.op[buf][r][kr] = ro[e];
      sm.w[buf][c][kc] = rw[e];
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
      const float o0 = sm.op[buf][tr][kk], o1 = sm.op[buf][tr + kPR][kk];
      const float w0 = sm.w[buf][tc][kk], w1 = sm.w[buf][tc + kPC][kk];
      acc[0][0] = fmaf(o0, w0, acc[0][0]);
      acc[0][1] = fmaf(o0, w1, acc[0][1]);
      acc[1][0] = fmaf(o1, w0, acc[1][0]);
      acc[1][1] = fmaf(o1, w1, acc[1][1]);
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
__device__ __forceinline__ bool reduce_slices(TileSmem& sm, float (&acc)[2][2], float* part,
                                              int* cnt, int tile, int slice, int slices) {
  if (slices == 1) return true;
  const int tid = threadIdx.x, tr = tid / kPC, tc = tid % kPC;
  float* p = part + (size_t)tile * slices * (kT * kT);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      __stcg(p + (size_t)slice * (kT * kT) + (tr + i * kPR) * kT + tc + j * kPC, acc[i][j]);
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
  // and of the thread's four outputs are in flight together.
  const float* q = p + tr * kT + tc;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j] = __ldcg(q + i * kPR * kT + j * kPC);
#pragma unroll 4
  for (int z = 1; z < slices; ++z) {
    const float* qz = q + (size_t)z * (kT * kT);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][j] += __ldcg(qz + i * kPR * kT + j * kPC);
  }
  return true;
}

}  // namespace
