// The wide tile of the serving kernel, the trajectory (unroll.cu
// unroll_persistent<kWT, ...>, traj_persistent<kWT, float>) and the
// backward chain (unroll_bwd.cu bwd_chain<kWT, float>): one 128 x 128
// output tile of a phase's fp32 GEMM over a depth slice, designed for the
// H100's fp32 pipes, its ring of stages and its split-K reduction.
//
// wide_gemm: both operands are K-contiguous matrices read as they are:
// OUT[r][c] = sum_q P[r][q] * W[c][q] (the serving kernel's u, x1 or v
// against W1, A or W2, each row `depth` long). wide_gemm_dm: the weight
// is stored by depth, OUT[r][c] = sum_q P[r][q] * W[q][c] (the chain's
// gp2 W2, gAx1 A, gp1 W1); its staging is below. The tile_gemm of
// persistent.cuh builds its operand element by element and stages 4
// bytes at a time; here the operand is a plain matrix that an earlier epilogue wrote, so both are
// copied from global to shared memory 16 bytes at a time with cp.async
// (L2 only: state written in the call is never read through a stale L1
// line) into a ring of kWStages stages, and the copies of the next
// stages run while the current one is computed. Bounds are tested per
// 16-byte chunk: the chunks past the tile's edge or the slice's depth
// are filled with zeros. That needs every row to start on 16 bytes and
// the depth to be a multiple of a chunk (m and n multiples of 4, or of 8
// for bf16 storage; ops/schedule.tile_edge).
//
// Register blocking. 256 threads own 8 x 8 outputs each: thread (ty, tx)
// the rows ty + 16 i and the columns tx + 16 j. Shared memory holds both
// operands row by row ([row][k], rows padded from 16 to 20 floats), and a
// thread reads four depths of a row as one 16-byte LDS.128: 16 of them
// feed 256 FMAs, 4 FMAs for every 4 bytes read (the old 64 tile: 2). A
// warp is 4 x 8 threads, so each LDS.128 of the operand reads 4 rows (the
// padding puts them in different banks) and each of the weight 8 columns
// (all 32 banks): no bank conflict. Shared memory does not set the pace:
// reading a quarter as much of it left the time within 2% (PERF.md).
// Each output's sum runs over the depth in order with fmaf, as
// tile_gemm's does.
//
// The ring holds 3 stages (61 KB; 4 and 6 were no faster) at one block a
// SM, whose 8 warps each hold 64 accumulators and 32 weight values in
// registers. The epilogue reuses the ring for the summed tile (rows of
// kWTP floats), which unroll.cu then reads back row by row.
//
// bf16 storage stages the weights as bf16 (16 bytes = 8 values) and
// widens them exactly as a thread reads them; BF16 (the layer step's
// option) rounds both operands to bf16 as they are read.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWT = 128;                 // wide tile edge (ops/schedule.py WIDE)
constexpr int kWBK = 16;                 // depth of one stage (ops/schedule.py BK)
constexpr int kWStages = 3;              // stages in the ring
constexpr int kWRow = kWBK + 4;          // floats a staged row (16 + 4 of padding)
constexpr int kWRow16 = kWBK + 8;        // bf16 values a staged weight row (48 bytes)
constexpr int kWOpBytes = kWT * kWRow * 4;

// Bytes of one stage and of the ring, by the weights' storage type.
template <class WT>
__host__ __device__ constexpr int wide_stage_bytes() {
  return kWOpBytes + (sizeof(WT) == 4 ? kWT * kWRow * 4 : kWT * kWRow16 * 2);
}
constexpr int kWTP = kWT + 8;             // floats a row of the epilogue's tile (bank spread)
template <class WT>
__host__ __device__ constexpr int wide_smem_bytes() {  // the ring, or the epilogue's tile
  return kWStages * wide_stage_bytes<WT>() > kWT * kWTP * 4 ? kWStages * wide_stage_bytes<WT>() : kWT * kWTP * 4;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float bf16_round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Four depths of one staged row as fp32.
__device__ __forceinline__ float4 staged4(const float* row, int k) {
  return *reinterpret_cast<const float4*>(row + k);
}
__device__ __forceinline__ float4 staged4(const __nv_bfloat16* row, int k) {
  const uint2 h = *reinterpret_cast<const uint2*>(row + k);
  return make_float4(__uint_as_float(h.x << 16), __uint_as_float(h.x & 0xffff0000u),
                     __uint_as_float(h.y << 16), __uint_as_float(h.y & 0xffff0000u));
}

// Four neighbouring values of a row, 16 bytes of fp32 or 8 of bf16,
// widened to fp32 as loaded and rounded to nearest as stored (the
// epilogues' 16-byte loads and stores).
struct F4 {
  float v[4];
};
__device__ __forceinline__ F4 widen4(uint2 h) {
  return F4{{__uint_as_float(h.x << 16), __uint_as_float(h.x & 0xffff0000u), __uint_as_float(h.y << 16),
             __uint_as_float(h.y & 0xffff0000u)}};
}
__device__ __forceinline__ F4 ld4cg(const float* p) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  return F4{{q.x, q.y, q.z, q.w}};
}
__device__ __forceinline__ F4 ld4cg(const __nv_bfloat16* p) { return widen4(__ldcg(reinterpret_cast<const uint2*>(p))); }
__device__ __forceinline__ F4 ld4g(const float* p) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  return F4{{q.x, q.y, q.z, q.w}};
}
__device__ __forceinline__ F4 ld4g(const __nv_bfloat16* p) { return widen4(__ldg(reinterpret_cast<const uint2*>(p))); }
__device__ __forceinline__ void st4(float* p, const F4& f) {
  *reinterpret_cast<float4*>(p) = make_float4(f.v[0], f.v[1], f.v[2], f.v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const F4& f) {
  unsigned short h[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __bfloat16_as_ushort(__float2bfloat16_rn(f.v[q]));
  *reinterpret_cast<uint2*>(p) = make_uint2(h[0] | (unsigned)h[1] << 16, h[2] | (unsigned)h[3] << 16);
}

// `fn` with its ceiling of dynamic shared memory raised to `bytes`, or
// null where that is refused (the error cleared for later launches).
inline const void* with_smem(const void* fn, int bytes) {
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) != cudaSuccess) {
    cudaGetLastError();
    return nullptr;
  }
  return fn;
}

// One stage of the operand: P[row0:+128, k0:+kWBK] (rows x depth, fp32,
// row stride ldp) as rows of kWRow floats ([row][k]), 16-byte chunks.
__device__ __forceinline__ void wide_stage_op(float* so, const float* P, int ldp, int rows, int row0, int k0,
                                              int k_hi) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = 0; e < kWBK / 8; ++e) {  // 128 rows x kWBK / 4 chunks of 4 floats
    const int ch = tid + e * 256, r = ch / (kWBK / 4), kc = ch % (kWBK / 4) * 4;
    const bool in = row0 + r < rows && k0 + kc < k_hi;
    cp_async16(so + r * kWRow + kc, in ? P + (size_t)(row0 + r) * ldp + k0 + kc : P, in);
  }
}

// The ring over the depth slice [k_lo, k_hi): load(slot, k0) issues the
// copies of one stage of kWBK depths into ring slot `slot`, step(slot)
// computes it once it has landed. The copies of the next kWStages - 1
// stages stay in flight while one is computed.
template <class Load, class Step>
__device__ __forceinline__ void wide_ring(int k_lo, int k_hi, const Load& load, const Step& step) {
  const int steps = (k_hi - k_lo + kWBK - 1) / kWBK;
  __syncthreads();  // the previous item may still read the ring
#pragma unroll
  for (int s = 0; s < kWStages - 1; ++s) {
    if (s < steps) load(s, k_lo + s * kWBK);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kWStages - 2>();
    __syncthreads();  // stage t has landed for every thread; stage t - 1 is read by none
    const int nt = t + kWStages - 1;
    if (nt < steps) load(nt % kWStages, k_lo + nt * kWBK);
    cp_async_commit();
    step(t % kWStages);
  }
  cp_async_wait<0>();
}

// acc = P[row0:+128, k_lo:k_hi] * W[col0:+128, k_lo:k_hi]^T for one tile;
// P (rows x depth, fp32) and W (cols x depth, WT) are read with row
// strides ldp and ldw. k_lo and k_hi are multiples of a 16-byte chunk.
template <bool BF16, class WT>
__device__ __forceinline__ void wide_gemm(unsigned char* smem, int rows, int cols, int row0, int col0,
                                          int k_lo, int k_hi, const float* P, int ldp, const WT* W, int ldw,
                                          float (&acc)[8][8]) {
  constexpr int SB = wide_stage_bytes<WT>();
  constexpr int WR = sizeof(WT) == 4 ? kWRow : kWRow16;
  constexpr int WCH = kWBK * (int)sizeof(WT) / 16;  // 16-byte chunks of a staged weight row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  auto load = [&](int slot, int k0) {
    wide_stage_op(reinterpret_cast<float*>(smem + slot * SB), P, ldp, rows, row0, k0, k_hi);
    WT* sw = reinterpret_cast<WT*>(smem + slot * SB + kWOpBytes);
#pragma unroll
    for (int e = 0; e < WCH / 2; ++e) {  // 128 columns x WCH chunks
      const int ch = tid + e * 256, c = ch / WCH, kc = (ch % WCH) * (16 / (int)sizeof(WT));
      const bool in = col0 + c < cols && k0 + kc < k_hi;
      cp_async16(sw + c * WR + kc, in ? W + (size_t)(col0 + c) * ldw + k0 + kc : W, in);
    }
  };
  wide_ring(k_lo, k_hi, load, [&](int slot) {
    const float* so = reinterpret_cast<const float*>(smem + slot * SB);
    const WT* sw = reinterpret_cast<const WT*>(smem + slot * SB + kWOpBytes);
#pragma unroll
    for (int kq = 0; kq < kWBK; kq += 4) {
      float4 w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        w[j] = staged4(sw + (tx + 16 * j) * WR, kq);
        if (BF16) w[j] = make_float4(bf16_round(w[j].x), bf16_round(w[j].y), bf16_round(w[j].z), bf16_round(w[j].w));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float4 o = staged4(so + (ty + 16 * i) * kWRow, kq);
        if (BF16) o = make_float4(bf16_round(o.x), bf16_round(o.y), bf16_round(o.z), bf16_round(o.w));
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(o.x, w[j].x, acc[i][j]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(o.y, w[j].y, acc[i][j]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(o.z, w[j].z, acc[i][j]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(o.w, w[j].w, acc[i][j]);
      }
    }
  });
}

// The depth-major variant (the backward chain's P * W, fp32): acc =
// P[row0:+128, k_lo:k_hi] * W[k_lo:k_hi, col0:+128], W (depth x cols)
// stored by depth with row stride ldw. P is staged as wide_gemm stages
// it; W depth row by depth row ([k][col]: each depth's 128 columns are
// 512 contiguous bytes, kWT floats a staged row). Thread (ty, tx) owns
// the rows ty + 16 i and the columns 4 tx + e + 64 h (acc[i][4 h + e]),
// so that one depth of its 8 columns is two LDS.128: 16 of them still
// feed 256 FMAs, and the 8 threads of a quarter warp read 128 contiguous
// bytes of a depth row (all 32 banks): no bank conflict. Each output's
// sum runs over the depth in order with fmaf. W's depth rows are tested
// one by one, so only P's staging needs the depth slice in whole chunks.
__device__ __forceinline__ void wide_gemm_dm(unsigned char* smem, int rows, int cols, int row0, int col0,
                                             int k_lo, int k_hi, const float* P, int ldp, const float* W,
                                             int ldw, float (&acc)[8][8]) {
  constexpr int SB = wide_stage_bytes<float>();
  static_assert(kWBK * kWT * 4 <= SB - kWOpBytes, "a stage of depth-major weights fits the weight's slot");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  auto load = [&](int slot, int k0) {
    wide_stage_op(reinterpret_cast<float*>(smem + slot * SB), P, ldp, rows, row0, k0, k_hi);
    float* sw = reinterpret_cast<float*>(smem + slot * SB + kWOpBytes);
#pragma unroll
    for (int e = 0; e < kWBK * kWT / 4 / 256; ++e) {  // kWBK depths x 32 chunks of 4 columns
      const int ch = tid + e * 256, q = ch / (kWT / 4), cc = ch % (kWT / 4) * 4;
      const bool in = k0 + q < k_hi && col0 + cc < cols;
      cp_async16(sw + q * kWT + cc, in ? W + (size_t)(k0 + q) * ldw + col0 + cc : W, in);
    }
  };
  wide_ring(k_lo, k_hi, load, [&](int slot) {
    const float* so = reinterpret_cast<const float*>(smem + slot * SB);
    const float* sw = reinterpret_cast<const float*>(smem + slot * SB + kWOpBytes);
#pragma unroll
    for (int kq = 0; kq < kWBK; kq += 4) {
      float4 w[4][2];  // [depth kq + d][half h]: columns 4 tx + 64 h ... + 3
#pragma unroll
      for (int d = 0; d < 4; ++d)
#pragma unroll
        for (int h = 0; h < 2; ++h) w[d][h] = staged4(sw + (kq + d) * kWT + 64 * h, 4 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 o = staged4(so + (ty + 16 * i) * kWRow, kq);
        const float od[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int d = 0; d < 4; ++d)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[i][4 * h] = fmaf(od[d], w[d][h].x, acc[i][4 * h]);
            acc[i][4 * h + 1] = fmaf(od[d], w[d][h].y, acc[i][4 * h + 1]);
            acc[i][4 * h + 2] = fmaf(od[d], w[d][h].z, acc[i][4 * h + 2]);
            acc[i][4 * h + 3] = fmaf(od[d], w[d][h].w, acc[i][4 * h + 3]);
          }
      }
    }
  });
}

// Split-K of the wide tile: each slice writes its partial tile (16-byte
// stores, each warp 512 contiguous bytes: the layout is the threads', the
// same in every block); the last block to arrive at the tile's counter
// sums the partials in slice order into acc and resets the counter.
// Returns whether this block now holds the tile's full sum (always, for
// one slice). `last` is a shared int. Block-uniform.
__device__ __forceinline__ bool wide_reduce(float (&acc)[8][8], float* part, int* cnt, int tile, int slice,
                                            int slices, int& last) {
  if (slices == 1) return true;
  const int tid = threadIdx.x;
  constexpr int Q = kWT * kWT / 4;  // float4 of one partial tile
  float4* p = reinterpret_cast<float4*>(part) + (size_t)tile * slices * Q + tid;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      __stcg(p + (size_t)slice * Q + (i * 2 + h) * 256,
             make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]));
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(cnt + tile, 1);
    last = done == slices - 1;
    if (last) cnt[tile] = 0;  // next used after a grid barrier or launch
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  for (int z = 0; z < slices; ++z) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = __ldcg(p + (size_t)z * Q + (i * 2 + h) * 256);
        if (z == 0) {
          acc[i][4 * h] = v.x, acc[i][4 * h + 1] = v.y, acc[i][4 * h + 2] = v.z, acc[i][4 * h + 3] = v.w;
        } else {
          acc[i][4 * h] += v.x, acc[i][4 * h + 1] += v.y, acc[i][4 * h + 2] += v.z, acc[i][4 * h + 3] += v.w;
        }
      }
  }
  return true;
}

}  // namespace
