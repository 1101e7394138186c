// One optimizer step of the fused Adam sweeps as two launches: the
// prologue (the gradients' global norm, the step's scalars, the new count
// and the SR seeds) and one sweep over a table of leaves. Shared by
// qadam_int8.cu and qadam_dense.cu, which each add their sweep and C
// entries; the wrapper is dladmm_tpu_torch/train/qadam_cuda.py (adam_step,
// step_plan).
//
// The leaf table. At most kMaxLeaves leaves travel by value as a kernel
// parameter (__grid_constant__, read in place), so a step copies nothing
// to the device. A leaf carries its codec, its pointers, its element
// count, its (rows, L) view and the first work block of the sweep and of
// the norm in a prefix over the leaves: work block w belongs to the last
// leaf whose first block is <= w. The rules of that layout live here once
// (lay_out): the one-leaf entries fill a table by them, and a step's
// entry refuses a host table that differs, before it enqueues anything.
//
// bf16 gradients (bf16 training). A step's gradients are all fp32 or all
// bf16 (Table::g16); bf16 ones are widened exactly where they are read.
// A leaf may also carry a bf16 compute copy (Leaf::copy): the sweep then
// writes round_rn(new master) into it, in place, in the same pass
// (emit_copy in qadam_pallas.py).
//
// The prologue computes what qadam_cuda.step_scalars and step_seeds
// compute:
//
//   norm       = sqrt(sum over every leaf of g^2), summed in fp64 and
//                rounded once to fp32 (the plain version's fp32 sums in
//                PyTorch's order land within rounding of it); on bf16
//                gradients the norm of the JAX package's jitted step
//                (optax.global_norm(grads).astype(f32) in _scalars): each
//                leaf's sum of squares (fp64 here, fp32 there) rounded to
//                bf16, the leaves' sums added in bf16 in leaf order, the
//                square root of that bf16 total in fp32
//   clip_scale = min(1, clip / max(norm, 1e-16)), 1 without a clip; the
//                division as PyTorch's Python-number / tensor computes it,
//                reciprocal(max(...)) * clip
//   count'     = count + 1;  c1 = 1 - b1^count',  c2 = 1 - b2^count'
//   lr         = a constant, the warmup-cosine schedule of the old count
//                (train/qadam_cuda.WarmupCosine, its fp32 operation order),
//                or a device scalar read by pointer
//   seeds[i]   = _mix_seed(count', i)   (the SR formats' leaf seeds)
//
// into scal = [c1, c2, lr, clip_scale], count_out and seeds, buffers the
// wrapper takes with torch.empty: the old count is never written. The
// norm: each block sums squares over its chunks of the table in a fixed
// order into an fp64 partial; the last block to arrive at the counter
// sums the partials in block order and resets the counter (the split-K
// rule of persistent.cuh, no float atomics), so a step repeats bit for
// bit. Without a clip the prologue is one block and reads no gradient.
//
// The host arrays of a step (train/qadam_cuda.py packs them):
//   ptrs: count, count_out, scal, seeds, lr_ptr, partials, counter, then
//         per leaf g, master, mu, nu, mu_scale, nu_scale, seed, copy
//   ints: nleaves, blocks, chunks, norm_blocks, lr_mode, warmup, decay,
//         has_clip, fmt, g16, then per leaf codec, n, rows, L, warps, vec,
//         block0, chunk0 (the sweep launches one block a work block)
//   flts: lr, init - peak, peak, pi, 1 - alpha, alpha, clip, b1, 1 - b1,
//         b2, 1 - b2, eps, 1/127
// (1 - b1, 1 - b2, init - peak, ... are rounded once from double, as the
// plain version's Python scalars are.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kStepThreads = 256;
constexpr int kMaxLeaves = 8;
constexpr int kChunk = kStepThreads * 8;  // elements of a norm chunk and of a dense work block
constexpr int kMaxNormBlocks = 512;       // blocks of the prologue at most (kMaxLeaves partials each)
constexpr int kPtrHead = 7, kPtrLeaf = 8, kIntHead = 10, kIntLeaf = 8;

enum Codec { CODEC_ROWS = 0, CODEC_FLAT = 1, CODEC_DENSE = 2 };
enum LrMode { LR_CONST = 0, LR_COSINE = 1, LR_PTR = 2 };

struct Leaf {
  const void* g;      // fp32, or bf16 where the table's g16 is set
  float* master;
  void* mu;           // int8 codes or the dense moment
  void* nu;
  float* mu_s;        // int8 scales, one a row (null for dense)
  float* nu_s;
  const int* seed;    // the leaf's SR seed (dense SR formats), else null
  __nv_bfloat16* copy;  // the bf16 compute copy written from the new master, or null
  long long n;        // elements of g and master
  int codec;          // Codec
  int rows;           // int8: rows of the codes, (R, L) or (nblocks, 256)
  int L;              // int8: codes a row
  int warps;          // int8: warps a row
  int vec;            // elements a vector access
  int block0;         // first work block of the sweep
  int chunk0;         // first chunk of the norm
};

struct Table {
  Leaf leaf[kMaxLeaves];
  int nleaves;
  int g16;     // every leaf's g is bf16 (else fp32)
  int blocks;  // work blocks of the sweep
  int chunks;  // chunks of the norm
};

struct StepScalars {
  const int* count;
  int* count_out;
  float* scal;
  int* seeds;
  const float* lr_ptr;
  double* partials;
  int* counter;
  int lr_mode, warmup, decay, has_clip;
  float lr, init_m_peak, peak, pi, one_m_alpha, alpha, clip, b1, b2;
};

struct Coeffs {  // the sweep's constants
  float b1, omb1, b2, omb2, eps, inv127;
};

// -- the table's layout rules (train/qadam_cuda.step_plan packs the same) ----

constexpr int kBlockWarps = kStepThreads / 32;  // warps a block of the sweeps
constexpr int kDenseVec = 8;                     // elements a thread a dense work block

inline bool aligned(const void* p, int bytes) { return ((uintptr_t)p % bytes) == 0; }

// Warps of the int8 sweep a row of L codes takes: the power of two W with
// 256 W >= L, so no thread holds more than 8 of the row's elements.
inline int int8_warps(int L) {
  int w = 1;
  while (kStepThreads * w < L) w *= 2;
  return w;
}

// Elements a vector access of a leaf takes. int8: 4, then 2, where L is a
// multiple and every pointer is aligned to it (4 V bytes for fp32, 2 V
// for bf16 (g16, copy), V for codes), else 1. Dense: 8 (16-byte accesses
// of fp32 and bf16) where every pointer is 16-byte aligned, else 1.
inline int leaf_vec(const Leaf& lf, bool g16) {
  const bool copy16 = lf.copy == nullptr || aligned(lf.copy, 16);
  if (lf.codec == CODEC_DENSE)
    return aligned(lf.g, 16) && aligned(lf.master, 16) && aligned(lf.mu, 16) && aligned(lf.nu, 16) && copy16
               ? kDenseVec : 1;
  for (int v = 4; v > 1; v /= 2)
    if (lf.L % v == 0 && aligned(lf.g, (g16 ? 2 : 4) * v) && aligned(lf.master, 4 * v) && aligned(lf.mu, v) &&
        aligned(lf.nu, v) && (lf.copy == nullptr || aligned(lf.copy, 2 * v)))
      return v;
  return 1;
}

// Each leaf's warps, vector width, first work block and first norm chunk,
// and the table's totals, by the rules above: an int8 work block holds
// kBlockWarps / warps rows, a dense work block and a norm chunk kChunk
// elements, and each leaf's blocks and chunks follow the previous leaf's.
// With `fill` they are written (the one-leaf entries); otherwise the
// host's table must hold them already. False on a table that differs or
// that the sweeps do not take.
inline bool lay_out(Table& t, bool fill) {
  long long block0 = 0, chunk0 = 0;
  for (int i = 0; i < t.nleaves; ++i) {
    Leaf& lf = t.leaf[i];
    const bool dense = lf.codec == CODEC_DENSE;
    const int warps = dense ? 0 : int8_warps(lf.L);
    if (warps > kBlockWarps || lf.n < 1 || (!dense && lf.rows < 1)) return false;
    const long long chunks = (lf.n + kChunk - 1) / kChunk;
    const int per = dense ? 0 : kBlockWarps / warps;
    const long long blocks = dense ? chunks : (lf.rows + per - 1) / per;
    const int vec = leaf_vec(lf, t.g16 != 0);
    if (fill) {
      lf.warps = warps;
      lf.vec = vec;
      lf.block0 = (int)block0;
      lf.chunk0 = (int)chunk0;
    } else if (lf.warps != warps || lf.vec != vec || lf.block0 != block0 || lf.chunk0 != chunk0) {
      return false;
    }
    block0 += blocks;
    chunk0 += chunks;
    if (block0 > INT32_MAX || chunk0 > INT32_MAX) return false;
  }
  if (fill) {
    t.blocks = (int)block0;
    t.chunks = (int)chunk0;
  }
  return t.blocks == block0 && t.chunks == chunk0;
}

// Blocks of the prologue's launch with a clip: one a chunk, at most
// kMaxNormBlocks.
inline int norm_blocks(const Table& t) { return t.chunks < kMaxNormBlocks ? t.chunks : kMaxNormBlocks; }

// The leaf of work block w: the last whose first block is <= w.
__device__ __forceinline__ int leaf_of_block(const Table& t, int w) {
  int i = 0;
#pragma unroll
  for (int k = 1; k < kMaxLeaves; ++k)
    if (k < t.nleaves && w >= t.leaf[k].block0) i = k;
  return i;
}

__device__ __forceinline__ int leaf_of_chunk(const Table& t, int c) {
  int i = 0;
#pragma unroll
  for (int k = 1; k < kMaxLeaves; ++k)
    if (k < t.nleaves && c >= t.leaf[k].chunk0) i = k;
  return i;
}

// fmix32 of the JAX package's _mix_seed (train/qmoments.fmix32).
__device__ __forceinline__ uint32_t fmix32(uint32_t s) {
  s ^= s >> 16;
  s *= 0x7FEB352Du;
  s ^= s >> 15;
  s *= 0x846CA68Bu;
  return s ^ (s >> 16);
}

// Sum of v over the block, in a fixed order; thread 0 gets the result.
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by a previous call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kStepThreads / 32; ++w) s += red[w];
  return s;
}

// The learning rate of the old count c under warmup-cosine, in the fp32
// operation order of WarmupCosine.__call__ (true divisions).
__device__ __forceinline__ float cosine_lr(int c, const StepScalars& s) {
  if (c < s.warmup) {
    const int cl = c < 0 ? 0 : c;
    const float frac = __fsub_rn(1.0f, __fdiv_rn((float)cl, (float)s.warmup));
    return __fadd_rn(__fmul_rn(s.init_m_peak, frac), s.peak);
  }
  const float t = fminf((float)(c - s.warmup), (float)s.decay);
  const float cosine = __fmul_rn(0.5f, __fadd_rn(1.0f, cosf(__fdiv_rn(__fmul_rn(s.pi, t), (float)s.decay))));
  return __fmul_rn(s.peak, __fadd_rn(__fmul_rn(s.one_m_alpha, cosine), s.alpha));
}

// Eight elements of a leaf's gradient from index i0 (0 past its end), as
// floats: 16-byte loads where they are aligned and whole.
__device__ __forceinline__ void grad8(const Leaf& lf, bool g16, long long i0, float* v) {
  if (g16) {
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(lf.g);
    if (i0 + 8 <= lf.n && ((uintptr_t)(g + i0) & 15) == 0) {
      const uint4 a = __ldcg(reinterpret_cast<const uint4*>(g + i0));
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(h[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = i0 + k < lf.n ? __bfloat162float(g[i0 + k]) : 0.0f;
    }
    return;
  }
  const float* g = static_cast<const float*>(lf.g);
  if (i0 + 8 <= lf.n && ((uintptr_t)g & 15) == 0) {
    const float4 a = __ldcg(reinterpret_cast<const float4*>(g + i0));
    const float4 b = __ldcg(reinterpret_cast<const float4*>(g + i0 + 4));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = i0 + k < lf.n ? g[i0 + k] : 0.0f;
  }
}

// v as a bf16 value holds it.
__device__ __forceinline__ float bf16_rounded(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// Whether this block is the last of the grid to arrive at the counter
// (which it then clears for the next step), after its partials are out.
__device__ __forceinline__ bool last_block(const StepScalars& s, int* last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    *last = atomicAdd(s.counter, 1) == (int)gridDim.x - 1;
    if (*last) *s.counter = 0;  // the next step finds it cleared
  }
  __syncthreads();
  if (*last) __threadfence();
  return *last;
}

// The global norm of fp32 gradients: one fp64 sum over every leaf
// (thread 0 of the last block gets it).
__device__ double sum_of_squares(const Table& t, const StepScalars& s, double* red, int* last, bool* done) {
  double acc = 0.0;
  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    const Leaf& lf = t.leaf[leaf_of_chunk(t, c)];
    float v[8];
    grad8(lf, false, (long long)(c - lf.chunk0) * kChunk + threadIdx.x * 8, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fma((double)v[k], (double)v[k], acc);
  }
  double sumsq = block_sum(acc, red);
  *done = true;
  if (gridDim.x > 1) {
    if (threadIdx.x == 0) __stcg(s.partials + blockIdx.x, sumsq);
    if (!last_block(s, last)) {
      *done = false;
      return 0.0;
    }
    double p = 0.0;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += kStepThreads) p += __ldcg(s.partials + b);
    sumsq = block_sum(p, red);
  }
  return sqrt(sumsq);
}

// The global norm of bf16 gradients as the JAX package's jitted step
// computes it: each leaf's sum of squares (fp64 here) rounded to bf16,
// those added in bf16 in leaf order, the fp32 square root of that bf16
// total (XLA keeps it in fp32 there: the norm is cast to fp32 at once,
// and excess precision is allowed). A block's chunks run in leaf order,
// so it sums leaf by leaf (block-uniform changes of leaf); its partials
// are one a leaf, and the last block sums each leaf's in block order.
// Thread 0 of the last block gets the norm.
__device__ double bf16_norm(const Table& t, const StepScalars& s, double* red, int* last, bool* done) {
  __shared__ double leaf_sum[kMaxLeaves];
  if (threadIdx.x < kMaxLeaves) leaf_sum[threadIdx.x] = 0.0;
  double acc = 0.0;
  int cur = -1;
  for (int c = blockIdx.x; c < t.chunks; c += gridDim.x) {
    const int li = leaf_of_chunk(t, c);
    if (li != cur) {
      if (cur >= 0) {
        const double bs = block_sum(acc, red);
        if (threadIdx.x == 0) leaf_sum[cur] += bs;
      }
      acc = 0.0;
      cur = li;
    }
    const Leaf& lf = t.leaf[li];
    float v[8];
    grad8(lf, true, (long long)(c - lf.chunk0) * kChunk + threadIdx.x * 8, v);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc = fma((double)v[k], (double)v[k], acc);
  }
  if (cur >= 0) {
    const double bs = block_sum(acc, red);
    if (threadIdx.x == 0) leaf_sum[cur] += bs;
  }
  __syncthreads();
  *done = true;
  if (gridDim.x > 1) {
    if (threadIdx.x < kMaxLeaves) __stcg(s.partials + (size_t)blockIdx.x * kMaxLeaves + threadIdx.x, leaf_sum[threadIdx.x]);
    if (!last_block(s, last)) {
      *done = false;
      return 0.0;
    }
    for (int l = 0; l < t.nleaves; ++l) {
      double p = 0.0;
      for (int b = threadIdx.x; b < (int)gridDim.x; b += kStepThreads)
        p += __ldcg(s.partials + (size_t)b * kMaxLeaves + l);
      const double total = block_sum(p, red);
      if (threadIdx.x == 0) leaf_sum[l] = total;
    }
  }
  float norm2 = 0.0f;
  if (threadIdx.x == 0)
    for (int l = 0; l < t.nleaves; ++l) {
      const float leaf = bf16_rounded(__double2float_rn(leaf_sum[l]));
      norm2 = l ? bf16_rounded(__fadd_rn(norm2, leaf)) : leaf;
    }
  return (double)__fsqrt_rn(norm2);
}

__global__ void __launch_bounds__(kStepThreads)
adam_prologue(const __grid_constant__ Table t, const __grid_constant__ StepScalars s) {
  __shared__ double red[kStepThreads / 32];
  __shared__ int last;
  double norm = 0.0;
  if (s.has_clip) {
    bool done;
    norm = t.g16 ? bf16_norm(t, s, red, &last, &done) : sum_of_squares(t, s, red, &last, &done);
    if (!done) return;
  }
  const int count = *s.count + 1;
  if (threadIdx.x == 0) {
    const float cf = (float)count;
    float scale = 1.0f;
    if (s.has_clip) {
      const float nrm = __double2float_rn(norm);
      const float tiny = 1e-16f;
      const float q = __fmul_rn(__frcp_rn(nrm < tiny ? tiny : nrm), s.clip);  // NaN stays NaN
      scale = q > 1.0f ? 1.0f : q;
    }
    const float lr = s.lr_mode == LR_CONST ? s.lr
                     : s.lr_mode == LR_COSINE ? cosine_lr(count - 1, s)
                                              : *s.lr_ptr;
    s.scal[0] = __fsub_rn(1.0f, powf(s.b1, cf));
    s.scal[1] = __fsub_rn(1.0f, powf(s.b2, cf));
    s.scal[2] = lr;
    s.scal[3] = scale;
    *s.count_out = count;
  }
  if (s.seeds != nullptr && threadIdx.x < t.nleaves)
    s.seeds[threadIdx.x] = (int)fmix32((uint32_t)count + (uint32_t)(threadIdx.x + 1) * 0x9E3779B9u);
}

// Fill the table and the prologue's scalars from a step's host arrays.
// Returns false on a table the kernels do not take.
inline bool read_step(const long long* ptrs, const long long* ints, const double* flts, Table& t,
                      StepScalars& s, Coeffs& k) {
  const int nl = (int)ints[0];
  if (nl < 1 || nl > kMaxLeaves) return false;
  t = Table{};
  t.nleaves = nl;
  t.blocks = (int)ints[1];
  t.chunks = (int)ints[2];
  t.g16 = (int)ints[9];
  for (int i = 0; i < nl; ++i) {
    const long long* p = ptrs + kPtrHead + i * kPtrLeaf;
    const long long* d = ints + kIntHead + i * kIntLeaf;
    Leaf& lf = t.leaf[i];
    lf.g = reinterpret_cast<const void*>(p[0]);
    lf.master = reinterpret_cast<float*>(p[1]);
    lf.mu = reinterpret_cast<void*>(p[2]);
    lf.nu = reinterpret_cast<void*>(p[3]);
    lf.mu_s = reinterpret_cast<float*>(p[4]);
    lf.nu_s = reinterpret_cast<float*>(p[5]);
    lf.seed = reinterpret_cast<const int*>(p[6]);
    lf.copy = reinterpret_cast<__nv_bfloat16*>(p[7]);
    lf.codec = (int)d[0];
    lf.n = d[1];
    lf.rows = (int)d[2];
    lf.L = (int)d[3];
    lf.warps = (int)d[4];
    lf.vec = (int)d[5];
    lf.block0 = (int)d[6];
    lf.chunk0 = (int)d[7];
  }
  s.count = reinterpret_cast<const int*>(ptrs[0]);
  s.count_out = reinterpret_cast<int*>(ptrs[1]);
  s.scal = reinterpret_cast<float*>(ptrs[2]);
  s.seeds = reinterpret_cast<int*>(ptrs[3]);
  s.lr_ptr = reinterpret_cast<const float*>(ptrs[4]);
  s.partials = reinterpret_cast<double*>(ptrs[5]);
  s.counter = reinterpret_cast<int*>(ptrs[6]);
  s.lr_mode = (int)ints[4];
  s.warmup = (int)ints[5];
  s.decay = (int)ints[6];
  s.has_clip = (int)ints[7];
  s.lr = (float)flts[0];
  s.init_m_peak = (float)flts[1];
  s.peak = (float)flts[2];
  s.pi = (float)flts[3];
  s.one_m_alpha = (float)flts[4];
  s.alpha = (float)flts[5];
  s.clip = (float)flts[6];
  s.b1 = (float)flts[7];
  s.b2 = (float)flts[9];
  k = Coeffs{(float)flts[7], (float)flts[8], (float)flts[9], (float)flts[10], (float)flts[11], (float)flts[12]};
  if (s.lr_mode == LR_PTR && s.lr_ptr == nullptr) return false;
  if (s.lr_mode == LR_COSINE && (s.warmup < 1 || s.decay < 1)) return false;
  // The host's layout must be the one the rules above give, so that a
  // step the sweep would refuse is refused here, before the prologue runs.
  return lay_out(t, false) && t.blocks >= 1 && (int)ints[3] == norm_blocks(t);
}

// Launch the prologue: norm_blocks(t) blocks, one without a clip. A
// refused launch runs nothing; its error is cleared and returned.
inline cudaError_t launch_prologue(const Table& t, const StepScalars& s, cudaStream_t stream) {
  adam_prologue<<<s.has_clip ? norm_blocks(t) : 1, kStepThreads, 0, stream>>>(t, s);
  return cudaGetLastError();
}

}  // namespace
