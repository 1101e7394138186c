// One-pass Adam sweep with sqrt-companded int8 moments over a table of
// leaves, for Hopper (sm_90a).
//
// Replaces the TPU kernel dladmm_tpu/train/qadam_pallas.py:_make_kernel_int8
// (driven by _leaf_apply_pallas) and, in the same launch, the flat-256
// leaves the JAX package sweeps with jnp (_leaf_apply_jnp). For each row
// of each leaf, in one pass and in place:
//
//   mu, nu  = sign(c) * c * c * scale_r                          decode
//             c = code * (1/127) (per-row codec), code / 127 (flat codec)
//   g'      = g * clip_scale
//   mu'     = b1 * mu + (1 - b1) * g'
//   nu'     = b2 * nu + (1 - b2) * g' * g'
//   master -= lr * (mu' / c1) / (sqrt(nu' / c2) + eps)
//   scale_r = absmax of the row (1.0 for an all-zero row), per moment
//   code    = round_half_even(127 * sign(y) * sqrt(|y|)), y = mu' / scale_r
//   copy    = round_rn(master)        (bf16 training: the compute copy)
//
// g is fp32 or bf16 (bf16 training's gradients, widened exactly), and a
// leaf may carry its bf16 compute copy, written in the same pass
// (emit_copy of the JAX kernel): 16 bytes an element either way.
//
// Two codecs share the launch (train/qadam_cuda.leaf_eligible picks a
// leaf's): per-row, codes (R, L) and scales (R,) on the (R, L) view of W1
// and W2; flat-256 (train/qmoments.py), codes (nblocks, 256) and scales
// (nblocks,) on the flattened θ and β stacks. Each 256-block is a row of
// L = 256 whose tail past the leaf's end is padding: read as 0, written
// as code 0, as quantize_q8 pads. c1, c2, lr and clip_scale arrive as four
// floats on the device (adam_step.cuh's prologue writes them).
//
// Design. It moves 16 bytes an element (g, master read and written, two
// codes read and written) and 16 a row, but it also rounds 5 divisions
// and 3 square roots an element to nearest, each a sequence of some 10-20
// instructions: at synthetic_small the sweep issues about as long as it
// moves bytes, so it needs both busy at once. A row belongs to a
// group of W warps, W the power of two with 256 W >= L (one warp up to
// L = 256, four at L = 1000), so no thread holds more than 8 of the row's
// elements in registers between the update and the encode; a block of 8
// warps holds 8 / W rows. The row's absmax is a warp-shuffle max and,
// across the W warps of a group, a named barrier of that group alone:
// no row waits on the whole block. A thread owns 8 / V vectors of V
// elements (V = 4, 2 or 1 by the leaf's alignment: 16-byte fp32 and
// 4-byte code accesses at L = 256 and 1000, 8 and 2 bytes at L = 250),
// all loaded before the first is used, so each thread keeps 80 bytes in
// flight. The arithmetic uses the round-to-nearest intrinsics (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn) in the plain version's order: nvcc
// may not contract them into FMAs, so for given scalars the sweep computes
// what the plain PyTorch versions compute, operation for operation.
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/train/qadam_cuda.py).

#include <cuda_bf16.h>

#include "adam_step.cuh"

namespace {

constexpr int kPerThread = 8;  // elements a thread: rows up to 2048 wide

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float decode(int8_t code, float scale, bool flat, float inv127) {
  const float c = flat ? __fdiv_rn((float)code, 127.0f) : __fmul_rn((float)code, inv127);
  return __fmul_rn(__fmul_rn(__fmul_rn(sign_of(c), c), c), scale);
}

__device__ __forceinline__ int8_t encode(float x, float scale) {
  const float y = __fdiv_rn(x, scale);
  const float c = __fmul_rn(sign_of(y), __fsqrt_rn(fabsf(y)));
  return (int8_t)__float2int_rn(__fmul_rn(c, 127.0f));
}

template <int V>
__device__ __forceinline__ void load_f(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_f(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// V bf16 values from p, widened.
template <int V>
__device__ __forceinline__ void load_h(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
    v[0] = __bfloat162float(h[0]); v[1] = __bfloat162float(h[1]);
    v[2] = __bfloat162float(h[2]); v[3] = __bfloat162float(h[3]);
  } else if constexpr (V == 2) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
    v[0] = __low2float(a); v[1] = __high2float(a);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// V floats rounded to bf16 into p.
template <int V>
__device__ __forceinline__ void store_h(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 4) {
    uint2 a;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&a);
#pragma unroll
    for (int e = 0; e < 4; ++e) h[e] = __float2bfloat16_rn(v[e]);
    *reinterpret_cast<uint2*>(p) = a;
  } else if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

template <int V>
__device__ __forceinline__ void load_c(const int8_t* p, int8_t* v) {
  if constexpr (V == 4) {
    const char4 a = *reinterpret_cast<const char4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (V == 2) {
    const char2 a = *reinterpret_cast<const char2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_c(int8_t* p, const int8_t* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<char4*>(p) = make_char4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<char2*>(p) = make_char2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// Barrier of the `threads` threads of one row group (ids 1..8; 0 is
// __syncthreads').
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Row `row` of a leaf, updated by its group of W warps: t is the thread's
// index in the group, grp the group's index in the block; red holds the
// block's per-warp maxima.
template <int W, int V>
__device__ __forceinline__ void row_update(const Leaf& lf, bool g16, int row, int t, int grp, float (*red)[2],
                                           const float* __restrict__ scal, const Coeffs& k) {
  constexpr int G = 32 * W, C = kPerThread / V;
  const bool flat = lf.codec == CODEC_FLAT;
  const long long base = (long long)row * lf.L;
  const long long left = lf.n - base;
  const int valid = left < lf.L ? (int)left : lf.L;  // elements with g and master
  const float c1 = scal[0], c2 = scal[1], lr = scal[2], cs = scal[3];
  const float smu = lf.mu_s[row], snu = lf.nu_s[row];
  const float* g = g16 ? nullptr : static_cast<const float*>(lf.g) + base;
  const __nv_bfloat16* gh = g16 ? static_cast<const __nv_bfloat16*>(lf.g) + base : nullptr;
  float* master = lf.master + base;
  __nv_bfloat16* copy = lf.copy == nullptr ? nullptr : lf.copy + base;
  int8_t* muc = static_cast<int8_t*>(lf.mu) + base;
  int8_t* nuc = static_cast<int8_t*>(lf.nu) + base;

  float gv[kPerThread], mv[kPerThread];
  int8_t cm[kPerThread], cn[kPerThread];
#pragma unroll
  for (int c = 0; c < C; ++c) {  // every load is issued before the first use
    const int j0 = (c * G + t) * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      gv[c * V + v] = mv[c * V + v] = 0.0f;
      cm[c * V + v] = cn[c * V + v] = 0;
    }
    if (j0 >= lf.L) continue;
    load_c<V>(muc + j0, cm + c * V);
    load_c<V>(nuc + j0, cn + c * V);
    if (j0 + V <= valid) {
      if (g16) {
        load_h<V>(gh + j0, gv + c * V);
      } else {
        load_f<V>(g + j0, gv + c * V);
      }
      load_f<V>(master + j0, mv + c * V);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (j0 + v < valid) {
          gv[c * V + v] = g16 ? __bfloat162float(gh[j0 + v]) : g[j0 + v];
          mv[c * V + v] = master[j0 + v];
        }
    }
  }

  float m[kPerThread], s[kPerThread];
  float amax_mu = 0.0f, amax_nu = 0.0f;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int j = ((e / V) * G + t) * V + e % V;
    m[e] = s[e] = 0.0f;  // padding of a flat leaf's last block stays 0
    if (j >= valid) continue;
    const float gs = __fmul_rn(gv[e], cs);
    const float mm = __fadd_rn(__fmul_rn(k.b1, decode(cm[e], smu, flat, k.inv127)), __fmul_rn(k.omb1, gs));
    const float vv = __fadd_rn(__fmul_rn(k.b2, decode(cn[e], snu, flat, k.inv127)),
                               __fmul_rn(__fmul_rn(k.omb2, gs), gs));
    const float upd = __fdiv_rn(__fdiv_rn(mm, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vv, c2)), k.eps));
    mv[e] = __fsub_rn(mv[e], __fmul_rn(lr, upd));
    m[e] = mm;
    s[e] = vv;
    amax_mu = fmaxf(amax_mu, fabsf(mm));
    amax_nu = fmaxf(amax_nu, fabsf(vv));
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j0 = (c * G + t) * V;
    if (j0 + V <= valid) {
      store_f<V>(master + j0, mv + c * V);
      if (copy != nullptr) store_h<V>(copy + j0, mv + c * V);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (j0 + v < valid) {
          master[j0 + v] = mv[c * V + v];
          if (copy != nullptr) copy[j0 + v] = __float2bfloat16_rn(mv[c * V + v]);
        }
    }
  }

  // The row's absmax: within the warp, then across the group's warps.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    amax_mu = fmaxf(amax_mu, __shfl_xor_sync(0xffffffffu, amax_mu, o));
    amax_nu = fmaxf(amax_nu, __shfl_xor_sync(0xffffffffu, amax_nu, o));
  }
  if constexpr (W > 1) {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
      red[warp][0] = amax_mu;
      red[warp][1] = amax_nu;
    }
    group_sync(1 + grp, G);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      amax_mu = fmaxf(amax_mu, red[grp * W + w][0]);
      amax_nu = fmaxf(amax_nu, red[grp * W + w][1]);
    }
  }
  // Every thread of the group read the row's old scales before this point.
  const float new_smu = amax_mu > 0.0f ? amax_mu : 1.0f;
  const float new_snu = amax_nu > 0.0f ? amax_nu : 1.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j0 = (c * G + t) * V;
    if (j0 >= lf.L) continue;
    int8_t qm[V], qn[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      qm[v] = encode(m[c * V + v], new_smu);
      qn[v] = encode(s[c * V + v], new_snu);
    }
    store_c<V>(muc + j0, qm);
    store_c<V>(nuc + j0, qn);
  }
  if (t == 0) {
    lf.mu_s[row] = new_smu;
    lf.nu_s[row] = new_snu;
  }
}

__global__ void __launch_bounds__(kStepThreads)
qadam_int8_sweep(const __grid_constant__ Table t, const float* __restrict__ scal, const Coeffs k) {
  __shared__ float red[kBlockWarps][2];
  const int warp = threadIdx.x / 32;
  const bool g16 = t.g16 != 0;
  for (int w = blockIdx.x; w < t.blocks; w += gridDim.x) {
    const Leaf& lf = t.leaf[leaf_of_block(t, w)];
    const int W = lf.warps, grp = warp / W;
    const int row = (w - lf.block0) * (kBlockWarps / W) + grp;
    const int tg = threadIdx.x - grp * 32 * W;
    if (row < lf.rows) {
      switch (W * 8 + lf.vec) {
        case 1 * 8 + 4: row_update<1, 4>(lf, g16, row, tg, grp, red, scal, k); break;
        case 1 * 8 + 2: row_update<1, 2>(lf, g16, row, tg, grp, red, scal, k); break;
        case 1 * 8 + 1: row_update<1, 1>(lf, g16, row, tg, grp, red, scal, k); break;
        case 2 * 8 + 4: row_update<2, 4>(lf, g16, row, tg, grp, red, scal, k); break;
        case 2 * 8 + 2: row_update<2, 2>(lf, g16, row, tg, grp, red, scal, k); break;
        case 2 * 8 + 1: row_update<2, 1>(lf, g16, row, tg, grp, red, scal, k); break;
        case 4 * 8 + 4: row_update<4, 4>(lf, g16, row, tg, grp, red, scal, k); break;
        case 4 * 8 + 2: row_update<4, 2>(lf, g16, row, tg, grp, red, scal, k); break;
        case 4 * 8 + 1: row_update<4, 1>(lf, g16, row, tg, grp, red, scal, k); break;
        case 8 * 8 + 4: row_update<8, 4>(lf, g16, row, tg, grp, red, scal, k); break;
        case 8 * 8 + 2: row_update<8, 2>(lf, g16, row, tg, grp, red, scal, k); break;
        case 8 * 8 + 1: row_update<8, 1>(lf, g16, row, tg, grp, red, scal, k); break;
        default: break;
      }
    }
    if (w + (int)gridDim.x < t.blocks) __syncthreads();  // red is reused by the next rows
  }
}

bool leaf_ok(const Leaf& lf) {
  const bool codec = lf.codec == CODEC_ROWS || lf.codec == CODEC_FLAT;
  const bool warps = lf.warps == 1 || lf.warps == 2 || lf.warps == 4 || lf.warps == 8;
  const bool vec = lf.vec == 1 || lf.vec == 2 || lf.vec == 4;
  return codec && warps && vec && lf.rows >= 1 && lf.L >= 1 && lf.L <= kStepThreads * lf.warps &&
         (long long)lf.rows * lf.L >= lf.n && lf.mu_s != nullptr && lf.nu_s != nullptr;
}

}  // namespace

// One optimizer step over a table of int8 leaves (adam_step.cuh gives the
// layout of the host arrays; ints[9] 1 for bf16 gradients; a leaf's copy
// pointer, where not null, receives its bf16 compute copy), enqueued on
// `stream`: the prologue, then
// the sweep; no sync. A table the sweep does not take is refused before
// either is enqueued. Returns a cudaError_t; a refused launch's error is
// cleared for later launches' checks.
extern "C" int dladmm_adam_step_int8(const long long* ptrs, const long long* ints, const double* flts,
                                     int device, void* stream_handle) {
  Table t;
  StepScalars s;
  Coeffs k;
  if (!read_step(ptrs, ints, flts, t, s, k)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < t.nleaves; ++i)
    if (!leaf_ok(t.leaf[i])) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  err = launch_prologue(t, s, stream);
  if (err != cudaSuccess) return (int)err;
  qadam_int8_sweep<<<t.blocks, kStepThreads, 0, stream>>>(t, s.scal, k);
  return (int)cudaGetLastError();
}

// One Adam step on one (R, L) leaf with per-row codes, in place, enqueued
// on `stream`; no sync: the sweep with a one-leaf table. g, master fp32
// (R, L); mu_c, nu_c int8 (R, L); mu_s, nu_s fp32 (R,); scal fp32
// [c1, c2, lr, clip_scale] on the device. omb1 and omb2 are (1 - b1) and
// (1 - b2) rounded once from double, as the JAX package forms them.
// Returns a cudaError_t.
extern "C" int dladmm_qadam_int8_rows(
    const float* g, float* master, int8_t* mu_c, float* mu_s, int8_t* nu_c,
    float* nu_s, const float* scal, int R, int L, float b1, float omb1,
    float b2, float omb2, float eps, float inv127, int device,
    void* stream_handle) {
  if (L < 1 || L > kStepThreads * kPerThread || R < 1) return (int)cudaErrorInvalidValue;
  Table t{};
  t.nleaves = 1;
  Leaf& lf = t.leaf[0];
  lf.g = g;
  lf.master = master;
  lf.mu = mu_c;
  lf.nu = nu_c;
  lf.mu_s = mu_s;
  lf.nu_s = nu_s;
  lf.n = (long long)R * L;
  lf.codec = CODEC_ROWS;
  lf.rows = R;
  lf.L = L;
  if (!lay_out(t, true)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  qadam_int8_sweep<<<t.blocks, kStepThreads, 0, static_cast<cudaStream_t>(stream_handle)>>>(
      t, scal, Coeffs{b1, omb1, b2, omb2, eps, inv127});
  return (int)cudaGetLastError();
}

extern "C" const char* dladmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
