// One-pass Adam sweep with dense moments (fp32, bf16, or bf16 stored by
// stochastic rounding) over a table of leaves, for Hopper (sm_90a).
//
// Replaces the TPU kernel dladmm_tpu/train/qadam_pallas.py:_make_kernel_dense
// (driven by _leaf_apply_pallas). For each element i of each leaf, in one
// pass and in place:
//
//   g'      = g * clip_scale
//   mu'     = b1 * mu + (1 - b1) * g'
//   nu'     = b2 * nu + (1 - b2) * g' * g'
//   master -= lr * (mu' / c1) / (sqrt(nu' / c2) + eps)
//   mu, nu  <- mu', nu' in their stored types
//   copy    <- round_rn(master)               (bf16 training: the compute copy)
//
// g is fp32 or bf16 (bf16 training's gradients, widened exactly), and a
// leaf may carry its bf16 compute copy, written in the same pass
// (emit_copy of the JAX kernel); the bytes an element stay 28 with fp32
// moments (2 fewer read of g, 2 more written to the copy).
//
// mu and nu are read and written as fp32 or bf16 (the moment formats of
// _DENSE_FMTS: float32, bfloat16, bfloat16_sr with both moments SR-bf16,
// bfloat16_sr_mu with an SR-bf16 mu and an fp32 nu); every leaf of a step
// has the step's format. A round-to-nearest store is __float2bfloat16_rn;
// a stochastic store adds 16 random bits to the fp32 pattern below the
// bf16 boundary (uint32 wrap-around) and truncates, as qmoments.sr_bfloat16.
// The bits come from Philox4x32-10, written out below: key (the leaf's
// seed, 0), counter (i as two 32-bit words, 0, 0), i the element's index
// in its leaf, word x for mu and word y for nu. So each element of each
// moment has its own bits, a launch repeats bit for bit, and one launch
// over the table stores the bits that one launch a leaf stores. The seed
// is the leaf's _mix_seed(count, idx), an int32 on the device (the
// prologue of adam_step.cuh writes them). c1, c2, lr and clip_scale
// arrive as four floats on the device: the host never reads them.
//
// Design. Each element is read once and written once, so the sweep is
// bound by device-memory bytes: 28 an element with fp32 moments (g,
// master read and written, mu and nu read and written), 20 with bf16
// moments. A work block is 2048 elements of one leaf (the table's prefix
// says which); a thread takes 8 consecutive elements with 16-byte
// accesses (two for fp32, one for 8 bf16) where the leaf's pointers are
// 16-byte aligned, scalar accesses otherwise and at the leaf's tail. The
// arithmetic uses the round-to-nearest intrinsics in the JAX kernel's
// order (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn): nvcc may not
// contract them into FMAs, so the kernel computes what the plain PyTorch
// version computes, operation for operation, up to the SR bits.
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/train/qadam_cuda.py).

#include <cuda_bf16.h>

#include "adam_step.cuh"

namespace {

constexpr int kVec = kDenseVec;  // elements a thread a work block

enum Fmt { FMT_FLOAT32 = 0, FMT_BFLOAT16 = 1, FMT_BFLOAT16_SR = 2, FMT_BFLOAT16_SR_MU = 3 };

// Philox4x32-10 (Salmon et al., SC'11): 10 rounds, the key bumped by the
// Weyl constants between rounds.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += kW0;
    k.y += kW1;
  }
  return c;
}

__device__ __forceinline__ float load(float v) { return v; }
__device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool SR>
__device__ __forceinline__ T store(float x, uint32_t bits);

template <>
__device__ __forceinline__ float store<float, false>(float x, uint32_t) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16, false>(float x, uint32_t) {
  return __float2bfloat16_rn(x);
}

template <>
__device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16, true>(float x, uint32_t bits) {
  __nv_bfloat16_raw raw;
  raw.x = (unsigned short)((__float_as_uint(x) + (bits & 0xFFFFu)) >> 16);
  return __nv_bfloat16(raw);
}

// Eight consecutive elements from p + i0 as floats: 16-byte loads when
// `vec`, else scalar loads of those below n (0 past it).
__device__ __forceinline__ void load8(const float* p, long long i0, long long n, bool vec, float* v) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p + i0);
    const float4 b = *reinterpret_cast<const float4*>(p + i0 + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = i0 + e < n ? p[i0 + e] : 0.0f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, long long i0, long long n, bool vec, float* v) {
  if (vec) {
    const uint4 a = *reinterpret_cast<const uint4*>(p + i0);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&a);
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = __bfloat162float(h[e]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) v[e] = i0 + e < n ? load(p[i0 + e]) : 0.0f;
  }
}

__device__ __forceinline__ void store8(float* p, long long i0, long long n, bool vec, const float* v) {
  if (vec) {
    *reinterpret_cast<float4*>(p + i0) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + i0 + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (i0 + e < n) p[i0 + e] = v[e];
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, long long i0, long long n, bool vec,
                                       const __nv_bfloat16* v) {
  if (vec) {
    uint4 a;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&a);
#pragma unroll
    for (int e = 0; e < kVec; ++e) h[e] = v[e];
    *reinterpret_cast<uint4*>(p + i0) = a;
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (i0 + e < n) p[i0 + e] = v[e];
  }
}

template <typename MuT, typename NuT, bool SR_MU, bool SR_NU>
__global__ void __launch_bounds__(kStepThreads)
qadam_dense_sweep(const __grid_constant__ Table t, const float* __restrict__ scal, const Coeffs k) {
  const float c1 = scal[0], c2 = scal[1], lr = scal[2], cs = scal[3];
  for (int w = blockIdx.x; w < t.blocks; w += gridDim.x) {
    const Leaf& lf = t.leaf[leaf_of_block(t, w)];
    const long long i0 = (long long)(w - lf.block0) * kChunk + threadIdx.x * kVec;
    const long long n = lf.n;
    if (i0 >= n) continue;
    const bool vec = lf.vec == kVec && i0 + kVec <= n;
    MuT* mu = static_cast<MuT*>(lf.mu);
    NuT* nu = static_cast<NuT*>(lf.nu);
    float g[kVec], ms[kVec], m[kVec], v[kVec];
    if (t.g16) {
      load8(static_cast<const __nv_bfloat16*>(lf.g), i0, n, vec, g);
    } else {
      load8(static_cast<const float*>(lf.g), i0, n, vec, g);
    }
    load8(lf.master, i0, n, vec, ms);
    load8(mu, i0, n, vec, m);
    load8(nu, i0, n, vec, v);
    const uint32_t key = (SR_MU || SR_NU) ? (uint32_t)*lf.seed : 0u;
    MuT mo[kVec];
    NuT no[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float gs = __fmul_rn(g[e], cs);
      const float mm = __fadd_rn(__fmul_rn(k.b1, m[e]), __fmul_rn(k.omb1, gs));
      const float vv = __fadd_rn(__fmul_rn(k.b2, v[e]), __fmul_rn(__fmul_rn(k.omb2, gs), gs));
      const float upd = __fdiv_rn(__fdiv_rn(mm, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vv, c2)), k.eps));
      ms[e] = __fsub_rn(ms[e], __fmul_rn(lr, upd));
      uint4 r = make_uint4(0u, 0u, 0u, 0u);
      if (SR_MU || SR_NU) {
        const long long i = i0 + e;
        r = philox4x32_10(make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u), make_uint2(key, 0u));
      }
      mo[e] = store<MuT, SR_MU>(mm, r.x);
      no[e] = store<NuT, SR_NU>(vv, r.y);
    }
    store8(lf.master, i0, n, vec, ms);
    store8(mu, i0, n, vec, mo);
    store8(nu, i0, n, vec, no);
    if (lf.copy != nullptr) {
      __nv_bfloat16 cp[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) cp[e] = __float2bfloat16_rn(ms[e]);
      store8(lf.copy, i0, n, vec, cp);
    }
  }
}

const void* dense_sweep(int fmt) {
  switch (fmt) {
    case FMT_FLOAT32: return (const void*)qadam_dense_sweep<float, float, false, false>;
    case FMT_BFLOAT16: return (const void*)qadam_dense_sweep<__nv_bfloat16, __nv_bfloat16, false, false>;
    case FMT_BFLOAT16_SR: return (const void*)qadam_dense_sweep<__nv_bfloat16, __nv_bfloat16, true, true>;
    case FMT_BFLOAT16_SR_MU: return (const void*)qadam_dense_sweep<__nv_bfloat16, float, true, false>;
    default: return nullptr;
  }
}

bool sr(int fmt) { return fmt == FMT_BFLOAT16_SR || fmt == FMT_BFLOAT16_SR_MU; }

// Launch the sweep of format fmt on `grid` blocks. A refused launch runs
// nothing; its error is cleared and returned.
cudaError_t launch_sweep(int fmt, const Table& t, const float* scal, const Coeffs& k, int grid,
                         cudaStream_t stream) {
  const void* fn = dense_sweep(fmt);
  if (fn == nullptr) return cudaErrorInvalidValue;
  void* args[] = {(void*)&t, (void*)&scal, (void*)&k};
  const cudaError_t err = cudaLaunchKernel(fn, dim3(grid), dim3(kStepThreads), args, 0, stream);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace

// One optimizer step over a table of dense leaves (adam_step.cuh gives
// the layout of the host arrays; ints[8] is the format: 0 float32, 1
// bfloat16, 2 bfloat16_sr, 3 bfloat16_sr_mu; ints[9] 1 for bf16
// gradients; a leaf's copy pointer, where not null, receives its bf16
// compute copy), enqueued on `stream`: the
// prologue, then the sweep; no sync. A table the sweep does not take is
// refused before either is enqueued. Returns a cudaError_t; a refused
// launch's error is cleared for later launches' checks.
extern "C" int dladmm_adam_step_dense(const long long* ptrs, const long long* ints, const double* flts,
                                      int device, void* stream_handle) {
  Table t;
  StepScalars s;
  Coeffs k;
  const int fmt = (int)ints[8];
  if (!read_step(ptrs, ints, flts, t, s, k) || dense_sweep(fmt) == nullptr) return (int)cudaErrorInvalidValue;
  if (sr(fmt) && s.seeds == nullptr) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < t.nleaves; ++i) {
    const Leaf& lf = t.leaf[i];
    if (lf.codec != CODEC_DENSE || (sr(fmt) && lf.seed == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  err = launch_prologue(t, s, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sweep(fmt, t, s.scal, k, t.blocks, stream);
}

// One Adam step on a leaf of N elements, in place, enqueued on `stream`;
// no sync: the sweep with a one-leaf table. g, master fp32 (N,); mu, nu in
// the format's types (fmt as above); scal fp32 [c1, c2, lr, clip_scale]
// and seed (one int32, read only by the SR formats; may be null
// otherwise) on the device. omb1 and omb2 are (1 - b1) and (1 - b2)
// rounded once from double, as the JAX package forms them. Returns a
// cudaError_t.
extern "C" int dladmm_qadam_dense(const float* g, float* master, void* mu, void* nu,
                                  const float* scal, const int* seed, long long N, int fmt,
                                  float b1, float omb1, float b2, float omb2, float eps,
                                  int device, void* stream_handle) {
  if (N < 1 || dense_sweep(fmt) == nullptr) return (int)cudaErrorInvalidValue;
  if (sr(fmt) && seed == nullptr) return (int)cudaErrorInvalidValue;
  Table t{};
  t.nleaves = 1;
  Leaf& lf = t.leaf[0];
  lf.g = g;
  lf.master = master;
  lf.mu = mu;
  lf.nu = nu;
  lf.seed = seed;
  lf.n = N;
  lf.codec = CODEC_DENSE;
  if (!lay_out(t, true)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sweep(fmt, t, scal, Coeffs{b1, omb1, b2, omb2, eps, 0.0f}, t.blocks,
                           static_cast<cudaStream_t>(stream_handle));
}

extern "C" const char* dladmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
