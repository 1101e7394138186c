// One-pass Adam sweep with dense moments (fp32, bf16, or bf16 stored by
// stochastic rounding), for Hopper (sm_90a).
//
// Replaces the TPU kernel dladmm_tpu/train/qadam_pallas.py:_make_kernel_dense
// (driven by _leaf_apply_pallas). For one parameter leaf of N elements,
// in one pass and in place, element i:
//
//   g'      = g * clip_scale
//   mu'     = b1 * mu + (1 - b1) * g'
//   nu'     = b2 * nu + (1 - b2) * g' * g'
//   master -= lr * (mu' / c1) / (sqrt(nu' / c2) + eps)
//   mu, nu  <- mu', nu' in their stored types
//
// mu and nu are read and written as fp32 or bf16 (the moment formats of
// _DENSE_FMTS: float32, bfloat16, bfloat16_sr with both moments SR-bf16,
// bfloat16_sr_mu with an SR-bf16 mu and an fp32 nu). A round-to-nearest
// store is __float2bfloat16_rn; a stochastic store adds 16 random bits to
// the fp32 pattern below the bf16 boundary (uint32 wrap-around) and
// truncates, as qmoments.sr_bfloat16. The bits come from Philox4x32-10,
// written out below: key (seed, 0), counter (i as two 32-bit words, 0, 0),
// word x for mu and word y for nu, so each element of each moment has its
// own bits and a launch repeats bit for bit. The seed is the leaf's _mix_seed(count, idx),
// an int32 on the device. c1, c2 (bias corrections), lr and clip_scale
// arrive as four floats on the device: the host never reads them.
//
// Design. Elementwise, one thread per element over a grid-stride loop.
// Each element is read once and written once, so the sweep is bound by
// device-memory bytes: 28 per element with fp32 moments (g, master read
// and written, mu and nu read and written), 20 with bf16 moments. The
// arithmetic uses the round-to-nearest intrinsics in the JAX kernel's
// order (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn): nvcc may not
// contract them into FMAs, so the kernel computes what the plain PyTorch
// version computes, operation for operation, up to the SR bits.
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/train/qadam_cuda.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

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

template <typename MuT, typename NuT, bool SR_MU, bool SR_NU>
__global__ void __launch_bounds__(kThreads)
qadam_dense(const float* __restrict__ g, float* __restrict__ master, MuT* __restrict__ mu,
            NuT* __restrict__ nu, const float* __restrict__ scal, const int* __restrict__ seed,
            long long N, float b1, float omb1, float b2, float omb2, float eps) {
  const float c1 = scal[0], c2 = scal[1], lr = scal[2], cs = scal[3];
  const uint32_t key = (SR_MU || SR_NU) ? (uint32_t)*seed : 0u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N; i += stride) {
    const float gs = __fmul_rn(g[i], cs);
    const float m = __fadd_rn(__fmul_rn(b1, load(mu[i])), __fmul_rn(omb1, gs));
    const float v = __fadd_rn(__fmul_rn(b2, load(nu[i])), __fmul_rn(__fmul_rn(omb2, gs), gs));
    const float upd = __fdiv_rn(__fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps));
    master[i] = __fsub_rn(master[i], __fmul_rn(lr, upd));
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (SR_MU || SR_NU)
      r = philox4x32_10(make_uint4((uint32_t)i, (uint32_t)(i >> 32), 0u, 0u), make_uint2(key, 0u));
    mu[i] = store<MuT, SR_MU>(m, r.x);
    nu[i] = store<NuT, SR_NU>(v, r.y);
  }
}

template <typename MuT, typename NuT, bool SR_MU, bool SR_NU>
cudaError_t run(const float* g, float* master, void* mu, void* nu, const float* scal,
                const int* seed, long long N, float b1, float omb1, float b2, float omb2,
                float eps, cudaStream_t stream) {
  const long long want = (N + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  qadam_dense<MuT, NuT, SR_MU, SR_NU><<<blocks, kThreads, 0, stream>>>(
      g, master, static_cast<MuT*>(mu), static_cast<NuT*>(nu), scal, seed, N, b1, omb1, b2, omb2,
      eps);
  return cudaGetLastError();
}

}  // namespace

// One Adam step on a leaf of N elements, in place, enqueued on `stream`;
// no sync. g, master fp32 (N,); mu, nu in the format's types (fmt: 0
// float32, 1 bfloat16, 2 bfloat16_sr, 3 bfloat16_sr_mu); scal fp32
// [c1, c2, lr, clip_scale] and seed (one int32, read only by the SR
// formats; may be null otherwise) on the device. omb1 and omb2 are
// (1 - b1) and (1 - b2) rounded once from double, as the JAX package
// forms them. Returns a cudaError_t.
extern "C" int dladmm_qadam_dense(const float* g, float* master, void* mu, void* nu,
                                  const float* scal, const int* seed, long long N, int fmt,
                                  float b1, float omb1, float b2, float omb2, float eps,
                                  int device, void* stream_handle) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  if ((fmt == FMT_BFLOAT16_SR || fmt == FMT_BFLOAT16_SR_MU) && seed == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  switch (fmt) {
    case FMT_FLOAT32:
      return (int)run<float, float, false, false>(g, master, mu, nu, scal, seed, N, b1, omb1, b2,
                                                  omb2, eps, stream);
    case FMT_BFLOAT16:
      return (int)run<__nv_bfloat16, __nv_bfloat16, false, false>(g, master, mu, nu, scal, seed, N,
                                                                  b1, omb1, b2, omb2, eps, stream);
    case FMT_BFLOAT16_SR:
      return (int)run<__nv_bfloat16, __nv_bfloat16, true, true>(g, master, mu, nu, scal, seed, N, b1,
                                                                omb1, b2, omb2, eps, stream);
    case FMT_BFLOAT16_SR_MU:
      return (int)run<__nv_bfloat16, float, true, false>(g, master, mu, nu, scal, seed, N, b1, omb1,
                                                         b2, omb2, eps, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* dladmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
