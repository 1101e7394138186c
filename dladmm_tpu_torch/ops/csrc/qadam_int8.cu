// One-pass Adam sweep with per-row sqrt-companded int8 moments, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel dladmm_tpu/train/qadam_pallas.py:_make_kernel_int8
// (driven by _leaf_apply_pallas). For one (R, L) parameter leaf, in one
// pass and in place, row r:
//
//   mu, nu  = sign(c) * c * c * scale_r, c = code * (1/127)    decode
//   g'      = g * clip_scale
//   mu'     = b1 * mu + (1 - b1) * g'
//   nu'     = b2 * nu + (1 - b2) * g' * g'
//   master -= lr * (mu' / c1) / (sqrt(nu' / c2) + eps)
//   scale_r = absmax of the row (1.0 for an all-zero row), per moment
//   code    = round_half_even(127 * sign(y) * sqrt(|y|)), y = mu' / scale_r
//
// c1, c2 (bias corrections), lr and clip_scale arrive as four floats on
// the device, so the host never reads them and never waits.
//
// Design. One block per row: L <= 1638 by the codec rule
// (train/qadam_cuda.leaf_eligible), so each of the 256 threads keeps at
// most kMaxPerThread of the row's new moments in registers between the
// update and the encode; the row's absmax is a warp-shuffle then
// shared-memory max. Every element is read once and written once (g,
// master, two int8 codes; one scale pair per row), so the sweep is bound
// by device-memory bytes, 16 per element. The arithmetic uses the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn) in the JAX kernel's order: nvcc may not contract them
// into FMAs, so the kernel computes what the plain PyTorch version
// computes, operation for operation.
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/train/qadam_cuda.py).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 8;  // rows up to 2048 wide
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float decode(int8_t code, float scale, float inv127) {
  const float c = __fmul_rn((float)code, inv127);
  return __fmul_rn(__fmul_rn(__fmul_rn(sign_of(c), c), c), scale);
}

__device__ __forceinline__ int8_t encode(float x, float scale) {
  const float y = __fdiv_rn(x, scale);
  const float c = __fmul_rn(sign_of(y), __fsqrt_rn(fabsf(y)));
  return (int8_t)__float2int_rn(__fmul_rn(c, 127.0f));
}

// Max over the block of each thread's v; every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : 0.0f;
#pragma unroll
  for (int o = kWarps / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return __shfl_sync(0xffffffffu, v, 0);  // lanes 0..kWarps-1 hold the max
}

__global__ void __launch_bounds__(kThreads)
qadam_int8_rows(const float* __restrict__ g, float* __restrict__ master,
                int8_t* __restrict__ mu_c, float* __restrict__ mu_s,
                int8_t* __restrict__ nu_c, float* __restrict__ nu_s,
                const float* __restrict__ scal, int L, float b1, float omb1,
                float b2, float omb2, float eps, float inv127) {
  __shared__ float red_mu[kWarps];
  __shared__ float red_nu[kWarps];
  const size_t base = (size_t)blockIdx.x * L;
  const float c1 = scal[0], c2 = scal[1], lr = scal[2], cs = scal[3];
  const float smu = mu_s[blockIdx.x], snu = nu_s[blockIdx.x];

  float mu[kMaxPerThread], nu[kMaxPerThread];
  float amax_mu = 0.0f, amax_nu = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int j = threadIdx.x + i * kThreads;
    mu[i] = nu[i] = 0.0f;
    if (j >= L) continue;
    const size_t o = base + j;
    const float gs = __fmul_rn(g[o], cs);
    const float m = __fadd_rn(__fmul_rn(b1, decode(mu_c[o], smu, inv127)), __fmul_rn(omb1, gs));
    const float v = __fadd_rn(__fmul_rn(b2, decode(nu_c[o], snu, inv127)),
                              __fmul_rn(__fmul_rn(omb2, gs), gs));
    const float upd = __fdiv_rn(__fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps));
    master[o] = __fsub_rn(master[o], __fmul_rn(lr, upd));
    mu[i] = m;
    nu[i] = v;
    amax_mu = fmaxf(amax_mu, fabsf(m));
    amax_nu = fmaxf(amax_nu, fabsf(v));
  }
  // Every thread has read its row's old scales before any writes them.
  amax_mu = block_max(amax_mu, red_mu);
  amax_nu = block_max(amax_nu, red_nu);
  const float new_smu = amax_mu > 0.0f ? amax_mu : 1.0f;
  const float new_snu = amax_nu > 0.0f ? amax_nu : 1.0f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int j = threadIdx.x + i * kThreads;
    if (j >= L) continue;
    mu_c[base + j] = encode(mu[i], new_smu);
    nu_c[base + j] = encode(nu[i], new_snu);
  }
  if (threadIdx.x == 0) {
    mu_s[blockIdx.x] = new_smu;
    nu_s[blockIdx.x] = new_snu;
  }
}

}  // namespace

// One Adam step on an (R, L) leaf, in place, enqueued on `stream`; no
// sync. g, master fp32 (R, L); mu_c, nu_c int8 (R, L); mu_s, nu_s fp32
// (R,); scal fp32 [c1, c2, lr, clip_scale] on the device. omb1 and omb2
// are (1 - b1) and (1 - b2) rounded once from double, as the JAX package
// forms them. Returns a cudaError_t.
extern "C" int dladmm_qadam_int8_rows(
    const float* g, float* master, int8_t* mu_c, float* mu_s, int8_t* nu_c,
    float* nu_s, const float* scal, int R, int L, float b1, float omb1,
    float b2, float omb2, float eps, float inv127, int device,
    void* stream_handle) {
  if (L < 1 || L > kThreads * kMaxPerThread || R < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  qadam_int8_rows<<<R, kThreads, 0, static_cast<cudaStream_t>(stream_handle)>>>(
      g, master, mu_c, mu_s, nu_c, nu_s, scal, L, b1, omb1, b2, omb2, eps, inv127);
  return (int)cudaGetLastError();
}

extern "C" const char* dladmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
