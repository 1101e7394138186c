// int8 whole-unroll D-LADMM inference for Hopper (sm_90a).
//
// dladmm_int8_unroll_forward replaces the TPU kernel
// dladmm_tpu/ops/quantized.py:_int8_unroll_kernel (driven by
// dladmm_forward_int8_pallas): K layers from zero state with int8 W1, W2
// and A (per-row fp32 scales), per-sample dynamic int8 activations,
// exact s8 x s8 -> s32 dots, and fp32 state and elementwise work. For
// layer k, with beta = max(beta_k, 1e-6) and theta clamped at >= 0:
//
//   base = z - b + lam * (1 / beta)
//   u    = Ax + base;       s_u = max|u_i| * (1/127);  u_q = rint(u / max(s_u, 1e-12))
//   x1   = shrink(x - (u_q W1_q^T) * s_u * W1_s, theta1)
//   Ax1  = (x1_q A_q^T) * s_x * A_s                     (x1 quantized as u)
//   v    = Ax1 + base                                    (v quantized as u)
//   z1   = shrink(z - (v_q W2_q^T) * s_v * W2_s, theta2)
//   lam1 = lam + beta (Ax1 + z1 - b)
//
// Design. One host call enqueues six launches a layer on the caller's
// stream, which orders them: (a) one block per row builds u from the
// state, reduces its max |u| and writes the codes u_q and the scale s_u;
// (b) a tiled int8 GEMM against W1_q whose epilogue dequantizes, subtracts
// from x and shrinks, in place; (c) quantizes x1 as (a); (d) the GEMM
// against A_q writes Ax1; (e) quantizes v = Ax1 + base, with base rebuilt
// from the old z and lam; (f) the GEMM against W2_q whose epilogue gives
// z1 and lam1. A row's scale needs the whole row, so quantizing cannot
// fuse into the GEMM that consumes it. Because (f) reads the codes v_q
// and not z or lam across rows, z and lam update in place, element by
// element, with no second buffer pair. One code buffer (S x max(m, n)
// bytes) and one scale vector serve all three quantizations: each is
// consumed by the next launch before the following one overwrites it.
// Rows of the codes and the weights are not padded: the GEMM stages
// bytes into shared memory, zero-filled past the edge (zeros leave the
// int32 sum unchanged), and its inner loop reads them as int8x4 words
// for __dp4a.
//
// Bits. The kernel computes what its plain version
// (ops/cuda_int8.int8_unroll_forward_plain) computes, operation for
// operation: round-to-nearest intrinsics (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn), which nvcc never contracts into FMAs, in the
// plain version's order; codes rounded half to even (__float2int_rn, as
// torch.round); the int32 sum converted by __int2float_rn (exact below
// 2^24; above, rounded as the plain version's int32 -> fp32 cast); the
// constants 1/127, 1e-12 and 1e-6 rounded from double as Python's are.
// A last-bit difference would flip a code and travel through every
// later layer, so none is allowed.
//
// Bound. Per call 2*S*m*(2n+m)*K integer operations; bytes: the int8
// weights and A, their scales, b and the fp32 outputs. Against the
// H100's int8 tensor-core peak both are microseconds at the serving
// shapes; this CUDA-core __dp4a kernel with 6K launches is far from it
// (PERF.md). Tensor cores (mma/wgmma) are later work.
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/ops/cuda_int8.py).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// Python rounds these from doubles to fp32 at use; so does the kernel.
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kTiny = (float)1e-12;
constexpr float kBetaMin = (float)1e-6;

enum QuantSrc { Q_BASE = 0, Q_X = 1 };
enum Phase { PHASE_X = 0, PHASE_AX = 1, PHASE_Z = 2 };

constexpr int kQThreads = 256;

struct QuantArgs {
  const float* src;    // Q_X: x (S, cols); Q_BASE: Ax (S, cols)
  const float* z;      // Q_BASE: z, lam, b (S, cols), this layer's beta
  const float* lam;
  const float* b;
  const float* beta;
  int8_t* q;           // (S, cols) codes
  float* scale;        // (S,) scales
  int cols;
};

template <int SRC>
__device__ __forceinline__ float quant_value(const QuantArgs& a, size_t o, float inv_beta) {
  if (SRC == Q_X) return a.src[o];
  // Ax + ((z - b) + lam * (1 / beta))
  return __fadd_rn(a.src[o], __fadd_rn(__fsub_rn(a.z[o], a.b[o]), __fmul_rn(a.lam[o], inv_beta)));
}

// One block per row: the row's max |value|, its scale and its codes.
template <int SRC>
__global__ void __launch_bounds__(kQThreads) quantize_rows(const QuantArgs a) {
  __shared__ float s_max[kQThreads / 32];
  const size_t off = (size_t)blockIdx.x * a.cols;
  float inv_beta = 1.0f;
  if (SRC == Q_BASE) inv_beta = __fdiv_rn(1.0f, fmaxf(*a.beta, kBetaMin));

  float amax = 0.0f;
  for (int j = threadIdx.x; j < a.cols; j += kQThreads)
    amax = fmaxf(amax, fabsf(quant_value<SRC>(a, off + j, inv_beta)));
#pragma unroll
  for (int d = 16; d > 0; d /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, d));
  if (threadIdx.x % 32 == 0) s_max[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = s_max[0];
#pragma unroll
  for (int w = 1; w < kQThreads / 32; ++w) amax = fmaxf(amax, s_max[w]);

  const float s = __fmul_rn(amax, kInv127);
  const float den = fmaxf(s, kTiny);
  if (threadIdx.x == 0) a.scale[blockIdx.x] = s;
  for (int j = threadIdx.x; j < a.cols; j += kQThreads)
    a.q[off + j] = (int8_t)__float2int_rn(__fdiv_rn(quant_value<SRC>(a, off + j, inv_beta), den));
}

struct GemmArgs {
  const int8_t* q;      // (S, depth) operand codes
  const float* q_s;     // (S,) operand scales
  const int8_t* w;      // (N, depth) weight codes: this layer's W1_q or W2_q, or A_q
  const float* w_s;     // (N,) weight scales
  const float* theta;   // (N,) thresholds (x and z phases)
  const float* beta;    // this layer's beta (z phase)
  const float* b;       // (S, m)
  float* x;             // (S, n) x phase: in place
  float* ax;            // (S, m) Ax phase out, z phase in
  float* z;             // (S, m) z phase: in place
  float* lam;
  int S, N, depth;
};

__device__ __forceinline__ float shrink(float u, float theta) {
  const float s = fmaxf(__fsub_rn(fabsf(u), fmaxf(theta, 0.0f)), 0.0f);
  return u > 0.0f ? s : (u < 0.0f ? -s : 0.0f);
}

// (acc * s_row) * s_col, as the plain version's (acc * s_act) * w_s.
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col);
}

constexpr int kBM = 32, kBN = 32, kTM = 2, kTN = 2;
constexpr int kBK = 64;           // bytes of depth per shared-memory tile
constexpr int kRow = kBK + 4;     // row stride in bytes: 17 words, conflict-free
constexpr int kNT = (kBM / kTM) * (kBN / kTN);

// One block computes a kBM x kBN tile of OUT = q (S, depth) * w^T in int32
// and its epilogue. Thread (tr, tc) owns rows tr + i*RT and columns
// tc + j*CT, as in unroll.cu.
template <int PHASE>
__global__ void __launch_bounds__(kNT) int8_phase(const GemmArgs a) {
  constexpr int RT = kBM / kTM;
  constexpr int CT = kBN / kTN;
  __shared__ __align__(16) int8_t s_op[kBM * kRow];
  __shared__ __align__(16) int8_t s_w[kBN * kRow];

  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tr = tid / CT;
  const int tc = tid % CT;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < a.depth; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kNT) {
      const int r = i / kBK, kk = i % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      s_op[r * kRow + kk] = (gr < a.S && gk < a.depth) ? a.q[(size_t)gr * a.depth + gk] : (int8_t)0;
    }
    for (int i = tid; i < kBN * kBK; i += kNT) {
      const int c = i / kBK, kk = i % kBK;
      const int gc = col0 + c, gk = k0 + kk;
      s_w[c * kRow + kk] = (gc < a.N && gk < a.depth) ? a.w[(size_t)gc * a.depth + gk] : (int8_t)0;
    }
    __syncthreads();
#pragma unroll
    for (int wd = 0; wd < kBK / 4; ++wd) {
      int ov[kTM], wv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        ov[i] = *reinterpret_cast<const int*>(&s_op[(tr + i * RT) * kRow + 4 * wd]);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        wv[j] = *reinterpret_cast<const int*>(&s_w[(tc + j * CT) * kRow + 4 * wd]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(ov[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float beta = 1.0f;
  if (PHASE == PHASE_Z) beta = fmaxf(*a.beta, kBetaMin);
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + tr + i * RT;
    if (r >= a.S) continue;
    const float s_row = a.q_s[r];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tc + j * CT;
      if (c >= a.N) continue;
      const size_t o = (size_t)r * a.N + c;
      const float y = dequant(acc[i][j], s_row, a.w_s[c]);
      if (PHASE == PHASE_X) {
        a.x[o] = shrink(__fsub_rn(a.x[o], y), a.theta[c]);
      } else if (PHASE == PHASE_AX) {
        a.ax[o] = y;
      } else {
        const float z1 = shrink(__fsub_rn(a.z[o], y), a.theta[c]);
        // lam + beta * ((Ax1 + z1) - b)
        a.lam[o] = __fadd_rn(a.lam[o], __fmul_rn(beta, __fsub_rn(__fadd_rn(a.ax[o], z1), a.b[o])));
        a.z[o] = z1;
      }
    }
  }
}

template <int SRC>
cudaError_t quantize(const QuantArgs& a, int S, cudaStream_t stream) {
  quantize_rows<SRC><<<S, kQThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int PHASE>
cudaError_t gemm(const GemmArgs& a, cudaStream_t stream) {
  const dim3 grid((a.S + kBM - 1) / kBM, (a.N + kBN - 1) / kBN);
  int8_phase<PHASE><<<grid, kNT, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// All K layers of the int8 inference unroll, enqueued on `stream`; no
// sync. Inputs: b (S,m) fp32; A_q (m,n) int8, A_s (m,); W1_q (K,n,m) int8,
// W1_s (K,n); W2_q (K,m,m) int8, W2_s (K,m); th1 (K,n), th2 (K,m), beta
// (K,) fp32; all contiguous on `device`. Outputs x (S,n), z (S,m),
// lam (S,m); scratch ax (S,m) fp32, q (S*max(m,n)) int8, scale (S,) fp32.
// Returns a cudaError_t.
extern "C" int dladmm_int8_unroll_forward(
    const float* b, const int8_t* A_q, const float* A_s, const int8_t* W1_q,
    const float* W1_s, const int8_t* W2_q, const float* W2_s, const float* th1,
    const float* th2, const float* beta, float* x, float* z, float* lam, float* ax,
    int8_t* q, float* scale, int S, int m, int n, int K, int device, void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);

  const size_t sm_bytes = (size_t)S * m * sizeof(float);
  err = cudaMemsetAsync(x, 0, (size_t)S * n * sizeof(float), stream);
  float* zero_sm[] = {z, lam, ax};
  for (float* p : zero_sm)
    if (err == cudaSuccess) err = cudaMemsetAsync(p, 0, sm_bytes, stream);
  if (err != cudaSuccess) return (int)err;

  for (int k = 0; k < K; ++k) {
    QuantArgs qa;
    qa.src = ax;
    qa.z = z;
    qa.lam = lam;
    qa.b = b;
    qa.beta = beta + k;
    qa.q = q;
    qa.scale = scale;
    qa.cols = m;

    GemmArgs g;
    g.q = q;
    g.q_s = scale;
    g.beta = beta + k;
    g.b = b;
    g.x = x;
    g.ax = ax;
    g.z = z;
    g.lam = lam;
    g.S = S;

    // (a) u = Ax + base -> codes; (b) x1 = shrink(x - u W1^T, theta1).
    err = quantize<Q_BASE>(qa, S, stream);
    if (err != cudaSuccess) return (int)err;
    g.w = W1_q + (size_t)k * n * m;
    g.w_s = W1_s + (size_t)k * n;
    g.theta = th1 + (size_t)k * n;
    g.N = n;
    g.depth = m;
    err = gemm<PHASE_X>(g, stream);
    if (err != cudaSuccess) return (int)err;

    // (c) x1 -> codes; (d) Ax1 = x1 A^T.
    QuantArgs xa = qa;
    xa.src = x;
    xa.cols = n;
    err = quantize<Q_X>(xa, S, stream);
    if (err != cudaSuccess) return (int)err;
    g.w = A_q;
    g.w_s = A_s;
    g.theta = nullptr;
    g.N = m;
    g.depth = n;
    err = gemm<PHASE_AX>(g, stream);
    if (err != cudaSuccess) return (int)err;

    // (e) v = Ax1 + base -> codes; (f) z1, lam1 in place.
    err = quantize<Q_BASE>(qa, S, stream);
    if (err != cudaSuccess) return (int)err;
    g.w = W2_q + (size_t)k * m * m;
    g.w_s = W2_s + (size_t)k * m;
    g.theta = th2 + (size_t)k * m;
    g.N = m;
    g.depth = m;
    err = gemm<PHASE_Z>(g, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

extern "C" const char* dladmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
