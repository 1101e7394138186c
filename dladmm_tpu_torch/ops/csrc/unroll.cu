// Whole-unroll D-LADMM for Hopper (sm_90a), fp32 throughout: the
// inference forward and the trajectory forward of training.
//
// dladmm_unroll_forward replaces the TPU kernel
// dladmm_tpu/ops/pallas_unroll.py:_unroll_kernel (driven by
// _unrolled_forward_pallas): K layers from zero state to the final
// state, with an elementwise prox templated into the x and z updates.
// dladmm_unroll_trajectory replaces _unroll_traj_kernel (driven by
// _traj_pallas): the same recurrence with the l1 prox, writing every
// layer's state into (K, S, .) stacks tx, tz, tlam and, for the manual
// backward, tAx. dladmm_layer_step replaces
// dladmm_tpu/ops/pallas_layer.py:_layer_kernel (driven by _fused_forward):
// ONE l1 layer from a given state (x, z, lam, b, Ax) into fresh buffers
// (x1, z1, lam1, Ax1), its products in fp32 or with both operands
// rounded to bf16 as they are staged (fp32 accumulation either way). For
// layer k, with beta = max(beta_k, 1e-6) and theta
// clamped at >= 0 where it is used:
//
//   base = z - b + lam / beta
//   u    = Ax + base
//   x1   = prox_x(x - u W1^T, theta1)        x phase    (S,m)x(m,n)
//   Ax1  = x1 A^T                            Ax phase   (S,n)x(n,m)
//   v    = Ax1 + base
//   z1   = prox_z(z - v W2^T, theta2)        z phase    (S,m)x(m,m)
//   lam1 = lam + beta (Ax1 + z1 - b)         (same thread as z1: d == m)
//
// Design. On the TPU the whole batch state sits in VMEM for all K layers
// while the weights stream past it. An H100 block has at most 227 KB of
// shared memory and one layer of W1+W2 is 750 KB at m=250, n=500 (12 MB
// at m=1000, n=2000), and each of the three products needs whole rows of
// the previous one. So one host call runs the K layers as 3K launches of
// one tiled fp32 GEMM kernel on the caller's stream; the stream orders
// the phases. Each launch fuses the elementwise work into the GEMM: the
// x and z phases build their operand (u or v) from the state while they
// stage it into shared memory, and their epilogues apply the prox (and
// the dual update). Nothing but the state (x, z, lam, Ax) ever goes to
// device memory. Accumulation is fp32 FMA (no TF32, no tensor cores).
// The trajectory forward is the same 3K launches with other pointers:
// layer k reads its input state from slice k-1 of the stacks (a zero
// buffer for k = 0) and writes its outputs into slice k. The layer step
// is one layer's three launches, reading the caller's state and writing
// new buffers, so autograd can keep the inputs for its backward.
//
// Bound. Per call the work is 2*S*m*(2n+d)*K flops and the bytes are
// K layers of W1/W2, A, b and the outputs (K times the state for the
// trajectory); at the shapes the serving and training paths run
// (S <= 1024) the flops dominate, so the bound is the fp32 CUDA-core
// rate. This first kernel is far from it: at small S it is bound by the
// 3K launches and by few blocks per launch (see PERF.md).
//
// Races. The z phase's operand reads the OLD z and lam across all m
// columns in every block, so z1 and lam1 never overwrite them: the
// inference forward swaps two buffer pairs per layer, the trajectory
// writes the next slice of its stacks. The x phase reads x_in only in
// its epilogue, one element per thread, so the inference forward
// updates x in place (x_in == x); its operand reads Ax_in, which the
// Ax phase of the same layer overwrites only after the x phase ended
// (the stream orders them). The trajectory without tAx keeps one Ax
// scratch buffer under the same rule.
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/ops/cuda_unroll.py,
// ops/cuda_traj.py and ops/cuda_layer.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

enum Prox { PROX_L1 = 0, PROX_NONNEG_L1 = 1, PROX_BOX = 2, PROX_ELASTIC_NET = 3 };
enum Phase { PHASE_X = 0, PHASE_AX = 1, PHASE_Z = 2 };

constexpr int kBK = 16;  // depth of one shared-memory tile

template <int P>
__device__ __forceinline__ float apply_prox(float u, float theta, float scale) {
  const float t = fmaxf(theta, 0.0f);
  if (P == PROX_NONNEG_L1) return fmaxf(u - t, 0.0f);
  if (P == PROX_BOX) return fminf(fmaxf(u, -t), t);
  // l1 soft threshold sign(u) * max(|u| - t, 0); elastic net scales it
  // by 1 / (1 + rho), passed in as `scale`.
  const float s = fmaxf(fabsf(u) - t, 0.0f);
  const float r = u > 0.0f ? s : (u < 0.0f ? -s : 0.0f);
  return P == PROX_ELASTIC_NET ? r * scale : r;
}

struct PhaseArgs {
  const float* b;       // (S, m)
  const float* w;       // (N, depth) row-major: this layer's W1 or W2, or A
  const float* theta;   // (N,) this layer's thresholds (x and z phases)
  const float* beta;    // this layer's beta, one float on the device
  const float* x_in;    // (S, n) x before this layer, read by the x phase
  float* x;             // (S, n) x after it: x phase out, Ax phase in
  const float* ax_in;   // (S, m) Ax before this layer, read by the x phase
  float* ax;            // (S, m) Ax after it: Ax phase out, z phase in
  const float* z_in;    // (S, m) z and lam before this layer
  const float* lam_in;
  float* z_out;         // (S, m) z and lam after this layer
  float* lam_out;
  int S, m, n;
  float scale;          // elastic net 1 / (1 + rho); 1 otherwise
};

// One block computes a BM x BN tile of OUT = OPERAND(S, depth) * W^T and
// its fused epilogue. Thread (tr, tc) owns rows tr + i*RT and columns
// tc + j*CT, so neighbouring threads touch neighbouring columns in the
// epilogue and read distinct shared-memory banks in the inner loop. BF16
// rounds both operands to bf16 (round to nearest) as they are staged.
template <int BM, int BN, int TM, int TN, int PHASE, int PROX, bool BF16>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
unroll_phase(const PhaseArgs a) {
  constexpr int RT = BM / TM;
  constexpr int CT = BN / TN;
  constexpr int NT = RT * CT;
  __shared__ float s_op[BM][kBK + 1];
  __shared__ float s_w[BN][kBK + 1];

  const int depth = PHASE == PHASE_AX ? a.n : a.m;
  const int N = PHASE == PHASE_X ? a.n : a.m;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tr = tid / CT;
  const int tc = tid % CT;

  float beta = 1.0f, inv_beta = 1.0f;
  if (PHASE != PHASE_AX) {
    beta = fmaxf(*a.beta, 1e-6f);
    inv_beta = 1.0f / beta;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < depth; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += NT) {
      const int r = i / kBK, kk = i % kBK;
      const int gr = row0 + r, gk = k0 + kk;
      float v = 0.0f;
      if (gr < a.S && gk < depth) {
        if (PHASE == PHASE_AX) {
          v = a.x[(size_t)gr * a.n + gk];
        } else {
          // u (x phase) or v (z phase) = Ax + (z - b + lam / beta).
          const size_t o = (size_t)gr * a.m + gk;
          const float ax = PHASE == PHASE_X ? a.ax_in[o] : a.ax[o];
          v = ax + ((a.z_in[o] - a.b[o]) + a.lam_in[o] * inv_beta);
        }
      }
      s_op[r][kk] = BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
    }
    for (int i = tid; i < BN * kBK; i += NT) {
      const int c = i / kBK, kk = i % kBK;
      const int gc = col0 + c, gk = k0 + kk;
      const float w = (gc < N && gk < depth) ? a.w[(size_t)gc * depth + gk] : 0.0f;
      s_w[c][kk] = BF16 ? __bfloat162float(__float2bfloat16_rn(w)) : w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ov[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) ov[i] = s_op[tr + i * RT][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = s_w[tc + j * CT][kk];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ov[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + tr + i * RT;
    if (r >= a.S) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tc + j * CT;
      if (c >= N) continue;
      if (PHASE == PHASE_X) {
        const size_t o = (size_t)r * a.n + c;
        a.x[o] = apply_prox<PROX>(a.x_in[o] - acc[i][j], a.theta[c], a.scale);
      } else if (PHASE == PHASE_AX) {
        a.ax[(size_t)r * a.m + c] = acc[i][j];
      } else {
        const size_t o = (size_t)r * a.m + c;
        const float z1 = apply_prox<PROX>(a.z_in[o] - acc[i][j], a.theta[c], a.scale);
        a.z_out[o] = z1;
        a.lam_out[o] = a.lam_in[o] + beta * ((a.ax[o] + z1) - a.b[o]);
      }
    }
  }
}

// One tile size: 32x32 outputs per block, 256 threads with 2x2 each. At
// synthetic_small (m=250, n=500) and S = 256 a launch has 64 (m output
// columns) or 128 (n) blocks on the H100's 132 SMs; 64x64 tiles would
// leave most SMs idle there.
constexpr int kBM = 32, kBN = 32, kTM = 2, kTN = 2;

template <int PHASE, int PROX, bool BF16 = false>
cudaError_t run_phase(const PhaseArgs& a, int N, cudaStream_t stream) {
  const dim3 grid((a.S + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  unroll_phase<kBM, kBN, kTM, kTN, PHASE, PROX, BF16>
      <<<grid, (kBM / kTM) * (kBN / kTN), 0, stream>>>(a);
  return cudaGetLastError();
}

template <int PHASE, bool BF16 = false>
cudaError_t run_prox_phase(int prox, const PhaseArgs& a, int N,
                           cudaStream_t stream) {
  switch (prox) {
    case PROX_L1: return run_phase<PHASE, PROX_L1, BF16>(a, N, stream);
    case PROX_NONNEG_L1: return run_phase<PHASE, PROX_NONNEG_L1, BF16>(a, N, stream);
    case PROX_BOX: return run_phase<PHASE, PROX_BOX, BF16>(a, N, stream);
    case PROX_ELASTIC_NET: return run_phase<PHASE, PROX_ELASTIC_NET, BF16>(a, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The x, Ax and z phases of layer k; `a` holds the state pointers. BF16
// is the layer step's bf16-operand option.
template <bool BF16 = false>
cudaError_t run_layer(PhaseArgs a, const float* A, const float* W1,
                      const float* W2, const float* th1, const float* th2,
                      int k, int prox_x, int prox_z, float scale_x,
                      float scale_z, cudaStream_t stream) {
  const int m = a.m, n = a.n;
  a.w = W1 + (size_t)k * n * m;
  a.theta = th1 + (size_t)k * n;
  a.scale = scale_x;
  cudaError_t err = run_prox_phase<PHASE_X, BF16>(prox_x, a, n, stream);
  if (err != cudaSuccess) return err;

  a.w = A;
  a.theta = nullptr;
  err = run_phase<PHASE_AX, PROX_L1, BF16>(a, m, stream);
  if (err != cudaSuccess) return err;

  a.w = W2 + (size_t)k * m * m;
  a.theta = th2 + (size_t)k * m;
  a.scale = scale_z;
  return run_prox_phase<PHASE_Z, BF16>(prox_z, a, m, stream);
}

}  // namespace

// All K layers of the inference unroll, enqueued on `stream`; no sync.
// Inputs: b (S,m), A (m,n), W1 (K,n,m), W2 (K,m,m), th1 (K,n), th2 (K,m),
// beta (K,), all fp32, contiguous, on `device`. Outputs x (S,n), z (S,m),
// lam (S,m); scratch z_tmp, lam_tmp, ax (S,m). Returns a cudaError_t.
extern "C" int dladmm_unroll_forward(
    const float* b, const float* A, const float* W1, const float* W2,
    const float* th1, const float* th2, const float* beta, float* x, float* z,
    float* lam, float* z_tmp, float* lam_tmp, float* ax, int S, int m, int n,
    int K, int prox_x, int prox_z, float scale_x, float scale_z, int device,
    void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);

  // Zero state: x, Ax and both z/lam buffers (layer 0 reads one pair).
  const size_t sm_bytes = (size_t)S * m * sizeof(float);
  float* zero_sm[] = {ax, z, lam, z_tmp, lam_tmp};
  err = cudaMemsetAsync(x, 0, (size_t)S * n * sizeof(float), stream);
  for (float* p : zero_sm)
    if (err == cudaSuccess) err = cudaMemsetAsync(p, 0, sm_bytes, stream);
  if (err != cudaSuccess) return (int)err;

  for (int k = 0; k < K; ++k) {
    // Ping-pong so that the last layer writes the output pair (z, lam).
    const bool to_out = ((K - 1 - k) % 2) == 0;
    PhaseArgs a;
    a.b = b;
    a.beta = beta + k;
    a.x_in = x;  // in place: see Races
    a.x = x;
    a.ax_in = ax;
    a.ax = ax;
    a.z_in = to_out ? z_tmp : z;
    a.lam_in = to_out ? lam_tmp : lam;
    a.z_out = to_out ? z : z_tmp;
    a.lam_out = to_out ? lam : lam_tmp;
    a.S = S;
    a.m = m;
    a.n = n;

    err = run_layer(a, A, W1, W2, th1, th2, k, prox_x, prox_z, scale_x, scale_z, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// All K layers of the trajectory forward (l1 prox), enqueued on
// `stream`; no sync. Inputs as dladmm_unroll_forward. Outputs the stacks
// tx (K,S,n), tz (K,S,m), tlam (K,S,m) and, with with_tax, tax (K,S,m);
// without it `tax` is one (S,m) scratch buffer. `zeros` is scratch of
// S*max(n,m) floats, zeroed here: layer 0's input state. Returns a
// cudaError_t.
extern "C" int dladmm_unroll_trajectory(
    const float* b, const float* A, const float* W1, const float* W2,
    const float* th1, const float* th2, const float* beta, float* tx,
    float* tz, float* tlam, float* tax, float* zeros, int with_tax, int S,
    int m, int n, int K, int device, void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const size_t sn = (size_t)S * n, sm = (size_t)S * m;
  err = cudaMemsetAsync(zeros, 0, (sn > sm ? sn : sm) * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;

  for (int k = 0; k < K; ++k) {
    const size_t prev = (size_t)(k - 1), cur = (size_t)k;
    PhaseArgs a;
    a.b = b;
    a.beta = beta + k;
    a.x_in = k == 0 ? zeros : tx + prev * sn;
    a.x = tx + cur * sn;
    if (with_tax) {
      a.ax_in = k == 0 ? zeros : tax + prev * sm;
      a.ax = tax + cur * sm;
    } else {
      a.ax_in = k == 0 ? zeros : tax;
      a.ax = tax;
    }
    a.z_in = k == 0 ? zeros : tz + prev * sm;
    a.lam_in = k == 0 ? zeros : tlam + prev * sm;
    a.z_out = tz + cur * sm;
    a.lam_out = tlam + cur * sm;
    a.S = S;
    a.m = m;
    a.n = n;
    err = run_layer(a, A, W1, W2, th1, th2, k, PROX_L1, PROX_L1, 1.0f, 1.0f, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One l1 layer (B = I) from the state x (S,n), z, lam, ax (S,m) into the
// fresh outputs x1 (S,n), z1, lam1, ax1 (S,m), enqueued on `stream`; no
// sync. Inputs b (S,m), A (m,n), W1 (n,m), W2 (m,m), th1 (n,), th2 (m,),
// beta (1,): this layer's, fp32, contiguous, on `device`. bf16 != 0
// rounds the products' operands to bf16. No output aliases an input.
// Returns a cudaError_t.
extern "C" int dladmm_layer_step(
    const float* b, const float* A, const float* W1, const float* W2,
    const float* th1, const float* th2, const float* beta, const float* x,
    const float* z, const float* lam, const float* ax, float* x1, float* z1,
    float* lam1, float* ax1, int S, int m, int n, int bf16, int device,
    void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  PhaseArgs a;
  a.b = b;
  a.beta = beta;
  a.x_in = x;
  a.x = x1;
  a.ax_in = ax;
  a.ax = ax1;
  a.z_in = z;
  a.lam_in = lam;
  a.z_out = z1;
  a.lam_out = lam1;
  a.S = S;
  a.m = m;
  a.n = n;
  err = bf16 ? run_layer<true>(a, A, W1, W2, th1, th2, 0, PROX_L1, PROX_L1, 1.0f, 1.0f, stream)
             : run_layer<false>(a, A, W1, W2, th1, th2, 0, PROX_L1, PROX_L1, 1.0f, 1.0f, stream);
  return (int)err;
}

extern "C" const char* dladmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
