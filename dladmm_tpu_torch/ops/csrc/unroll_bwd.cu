// Reverse sweep of the K-layer D-LADMM unroll for the final-state loss,
// for Hopper (sm_90a), fp32 throughout.
//
// dladmm_unroll_bwd replaces the TPU kernels
// dladmm_tpu/ops/pallas_bwd.py:_bwd_kernel (driven by unroll_bwd_pallas,
// whole batch) and _bwd_kernel_chunked (driven by
// unroll_bwd_pallas_chunked, batch tiles of bs rows with fp32
// cross-tile accumulation of the parameter gradients). Given the forward
// trajectory (tx, tz, tlam, tAx stacks of (K, S, .)) and the final-state
// cotangents (gx, gz, glam), it walks layers K-1 ... 0. For layer k, with
// beta = max(beta_k, 1e-6), ib = 1 / beta, the layer's inputs z_in, lam_in,
// Ax_in (slice k-1; zero for k = 0) and outputs x1, z1, Ax1 (slice k):
//
//   base = z_in - b + lam_in * ib,  u = Ax_in + base,  v = Ax1 + base
//   gp2  = (gz + beta glam) [z1 != 0]
//   gv   = -gp2 W2                      V phase   (S,m)x(m,m)
//   gAx1 = gAx + beta glam + gv         (V epilogue; the gAx1 stack)
//   gp1  = (gx + gAx1 A) [x1 != 0]      X phase   (S,m)x(m,n)
//   gu   = -gp1 W1                      U phase   (S,n)x(n,m)
//   gbase = gv + gu                     (U epilogue, with the carries:)
//   gz <- gp2 + gbase, glam <- glam + gbase ib, gAx <- gu, gx <- gp1,
//   gb <- gb - gbase - beta glam
//   gW2 = -gp2^T v, gW1 = -gp1^T u      W phase   sums over S
//   gth2 = -sum_s gp2 sign(z1) * tie(th2), gth1 likewise on gp1, x1
//   gbeta = (sum glam (Ax1 + z1 - b) - sum gbase lam_in ib^2) * tie_b
//
// with tie(t) = (t > 0) + 0.5 (t == 0) and tie_b = (beta_k > 1e-6) +
// 0.5 (beta_k == 1e-6), jnp.maximum's split of a tie's gradient.
//
// Design. As the forward (unroll.cu): one layer's W1 + W2 (750 KB at
// m=250, n=500) does not fit a block's 227 KB of shared memory and each
// product needs whole rows of the previous one, so one host call enqueues
// four tiled fp32 GEMM launches per layer on the caller's stream (V, X,
// W, U, in that order) and the stream orders them. Each launch builds its
// operand while staging it into shared memory (gp2 from gz, glam, z1;
// u and v from the trajectory) and fuses the elementwise work into its
// epilogue, so the cotangent state (gx, gz, glam, gAx, gv) is the only
// thing besides the outputs that goes to device memory. The W phase is
// one launch for both weight gradients (row tiles of gW1, then of gW2),
// reducing over S in its depth loop. With bs < S it splits S across
// blockIdx.z into ceil(S / bs) slices, each writing an fp32 partial of
// gW1 and gW2, and a reduce launch sums the partials in slice order: the
// H100's counterpart of the TPU's cross-tile accumulation, for grids too
// small to fill the card (ops/cuda_bwd.bwd_chunk_batch decides).
//
// Determinism. No float atomics. The column sums for gth1 (X epilogue)
// and gth2 (U epilogue) and the two gbeta sums (U epilogue, in double) go
// to per-block partials in a workspace; one finish launch after layer 0
// sums them in block order and applies the tie factors. A run repeats bit
// for bit on one card.
//
// Races. A launch never writes what another block of it reads across
// rows or columns: V reads gz, glam, z1 across columns and writes gv and
// gAx1; X reads gAx1 across columns and rewrites gx element by element
// (gp1 in place); W only reads; U reads gx (gp1) across columns and
// rewrites gz, glam, gAx, gb element by element. So the carries update in
// place and need no second buffer set; layer 0 reads a zero buffer.
//
// Bound. 2 S K (2 m^2 + 3 n m) flops, and the bytes of the weights, the
// trajectory and the outputs once; at S >= 64 the flops dominate, so the
// bound is the fp32 CUDA-core rate. This first kernel is latency-bound,
// like the forward (PERF.md).
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/ops/cuda_bwd.py).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

enum Phase { PHASE_V = 0, PHASE_X = 1, PHASE_W = 2, PHASE_U = 3 };

constexpr float kBetaMin = 1e-6f;
constexpr int kBK = 16;  // depth of one shared-memory tile
constexpr int kBM = 32, kBN = 32, kTM = 2, kTN = 2;
constexpr int kRT = kBM / kTM, kCT = kBN / kTN;
constexpr int kThreads = kRT * kCT;  // 256
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float nonzero(float x) { return x != 0.0f ? 1.0f : 0.0f; }
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ float tie(float t, float at) {
  return t > at ? 1.0f : (t == at ? 0.5f : 0.0f);
}

struct LayerArgs {
  const float* b;       // (S, m)
  const float* A;       // (m, n)
  const float* W1;      // (n, m) layer k
  const float* W2;      // (m, m) layer k
  const float* beta;    // one float: beta_k
  const float* x1;      // (S, n) slice k of tx
  const float* z1;      // (S, m) slice k of tz
  const float* ax1;     // (S, m) slice k of tAx
  const float* z_in;    // (S, m) slice k-1 of tz, tlam, tAx (zeros for k = 0)
  const float* lam_in;
  const float* ax_in;
  float* gx;            // (S, n) cotangent carries, updated in place
  float* gz;            // (S, m)
  float* glam;          // (S, m)
  float* gax;           // (S, m)
  float* gv;            // (S, m) this layer's gv, V phase to U phase
  float* gax1;          // (S, m) this layer's gAx1 (a slice of the stack, or scratch)
  float* gb;            // (S, m) accumulated gb, or null
  float* th1_part;      // (nrb, n) this layer's gth1 column partials
  float* th2_part;      // (nrb, m)
  double* beta_part;    // (blocks of U, 2) this layer's gbeta partials
  float* gw1;           // (n, m) gW1 of layer k, or the (nsplit, n, m) partials
  float* gw2;           // (m, m) / (nsplit, m, m)
  int S, m, n;
  int bs;               // rows per S slice of the W phase
};

// Sum over the block's rows of each of its columns: `colp[j]` is this
// thread's sum over its kTM rows of column tc + j*kCT. Thread tid < kBN
// writes the block's sum of column col0 + tid to out[col0 + tid].
__device__ __forceinline__ void column_sums(const float (&colp)[kTN], float (*s_col)[kBN],
                                            int tr, int tc, int col0, int N, float* out) {
#pragma unroll
  for (int j = 0; j < kTN; ++j) s_col[tr][tc + j * kCT] = colp[j];
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < kBN && col0 + tid < N) {
    float s = 0.0f;
    for (int r = 0; r < kRT; ++r) s += s_col[r][tid];
    out[col0 + tid] = s;
  }
}

// Sum of v over the block, in a fixed order; thread 0 gets the result.
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

// One block computes a kBM x kBN tile of one phase's product and its
// fused epilogue. Thread (tr, tc) owns rows tr + i*kRT and columns
// tc + j*kCT. V, X, U: OUT (S, N) = OPERAND (S, depth) * W (depth, N),
// both row-major. W: OUT (rows, m) = OPERAND^T * UV, the operand gp1 or
// gp2 (S, rows) and UV = u or v (S, m), summed over this slice of S.
template <int PHASE>
__global__ void __launch_bounds__(kThreads) bwd_phase(const LayerArgs a) {
  __shared__ float s_op[kBM][kBK + 1];
  __shared__ float s_w[kBN][kBK + 1];
  __shared__ float s_col[kRT][kBN];
  __shared__ double s_red[kWarps];

  const int S = a.S, m = a.m, n = a.n;
  const int tid = threadIdx.x;
  const int tr = tid / kCT, tc = tid % kCT;
  const float beta = fmaxf(*a.beta, kBetaMin);
  const float ib = 1.0f / beta;

  // Output geometry and the depth range of this block.
  int rows = S, N = m, row0 = blockIdx.x * kBM, k_lo = 0, k_hi;
  bool w1 = false;  // W phase: this block's tile is of gW1 (else gW2)
  const float* w = nullptr;
  if (PHASE == PHASE_V) {
    k_hi = m;
    w = a.W2;
  } else if (PHASE == PHASE_X) {
    N = n;
    k_hi = m;
    w = a.A;
  } else if (PHASE == PHASE_U) {
    k_hi = n;
    w = a.W1;
  } else {
    const int tiles1 = (n + kBM - 1) / kBM;
    w1 = blockIdx.x < tiles1;
    rows = w1 ? n : m;
    row0 = (w1 ? blockIdx.x : blockIdx.x - tiles1) * kBM;
    k_lo = blockIdx.z * a.bs;
    k_hi = min(S, k_lo + a.bs);
  }
  const int col0 = blockIdx.y * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    if (PHASE != PHASE_W) {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i / kBK, kk = i % kBK;
        const int gr = row0 + r, gk = k0 + kk;
        float v = 0.0f;
        if (gr < S && gk < k_hi) {
          if (PHASE == PHASE_V) {
            const size_t o = (size_t)gr * m + gk;
            v = (a.gz[o] + beta * a.glam[o]) * nonzero(a.z1[o]);
          } else if (PHASE == PHASE_X) {
            v = a.gax1[(size_t)gr * m + gk];
          } else {
            v = a.gx[(size_t)gr * n + gk];
          }
        }
        s_op[r][kk] = v;
      }
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int c = i % kBN, kk = i / kBN;
        const int gc = col0 + c, gk = k0 + kk;
        s_w[c][kk] = (gc < N && gk < k_hi) ? w[(size_t)gk * N + gc] : 0.0f;
      }
    } else {
      for (int i = tid; i < kBM * kBK; i += kThreads) {
        const int r = i % kBM, kk = i / kBM;
        const int gr = row0 + r, gs = k0 + kk;
        float v = 0.0f;
        if (gr < rows && gs < k_hi) {
          if (w1) {
            v = a.gx[(size_t)gs * n + gr];
          } else {
            const size_t o = (size_t)gs * m + gr;
            v = (a.gz[o] + beta * a.glam[o]) * nonzero(a.z1[o]);
          }
        }
        s_op[r][kk] = v;
      }
      for (int i = tid; i < kBN * kBK; i += kThreads) {
        const int c = i % kBN, kk = i / kBN;
        const int gc = col0 + c, gs = k0 + kk;
        float v = 0.0f;
        if (gc < m && gs < k_hi) {
          const size_t o = (size_t)gs * m + gc;
          const float base = (a.z_in[o] - a.b[o]) + a.lam_in[o] * ib;
          v = (w1 ? a.ax_in[o] : a.ax1[o]) + base;
        }
        s_w[c][kk] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ov[kTM], wv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) ov[i] = s_op[tr + i * kRT][kk];
#pragma unroll
      for (int j = 0; j < kTN; ++j) wv[j] = s_w[tc + j * kCT][kk];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ov[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (PHASE == PHASE_W) {
    float* out = w1 ? a.gw1 + (size_t)blockIdx.z * n * m : a.gw2 + (size_t)blockIdx.z * m * m;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int r = row0 + tr + i * kRT;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int c = col0 + tc + j * kCT;
        if (r < rows && c < m) out[(size_t)r * m + c] = -acc[i][j];
      }
    }
    return;
  }

  float colp[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) colp[j] = 0.0f;
  double p_res = 0.0, p_lam = 0.0;  // U: the two gbeta sums
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + tr + i * kRT;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tc + j * kCT;
      if (r >= S || c >= N) continue;
      if (PHASE == PHASE_V) {
        const size_t o = (size_t)r * m + c;
        const float gv = -acc[i][j];
        a.gv[o] = gv;
        a.gax1[o] = (a.gax[o] + beta * a.glam[o]) + gv;
      } else if (PHASE == PHASE_X) {
        const size_t o = (size_t)r * n + c;
        const float x1 = a.x1[o];
        const float gp1 = (a.gx[o] + acc[i][j]) * nonzero(x1);
        a.gx[o] = gp1;
        colp[j] += gp1 * sign_of(x1);
      } else {
        const size_t o = (size_t)r * m + c;
        const float glam1 = a.glam[o], z1 = a.z1[o];
        const float gp2 = (a.gz[o] + beta * glam1) * nonzero(z1);
        const float gu = -acc[i][j];
        const float gbase = a.gv[o] + gu;
        a.gz[o] = gp2 + gbase;
        a.glam[o] = glam1 + gbase * ib;
        a.gax[o] = gu;
        if (a.gb) a.gb[o] = (a.gb[o] - gbase) - beta * glam1;
        colp[j] += gp2 * sign_of(z1);
        p_res += (double)(glam1 * ((a.ax1[o] + z1) - a.b[o]));
        p_lam += (double)(gbase * a.lam_in[o]);
      }
    }
  }
  if (PHASE == PHASE_X) column_sums(colp, s_col, tr, tc, col0, n, a.th1_part + (size_t)blockIdx.x * n);
  if (PHASE == PHASE_U) {
    column_sums(colp, s_col, tr, tc, col0, m, a.th2_part + (size_t)blockIdx.x * m);
    const double s_res = block_sum(p_res, s_red);
    const double s_lam = block_sum(p_lam, s_red);
    if (tid == 0) {
      double* out = a.beta_part + 2 * ((size_t)blockIdx.y * gridDim.x + blockIdx.x);
      out[0] = s_res;
      out[1] = s_lam;
    }
  }
}

// gW[i] = sum over the nsplit slices of the partials, in slice order.
__global__ void __launch_bounds__(256)
reduce_splits(const float* __restrict__ p1, const float* __restrict__ p2, float* __restrict__ gw1,
              float* __restrict__ gw2, int nsplit, size_t n1, size_t n2) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n1) {
    float s = 0.0f;
    for (int z = 0; z < nsplit; ++z) s += p1[(size_t)z * n1 + i];
    gw1[i] = s;
  } else if (i < n1 + n2) {
    const size_t j = i - n1;
    float s = 0.0f;
    for (int z = 0; z < nsplit; ++z) s += p2[(size_t)z * n2 + j];
    gw2[j] = s;
  }
}

// After layer 0: gth1, gth2 and gbeta of every layer from the partials.
__global__ void __launch_bounds__(256)
finish(const float* __restrict__ th1, const float* __restrict__ th2,
       const float* __restrict__ beta, const float* __restrict__ th1_part,
       const float* __restrict__ th2_part, const double* __restrict__ beta_part,
       float* __restrict__ gth1, float* __restrict__ gth2, float* __restrict__ gbeta,
       int K, int m, int n, int nrb, int nblk_u) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < K * n) {
    const int k = i / n, c = i % n;
    const float* p = th1_part + (size_t)k * nrb * n + c;
    float s = 0.0f;
    for (int rb = 0; rb < nrb; ++rb) s += p[(size_t)rb * n];
    gth1[i] = -s * tie(th1[i], 0.0f);
  } else if (i < K * (n + m)) {
    const int j = i - K * n, k = j / m, c = j % m;
    const float* p = th2_part + (size_t)k * nrb * m + c;
    float s = 0.0f;
    for (int rb = 0; rb < nrb; ++rb) s += p[(size_t)rb * m];
    gth2[j] = -s * tie(th2[j], 0.0f);
  } else if (i < K * (n + m + 1)) {
    const int k = i - K * (n + m);
    const double* p = beta_part + (size_t)k * nblk_u * 2;
    double s_res = 0.0, s_lam = 0.0;
    for (int q = 0; q < nblk_u; ++q) {
      s_res += p[2 * q];
      s_lam += p[2 * q + 1];
    }
    const float bt = fmaxf(beta[k], kBetaMin);
    const double ib = (double)(1.0f / bt);
    gbeta[k] = (float)(s_res - s_lam * ib * ib) * tie(beta[k], kBetaMin);
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// Workspace layout, in floats from the (256-byte aligned) base.
struct Layout {
  size_t gx, gz, glam, gax, gv, gax1, zeros, th1p, th2p, betap, gw1p, gw2p, floats;
  int nrb, nblk_u, nsplit;
};

Layout layout(int S, int m, int n, int K, int bs, int with_stack) {
  Layout l;
  const size_t sm = (size_t)S * m, sn = (size_t)S * n;
  size_t off = 0;
  auto take = [&off](size_t count) {
    const size_t at = off;
    off += (count + 63) / 64 * 64;  // keep every buffer 256-byte aligned
    return at;
  };
  l.nrb = cdiv(S, kBM);
  l.nblk_u = l.nrb * cdiv(m, kBN);
  l.nsplit = cdiv(S, bs);
  l.gx = take(sn);
  l.gz = take(sm);
  l.glam = take(sm);
  l.gax = take(sm);
  l.gv = take(sm);
  l.gax1 = with_stack ? 0 : take(sm);
  l.zeros = take(sm);
  l.th1p = take((size_t)K * l.nrb * n);
  l.th2p = take((size_t)K * l.nrb * m);
  l.betap = take((size_t)K * l.nblk_u * 4);  // 2 doubles per block
  l.gw1p = l.nsplit > 1 ? take((size_t)l.nsplit * n * m) : 0;
  l.gw2p = l.nsplit > 1 ? take((size_t)l.nsplit * m * m) : 0;
  l.floats = off;
  return l;
}

}  // namespace

// Bytes of scratch dladmm_unroll_bwd needs for these sizes.
extern "C" size_t dladmm_unroll_bwd_workspace_bytes(int S, int m, int n, int K, int bs,
                                                    int data_grads) {
  if (S < 1 || bs < 1) return 0;
  return layout(S, m, n, K, bs, data_grads).floats * sizeof(float);
}

// The reverse sweep, enqueued on `stream`; no sync. Inputs, fp32,
// contiguous, on `device`: b (S,m), A (m,n), W1 (K,n,m), W2 (K,m,m),
// th1 (K,n), th2 (K,m), beta (K,); the forward's stacks tx (K,S,n),
// tz, tlam, tax (K,S,m); the final-state cotangents gx0 (S,n), gz0,
// glam0 (S,m). Outputs gW1 (K,n,m), gW2 (K,m,m), gth1 (K,n), gth2 (K,m),
// gbeta (K,); with data_grads also the gAx1 stack (K,S,m) and gb (S,m)
// (else both null). bs: rows per S slice of the weight gradients (bs >= S
// is the whole batch). `workspace` holds
// dladmm_unroll_bwd_workspace_bytes(S, m, n, K, bs, data_grads) bytes.
// Returns a cudaError_t.
extern "C" int dladmm_unroll_bwd(
    const float* b, const float* A, const float* W1, const float* W2, const float* th1,
    const float* th2, const float* beta, const float* tx, const float* tz, const float* tlam,
    const float* tax, const float* gx0, const float* gz0, const float* glam0, float* gW1,
    float* gW2, float* gth1, float* gth2, float* gbeta, float* gax1_stack, float* gb,
    void* workspace, int S, int m, int n, int K, int bs, int device, void* stream_handle) {
  if (S < 1 || m < 1 || n < 1 || K < 1 || bs < 1) return (int)cudaErrorInvalidValue;
  if ((gax1_stack == nullptr) != (gb == nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (bs > S) bs = S;
  const Layout l = layout(S, m, n, K, bs, gax1_stack != nullptr);
  float* ws = static_cast<float*>(workspace);
  const size_t sm = (size_t)S * m, sn = (size_t)S * n;
  const size_t smb = sm * sizeof(float);

  err = cudaMemcpyAsync(ws + l.gx, gx0, sn * sizeof(float), cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(ws + l.gz, gz0, smb, cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(ws + l.glam, glam0, smb, cudaMemcpyDeviceToDevice, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(ws + l.gax, 0, smb, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(ws + l.zeros, 0, smb, stream);
  if (err == cudaSuccess && gb) err = cudaMemsetAsync(gb, 0, smb, stream);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid_v(l.nrb, cdiv(m, kBN)), grid_x(l.nrb, cdiv(n, kBN));
  const dim3 grid_w(cdiv(n, kBM) + cdiv(m, kBM), cdiv(m, kBN), l.nsplit);
  const size_t n1 = (size_t)n * m, n2 = (size_t)m * m;
  const float* zeros = ws + l.zeros;

  for (int k = K - 1; k >= 0; --k) {
    LayerArgs a;
    a.b = b;
    a.A = A;
    a.W1 = W1 + (size_t)k * n1;
    a.W2 = W2 + (size_t)k * n2;
    a.beta = beta + k;
    a.x1 = tx + (size_t)k * sn;
    a.z1 = tz + (size_t)k * sm;
    a.ax1 = tax + (size_t)k * sm;
    a.z_in = k == 0 ? zeros : tz + (size_t)(k - 1) * sm;
    a.lam_in = k == 0 ? zeros : tlam + (size_t)(k - 1) * sm;
    a.ax_in = k == 0 ? zeros : tax + (size_t)(k - 1) * sm;
    a.gx = ws + l.gx;
    a.gz = ws + l.gz;
    a.glam = ws + l.glam;
    a.gax = ws + l.gax;
    a.gv = ws + l.gv;
    a.gax1 = gax1_stack ? gax1_stack + (size_t)k * sm : ws + l.gax1;
    a.gb = gb;
    a.th1_part = ws + l.th1p + (size_t)k * l.nrb * n;
    a.th2_part = ws + l.th2p + (size_t)k * l.nrb * m;
    a.beta_part = reinterpret_cast<double*>(ws + l.betap) + (size_t)k * l.nblk_u * 2;
    a.gw1 = l.nsplit > 1 ? ws + l.gw1p : gW1 + (size_t)k * n1;
    a.gw2 = l.nsplit > 1 ? ws + l.gw2p : gW2 + (size_t)k * n2;
    a.S = S;
    a.m = m;
    a.n = n;
    a.bs = bs;

    bwd_phase<PHASE_V><<<grid_v, kThreads, 0, stream>>>(a);
    bwd_phase<PHASE_X><<<grid_x, kThreads, 0, stream>>>(a);
    bwd_phase<PHASE_W><<<grid_w, kThreads, 0, stream>>>(a);
    if (l.nsplit > 1)
      reduce_splits<<<(unsigned)((n1 + n2 + 255) / 256), 256, 0, stream>>>(
          ws + l.gw1p, ws + l.gw2p, gW1 + (size_t)k * n1, gW2 + (size_t)k * n2, l.nsplit, n1, n2);
    bwd_phase<PHASE_U><<<grid_v, kThreads, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int total = K * (n + m + 1);
  finish<<<cdiv(total, 256), 256, 0, stream>>>(
      th1, th2, beta, ws + l.th1p, ws + l.th2p, reinterpret_cast<const double*>(ws + l.betap),
      gth1, gth2, gbeta, K, m, n, l.nrb, l.nblk_u);
  return (int)cudaGetLastError();
}

extern "C" const char* dladmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
