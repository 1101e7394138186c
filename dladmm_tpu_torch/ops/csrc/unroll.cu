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
// Design of the inference forward and the layer step. On the TPU the
// whole batch state sits in VMEM for all K layers while the weights
// stream past it. An H100 block has at most 227 KB of shared memory and
// one layer of W1+W2 is 750 KB at m=250, n=500 (12 MB at m=1000,
// n=2000), and each of the three products needs whole rows of the
// previous one. So one host call runs the K layers as 3K launches of one
// tiled fp32 GEMM kernel (unroll_phase) on the caller's stream; the
// stream orders the phases. Each launch fuses the elementwise work into
// the GEMM: the x and z phases build their operand (u or v) from the
// state while they stage it into shared memory, and their epilogues
// apply the prox (and the dual update). Nothing but the state (x, z,
// lam, Ax) ever goes to device memory. Accumulation is fp32 FMA (no
// TF32, no tensor cores). The layer step is one layer's three launches,
// reading the caller's state and writing new buffers, so autograd can
// keep the inputs for its backward.
//
// Design of the trajectory forward (traj_persistent). The same three
// products a layer, but one persistent cooperative launch runs all K
// layers, with a grid-wide barrier between dependent phases (3K - 1 a
// call). At training's S = 64 a phase has only 16-32 output tiles of
// 32 x 32, so each phase also cuts its depth into slices (the split is
// computed by ops/schedule.py and passed in): tiles x slices work items
// spread the phase over the grid, blocks loop over items, and large S
// (more tiles than blocks) needs no split. A sliced item writes a
// partial tile to the workspace; the last block to finish a tile
// (counted by an integer atomic per tile, reset by that block) sums the
// partials in slice order and runs the epilogue. No float atomics, so a
// call repeats bit for bit on one card. Each block keeps the next depth
// step's loads in flight (registers) while it computes the current one
// from the other half of a double-buffered shared-memory tile; 4-byte
// loads (rows of m = 250 floats are 8-byte aligned, so no 16-byte copy or
// TMA descriptor). A two- or three-stage cp.async pipeline for the
// weights was measured slower on the H100: it costs registers, and so
// resident blocks where the grid is the occupancy (PERF.md, PR 5).
// __launch_bounds__(kPT, 4) holds the kernel at 64 registers, 4 blocks a
// SM. At synthetic_small all layers' W1 + W2 plus A (11.75 MB) stay in
// the 50 MB L2.
//
// Bound. Per call the work is 2*S*m*(2n+d)*K flops and the bytes are
// K layers of W1/W2, A, b and the outputs (K times the state for the
// trajectory); at the shapes the serving and training paths run
// (S <= 1024) the flops dominate, so the bound is the fp32 CUDA-core
// rate. The 3K-launch kernels are far from it: at small S they are
// bound by the launches and by few blocks per launch (see PERF.md); the
// persistent trajectory by its 3K - 1 barriers and its serial depth.
//
// Races. The z phase's operand reads the OLD z and lam across all m
// columns in every block, so z1 and lam1 never overwrite them: the
// inference forward swaps two buffer pairs per layer, the trajectory
// writes the next slice of its stacks. The x phase reads x_in only in
// its epilogue, one element per thread, so the inference forward
// updates x in place (x_in == x); its operand reads Ax_in, which the
// Ax phase of the same layer overwrites only after the x phase ended
// (the stream, or the trajectory's barrier, orders them). The trajectory
// without tAx keeps one Ax scratch buffer under the same rule. Inside
// the persistent kernel, state written in the call is read with
// __ldcg (L2, never a stale L1 line); the weights with __ldg.
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/ops/cuda_unroll.py,
// ops/cuda_traj.py and ops/cuda_layer.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "persistent.cuh"

namespace cg = cooperative_groups;

namespace {

enum Prox { PROX_L1 = 0, PROX_NONNEG_L1 = 1, PROX_BOX = 2, PROX_ELASTIC_NET = 3 };
enum Phase { PHASE_X = 0, PHASE_AX = 1, PHASE_Z = 2 };

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

// -- the persistent trajectory forward --------------------------------------

struct TrajArgs {
  const float *b, *A, *W1, *W2, *th1, *th2, *beta;
  float *tx, *tz, *tlam, *tax;  // stacks; tax is one (S, m) buffer without with_tax
  const float* zeros;           // S * max(n, m) zeros: layer 0's input state
  float* part;                  // split-K partials
  int* cnt;                     // one counter a tile
  int with_tax, S, m, n, K;
  Split sx, sax, sz;            // the x, Ax and z phases' depth splits
};

// One phase of layer k over all its items (l1 prox, as the TPU kernel).
template <int PHASE>
__device__ void traj_phase(const TrajArgs& a, TileSmem& sm, int k) {
  const int S = a.S, m = a.m, n = a.n;
  const size_t sn = (size_t)S * n, smm = (size_t)S * m;
  const int N = PHASE == PHASE_X ? n : m, depth = PHASE == PHASE_AX ? n : m;
  const Split sp = PHASE == PHASE_X ? a.sx : (PHASE == PHASE_AX ? a.sax : a.sz);
  const float beta = fmaxf(__ldg(a.beta + k), 1e-6f), inv_beta = 1.0f / beta;
  const float* x_in = k ? a.tx + (k - 1) * sn : a.zeros;
  const float* z_in = k ? a.tz + (k - 1) * smm : a.zeros;
  const float* lam_in = k ? a.tlam + (k - 1) * smm : a.zeros;
  const float* ax_in = k ? (a.with_tax ? a.tax + (k - 1) * smm : a.tax) : a.zeros;
  float* x = a.tx + k * sn;
  float* ax = a.with_tax ? a.tax + k * smm : a.tax;
  const float* W1 = a.W1 + (size_t)k * n * m;
  const float* W2 = a.W2 + (size_t)k * m * m;
  const float* th = PHASE == PHASE_X ? a.th1 + (size_t)k * n : a.th2 + (size_t)k * m;
  const int ct = dcdiv(N, kT), items = dcdiv(S, kT) * ct * sp.slices;
  const int tid = threadIdx.x, tr = tid / kPC, tc = tid % kPC;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it / sp.slices, s = it % sp.slices;
    const int row0 = tile / ct * kT, col0 = tile % ct * kT;
    const int k_lo = s * sp.len, k_hi = min(depth, k_lo + sp.len);
    float acc[2][2];
    if constexpr (PHASE == PHASE_AX) {
      tile_gemm<true, true>(
          sm, S, m, row0, col0, k_lo, k_hi,
          [&](int r, int q) { return __ldcg(x + (size_t)r * n + q); },
          [&](int c, int q) { return __ldg(a.A + (size_t)c * n + q); }, acc);
    } else {
      // u (x phase) or v (z phase) = Ax + (z - b + lam / beta).
      const float* axo = PHASE == PHASE_X ? ax_in : ax;
      const float* w = PHASE == PHASE_X ? W1 : W2;
      tile_gemm<true, true>(
          sm, S, N, row0, col0, k_lo, k_hi,
          [&](int r, int q) {
            const size_t o = (size_t)r * m + q;
            return __ldcg(axo + o) + ((__ldcg(z_in + o) - __ldg(a.b + o)) + __ldcg(lam_in + o) * inv_beta);
          },
          [&](int c, int q) { return __ldg(w + (size_t)c * m + q); }, acc);
    }
    // The epilogue's inputs do not depend on the sum: they are loaded
    // before the reduction, so that their latency overlaps it.
    float e0[2][2] = {}, e1[2][2] = {}, e2[2][2] = {}, e3[2][2] = {}, thv[2] = {};
    if constexpr (PHASE != PHASE_AX) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (col0 + tc + j * kPC < N) thv[j] = __ldg(th + col0 + tc + j * kPC);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = row0 + tr + i * kPR, c = col0 + tc + j * kPC;
          if (r >= S || c >= N) continue;
          if constexpr (PHASE == PHASE_X) {
            e0[i][j] = __ldcg(x_in + (size_t)r * n + c);
          } else {
            const size_t o = (size_t)r * m + c;
            e0[i][j] = __ldcg(z_in + o);
            e1[i][j] = __ldcg(lam_in + o);
            e2[i][j] = __ldcg(ax + o);
            e3[i][j] = __ldg(a.b + o);
          }
        }
    }
    if (!reduce_slices(sm, acc, a.part, a.cnt, tile, s, sp.slices)) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + tr + i * kPR;
      if (r >= S) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = col0 + tc + j * kPC;
        if (c >= N) continue;
        if constexpr (PHASE == PHASE_X) {
          x[(size_t)r * n + c] = apply_prox<PROX_L1>(e0[i][j] - acc[i][j], thv[j], 1.0f);
        } else if constexpr (PHASE == PHASE_AX) {
          ax[(size_t)r * m + c] = acc[i][j];
        } else {
          const size_t o = (size_t)r * m + c;
          const float z1 = apply_prox<PROX_L1>(e0[i][j] - acc[i][j], thv[j], 1.0f);
          a.tz[k * smm + o] = z1;
          a.tlam[k * smm + o] = e1[i][j] + beta * ((e2[i][j] + z1) - e3[i][j]);
        }
      }
    }
  }
}

// All K layers in one cooperative launch: x, Ax, z phases a layer with a
// grid barrier after each but the last.
__global__ void __launch_bounds__(kPT, 4) traj_persistent(const TrajArgs a) {
  __shared__ TileSmem sm;
  cg::grid_group grid = cg::this_grid();
  for (int k = 0; k < a.K; ++k) {
    traj_phase<PHASE_X>(a, sm, k);
    grid.sync();
    traj_phase<PHASE_AX>(a, sm, k);
    grid.sync();
    traj_phase<PHASE_Z>(a, sm, k);
    if (k + 1 < a.K) grid.sync();
  }
}

// Only grid barriers: their cost on the card (chip_smoke.py).
__global__ void __launch_bounds__(kPT) barrier_probe(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
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

// Blocks of traj_persistent resident on one SM, and the card's SMs: the
// grid ceiling of its cooperative launch (ops/schedule.launch_grid).
extern "C" int dladmm_traj_occupancy(int device, int* blocks_per_sm, int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, traj_persistent, kPT, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

// All K layers of the trajectory forward (l1 prox) as one cooperative
// launch of `grid` blocks on `stream`; no sync. Inputs as
// dladmm_unroll_forward. Outputs the stacks tx (K,S,n), tz (K,S,m),
// tlam (K,S,m) and, with with_tax, tax (K,S,m); without it `tax` is one
// (S,m) scratch buffer. Workspace (ops/schedule.traj_workspace): `zeros`
// of S*max(n,m) floats and `counters` of n_counters ints, both zeroed
// here, and `partials`. sched: the depth slices and their length for the
// x, Ax and z phases. A grid the card cannot hold resident is refused
// (cudaErrorCooperativeLaunchTooLarge) and nothing runs. Returns a
// cudaError_t.
extern "C" int dladmm_unroll_trajectory(
    const float* b, const float* A, const float* W1, const float* W2,
    const float* th1, const float* th2, const float* beta, float* tx,
    float* tz, float* tlam, float* tax, float* zeros, float* partials, int* counters,
    int n_counters, int with_tax, int S, int m, int n, int K, int grid, int x_slices,
    int x_len, int ax_slices, int ax_len, int z_slices, int z_len, int device,
    void* stream_handle) {
  if (S < 1 || m < 1 || n < 1 || K < 1 || grid < 1 || x_len < 1 || ax_len < 1 || z_len < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const size_t sn = (size_t)S * n, sm = (size_t)S * m;
  err = cudaMemsetAsync(zeros, 0, (sn > sm ? sn : sm) * sizeof(float), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(counters, 0, (size_t)n_counters * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;

  TrajArgs a;
  a.b = b;
  a.A = A;
  a.W1 = W1;
  a.W2 = W2;
  a.th1 = th1;
  a.th2 = th2;
  a.beta = beta;
  a.tx = tx;
  a.tz = tz;
  a.tlam = tlam;
  a.tax = tax;
  a.zeros = zeros;
  a.part = partials;
  a.cnt = counters;
  a.with_tax = with_tax;
  a.S = S;
  a.m = m;
  a.n = n;
  a.K = K;
  a.sx = Split{x_slices, x_len};
  a.sax = Split{ax_slices, ax_len};
  a.sz = Split{z_slices, z_len};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)traj_persistent, dim3(grid), dim3(kPT), args, 0, stream);
  if (err != cudaSuccess) cudaGetLastError();  // a refused launch: clear it for later launches' checks
  return (int)err;
}

// `iters` grid barriers in one cooperative launch of `grid` blocks.
extern "C" int dladmm_grid_barrier_probe(int grid, int iters, int device, void* stream_handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&iters};
  err = cudaLaunchCooperativeKernel((const void*)barrier_probe, dim3(grid), dim3(kPT), args, 0,
                                    static_cast<cudaStream_t>(stream_handle));
  if (err != cudaSuccess) cudaGetLastError();  // a refused launch: clear it for later launches' checks
  return (int)err;
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
