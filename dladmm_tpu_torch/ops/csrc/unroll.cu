// Whole-unroll D-LADMM for Hopper (sm_90a), fp32 arithmetic throughout:
// the inference forward, the per-layer step and the trajectory forward
// of training, each one persistent cooperative launch. All three also
// take bf16 storage (below).
//
// dladmm_unroll_forward replaces the TPU kernel
// dladmm_tpu/ops/pallas_unroll.py:_unroll_kernel (driven by
// _unrolled_forward_pallas): K layers from zero state to the final
// state, with an elementwise prox (l1, nonneg_l1, box, elastic_net) on
// the x and z updates. dladmm_layer_step replaces
// dladmm_tpu/ops/pallas_layer.py:_layer_kernel (driven by _fused_forward):
// ONE l1 layer from a given state (x, z, lam, b, Ax) into fresh buffers
// (x1, z1, lam1, Ax1), its products in fp32 or with both operands
// rounded to bf16 as they are staged (fp32 accumulation either way). Both
// run unroll_persistent. dladmm_unroll_trajectory replaces
// _unroll_traj_kernel (driven by _traj_pallas): the same recurrence with
// the l1 prox, writing every layer's state into (K, S, .) stacks tx, tz,
// tlam and, for the manual backward, tAx (traj_persistent). For layer k,
// with beta = max(beta_k, 1e-6) and theta clamped at >= 0 where it is
// used:
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
// the previous one. So one cooperative launch runs all K layers' phases
// with a grid-wide barrier between dependent phases (3K - 1 a call).
// Each phase is a tiled fp32 GEMM with the elementwise work fused in:
// the x and z phases build their operand (u or v) from the state while
// they stage it into shared memory, and their epilogues apply the prox
// (and the dual update). Nothing but the state (x, z, lam, Ax) ever goes
// to device memory. Accumulation is fp32 FMA (no TF32, no tensor cores).
// Where a phase has few output tiles (synthetic_small at every serving
// bucket, and training's S = 64: 16-128 tiles of 32 x 32), it also cuts
// its depth into slices (the split is computed by ops/schedule.py and
// passed in): tiles x slices work items spread the phase over the grid,
// blocks loop over items, and large S (more tiles than blocks) needs no
// split. A sliced item writes a partial tile to the workspace; the last
// block to finish a tile (counted by an integer atomic per tile, reset
// by that block) sums the partials in slice order and runs the epilogue.
// No float atomics, so a call repeats bit for bit on one card. Each
// block keeps the next depth step's loads in flight (registers) while it
// computes the current one from the other half of a double-buffered
// shared-memory tile; 4-byte loads (rows of m = 250 floats are 8-byte
// aligned, so no 16-byte copy or TMA descriptor). A two- or three-stage
// cp.async pipeline for the weights was measured slower on the H100: it
// costs registers, and so resident blocks where the grid is the
// occupancy (PERF.md). The 32 x 32 tile's kernels are held at 64
// registers, 4 blocks a SM (__launch_bounds__(kPT, 4)). The serving
// kernel also has a wide 128 x 128 tile (wide_tile.cuh: 8 x 8 outputs a
// thread from 16-byte shared-memory reads, operands staged 16 bytes at a
// time with cp.async in a 3-stage ring, one block a SM), which the
// serving plan takes where m and n suit its 16-byte staging and its
// tiles are whole (synthetic_large). Its x and z phases read u and v as
// plain matrices that the epilogues write once a layer (below). The fp32
// trajectory has the same wide tile (traj_persistent<kWT, float>), which
// runs the serving kernel's wide phases on a view of each layer's stack
// slices (traj_layer), where the serving kernel's rule takes it
// (ops/schedule tile_edge); bf16 storage keeps the trajectory on the 32
// tile. At
// synthetic_small all layers' W1 + W2 plus A (11.75 MB) stay in the 50 MB
// L2.
//
// bf16 storage. dladmm_unroll_forward_bf16 and dladmm_layer_step_bf16
// (unroll_persistent<T, BF16, __nv_bfloat16>) replace _unroll_kernel and
// _layer_kernel on bf16 refs (serve --dtype=bfloat16; the layer step on
// bf16 state), and keep their rule: b, A, W1, W2 and the thresholds (and
// beta, or an fp32 beta) are read as bf16 and widened exactly; the layer
// runs in fp32 in the order above; only its four stores round to nearest
// (x1, z1, lam1, Ax1). Within a layer the Ax phase reads the unrounded
// x1, and v and the dual update the unrounded Ax1; the next layer reads
// the rounded values. So x and Ax stay in fp32 buffers of the workspace
// and are rounded where the next layer reads them (layer k > 0), which
// equals reading a bf16 store; z and lam are stored as bf16 at once (only
// the next layer reads them); the last layer also writes x (and the
// step its Ax) as bf16 outputs. The products stay fp32 FMA on the CUDA
// cores: a bf16 tensor-core product would round the fp32 operand (u, x1
// or v) and change the result (splitting it into two bf16 halves for
// wgmma is an open question, PERF.md §7). bf16 storage halves the bytes
// of the weights (W1 + W2 + A: 375 KB a layer at synthetic_small, 12 MB
// at synthetic_large) but not the flops, which bound the call.
//
// bf16 trajectory. dladmm_unroll_trajectory_bf16 (traj_persistent on
// __nv_bfloat16) replaces _unroll_traj_kernel on bf16 refs (bf16
// training) and keeps its rule, which is not the serving rule above: the
// JAX kernel carries x, z, lam and Ax in fp32 scratch from layer to layer
// and rounds only the stack stores. So the state lives in fp32 buffers of
// the workspace (x and Ax in place, as the serving forward keeps them; z
// and lam in two pairs, layer k writing pair k & 1, for the race noted
// below), no layer reads the rounded stacks, and each epilogue writes the
// fp32 state and the bf16 stack. Its plain version is
// ops/cuda_traj.trajectory_forward_plain_bf16 (the fp32 trajectory of the
// widened inputs, rounded).
//
// Bound. Per call the work is 2*S*m*(2n+d)*K flops and the bytes are
// K layers of W1/W2, A, b and the outputs (K times the state for the
// trajectory); at the shapes the serving and training paths run
// (S <= 1024) the flops dominate, so the bound is the fp32 CUDA-core
// rate. At small S these kernels are bound instead by their 3K - 1
// barriers and their serial depth (PERF.md).
//
// Races. The z phase's operand reads the OLD z and lam across all m
// columns in every block, so z1 and lam1 never overwrite them: the
// serving forward swaps two buffer pairs per layer (the last layer
// writes the output pair), the trajectory writes the next slice of its
// stacks. The x phase reads x_in only in its epilogue, one element per
// thread of the tile's last block, so the serving forward updates x in
// place; its operand reads Ax_in, which the Ax phase of the same layer
// overwrites only after the barrier that ends the x phase, so Ax is
// updated in place too. With bf16 storage these are the fp32 x and Ax
// buffers, under the same rule: the x epilogue rounds the old element
// it then overwrites with the unrounded x1; the Ax phase reads whole rows
// of x1 after the x phase's barrier, the z phase Ax1 after the Ax
// phase's; the bf16 x output is written by the last layer and read by
// nobody in the call. The trajectory without tAx keeps one Ax scratch
// buffer under the same rule. The layer step reads the caller's state
// and writes fresh buffers (on bf16 state its x1 and Ax1 also go to the
// fp32 buffers, which the Ax and z phases read). State written in the
// call is read with __ldcg (L2, never a stale L1 line); the weights with
// __ldg. Layer 0 of the serving forward reads the zero state through a
// block-uniform branch, so nothing is cleared before the launch but the
// counters.
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/ops/cuda_unroll.py,
// ops/cuda_traj.py and ops/cuda_layer.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "persistent.cuh"
#include "wide_tile.cuh"

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

// The prox by its runtime index (enum Prox), block-uniform: only the
// serving kernel's epilogues read it, so one instantiation serves all
// sixteen (prox_x, prox_z) pairs.
__device__ __forceinline__ float prox_of(int p, float u, float theta, float scale) {
  switch (p) {
    case PROX_NONNEG_L1: return apply_prox<PROX_NONNEG_L1>(u, theta, scale);
    case PROX_BOX: return apply_prox<PROX_BOX>(u, theta, scale);
    case PROX_ELASTIC_NET: return apply_prox<PROX_ELASTIC_NET>(u, theta, scale);
    default: return apply_prox<PROX_L1>(u, theta, scale);
  }
}

// Storage types of the kernels' weights, b, thresholds and stored state:
// float, or __nv_bfloat16 (bf16 storage, fp32 arithmetic: every value is
// widened exactly where it is read and rounded to nearest only where it
// is stored).
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// v as a bf16 store would hold it.
__device__ __forceinline__ float rounded(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// -- the persistent trajectory forward --------------------------------------

template <class TS>
struct TrajArgs {
  const TS *b, *A, *W1, *W2, *th1, *th2;
  const float* beta;            // (K,) fp32, or null where beta16 is given
  const __nv_bfloat16* beta16;  // (K,) bf16 (bf16 storage only), or null
  TS *tx, *tz, *tlam, *tax;     // stacks; fp32: tax is one (S, m) buffer without with_tax
  const float* zeros;           // S * max(n, m) zeros: layer 0's input state
  // bf16 storage: the fp32 state between the phases, never rounded: x
  // (S, n) and Ax (S, m) in place, z and lam (S, m) in two pairs (layer k
  // writes pair k & 1). Null for fp32, whose state is its stacks.
  float *xw, *axw, *zw[2], *lamw[2];
  float* part;                  // split-K partials
  int* cnt;                     // one counter a tile
  int with_tax, S, m, n, K;
  Split sx, sax, sz;            // the x, Ax and z phases' depth splits
  float *u, *v;                 // wide tile: the x and z phases' operands (S, m), fp32; else null
};

// One phase of layer k over all its items (l1 prox, as the TPU kernel).
// fp32 storage reads layer k's input state from slice k-1 of the stacks.
// bf16 storage keeps the state in fp32 (TrajArgs::xw ...) and rounds only
// the stack stores: the rule of _unroll_traj_kernel on bf16 refs, whose
// state lives in fp32 scratch (its stacks are rounded copies of it).
template <int PHASE, class TS>
__device__ void traj_phase(const TrajArgs<TS>& a, TileSmem& sm, int k) {
  constexpr bool S16 = sizeof(TS) == 2;
  const int S = a.S, m = a.m, n = a.n;
  const size_t sn = (size_t)S * n, smm = (size_t)S * m;
  const int N = PHASE == PHASE_X ? n : m, depth = PHASE == PHASE_AX ? n : m;
  const Split sp = PHASE == PHASE_X ? a.sx : (PHASE == PHASE_AX ? a.sax : a.sz);
  float beta_k;
  if constexpr (S16) {
    beta_k = a.beta16 ? __bfloat162float(a.beta16[k]) : __ldg(a.beta + k);
  } else {
    beta_k = __ldg(a.beta + k);
  }
  const float beta = fmaxf(beta_k, 1e-6f), inv_beta = 1.0f / beta;
  const float *x_in, *z_in, *lam_in, *ax_in;
  float *x, *ax, *z_out, *lam_out;
  if constexpr (S16) {
    x_in = k ? a.xw : a.zeros;
    z_in = k ? a.zw[(k - 1) & 1] : a.zeros;
    lam_in = k ? a.lamw[(k - 1) & 1] : a.zeros;
    ax_in = k ? a.axw : a.zeros;
    x = a.xw;
    ax = a.axw;
    z_out = a.zw[k & 1];
    lam_out = a.lamw[k & 1];
  } else {
    x_in = k ? a.tx + (k - 1) * sn : a.zeros;
    z_in = k ? a.tz + (k - 1) * smm : a.zeros;
    lam_in = k ? a.tlam + (k - 1) * smm : a.zeros;
    ax_in = k ? (a.with_tax ? a.tax + (k - 1) * smm : a.tax) : a.zeros;
    x = a.tx + k * sn;
    ax = a.with_tax ? a.tax + k * smm : a.tax;
    z_out = a.tz + k * smm;
    lam_out = a.tlam + k * smm;
  }
  const TS* W1 = a.W1 + (size_t)k * n * m;
  const TS* W2 = a.W2 + (size_t)k * m * m;
  const TS* th = PHASE == PHASE_X ? a.th1 + (size_t)k * n : a.th2 + (size_t)k * m;
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
          [&](int c, int q) { return ldg(a.A + (size_t)c * n + q); }, acc);
    } else {
      // u (x phase) or v (z phase) = Ax + (z - b + lam / beta).
      const float* axo = PHASE == PHASE_X ? ax_in : ax;
      const TS* w = PHASE == PHASE_X ? W1 : W2;
      tile_gemm<true, true>(
          sm, S, N, row0, col0, k_lo, k_hi,
          [&](int r, int q) {
            const size_t o = (size_t)r * m + q;
            return __ldcg(axo + o) + ((__ldcg(z_in + o) - ldg(a.b + o)) + __ldcg(lam_in + o) * inv_beta);
          },
          [&](int c, int q) { return ldg(w + (size_t)c * m + q); }, acc);
    }
    // The epilogue's inputs do not depend on the sum: they are loaded
    // before the reduction, so that their latency overlaps it.
    float e0[2][2] = {}, e1[2][2] = {}, e2[2][2] = {}, e3[2][2] = {}, thv[2] = {};
    if constexpr (PHASE != PHASE_AX) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (col0 + tc + j * kPC < N) thv[j] = ldg(th + col0 + tc + j * kPC);
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
            e3[i][j] = ldg(a.b + o);
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
          const size_t o = (size_t)r * n + c;
          const float x1 = apply_prox<PROX_L1>(e0[i][j] - acc[i][j], thv[j], 1.0f);
          x[o] = x1;
          if constexpr (S16) put(a.tx + k * sn + o, x1);
        } else if constexpr (PHASE == PHASE_AX) {
          const size_t o = (size_t)r * m + c;
          ax[o] = acc[i][j];
          if constexpr (S16) {
            if (a.with_tax) put(a.tax + k * smm + o, acc[i][j]);
          }
        } else {
          const size_t o = (size_t)r * m + c;
          const float z1 = apply_prox<PROX_L1>(e0[i][j] - acc[i][j], thv[j], 1.0f);
          const float lam1 = e1[i][j] + beta * ((e2[i][j] + z1) - e3[i][j]);
          z_out[o] = z1;
          lam_out[o] = lam1;
          if constexpr (S16) {
            put(a.tz + k * smm + o, z1);
            put(a.tlam + k * smm + o, lam1);
          }
        }
      }
    }
  }
}

// -- the persistent serving forward and layer step -------------------------

template <class TS>
struct ServeArgs {
  const TS *b, *A, *W1, *W2, *th1, *th2;
  const float* beta;                // (K,) fp32, or null where beta16 is given
  const __nv_bfloat16* beta16;      // (K,) bf16 (bf16 storage only), or null
  int th1_k, th1_c, th2_k, th2_c;   // threshold strides (layer, column); column 0: a (K, 1) scalar
  // Layer 0's input state: the layer step's (x, z, lam, Ax); all null
  // for the serving forward, whose layer 0 reads the zero state.
  const TS *x0, *z0, *lam0, *ax0;
  float *x, *ax;                    // x and Ax after each layer, fp32 and unrounded, in place from layer 1 on
  TS *xo, *axo;                     // bf16 storage: x of the last layer and (the step) its Ax, rounded; else null
  TS *z[2], *lam[2];                // layer k writes pair (K - 1 - k) & 1: the last, pair 0
  float* part;                      // split-K partials
  int* cnt;                         // one counter a tile
  int S, m, n, K, prox_x, prox_z;
  float scale_x, scale_z;           // elastic net 1 / (1 + rho); 1 otherwise
  Split sx, sax, sz;                // the x, Ax and z phases' depth splits
  float *u, *v;                     // wide tile: the x and z phases' operands (S, m), fp32; else null
};

// One phase of layer k over all its items on T x T tiles. With bf16
// storage (TS = __nv_bfloat16) the x and Ax the previous layer left in
// the fp32 buffers are read rounded, as that layer stored them; this
// layer's Ax1 feeds v and the dual update unrounded, and x1 the Ax
// product.
template <int PHASE, int T, bool BF16, class TS>
__device__ void serve_phase(const ServeArgs<TS>& a, TileSmemT<T>& sm, int k) {
  constexpr int TM = T / kPR, TN = T / kPC;
  constexpr bool S16 = sizeof(TS) == 2;
  const int S = a.S, m = a.m, n = a.n;
  const int N = PHASE == PHASE_X ? n : m, depth = PHASE == PHASE_AX ? n : m;
  const Split sp = PHASE == PHASE_X ? a.sx : (PHASE == PHASE_AX ? a.sax : a.sz);
  const float beta = fmaxf(a.beta16 ? __bfloat162float(a.beta16[k]) : __ldg(a.beta + k), 1e-6f);
  const float inv_beta = 1.0f / beta;
  const TS* z_in = k ? ((a.K - k) & 1 ? a.z[1] : a.z[0]) : a.z0;
  const TS* lam_in = k ? ((a.K - k) & 1 ? a.lam[1] : a.lam[0]) : a.lam0;
  const bool zero = k == 0 && a.x0 == nullptr;  // the zero state (serving, layer 0)
  // The previous layer's x or Ax as it stored them (layer 0: the input).
  auto state = [&](const float* p, const TS* p0, size_t o) {
    if (k == 0) return ldcg(p0 + o);
    const float v = __ldcg(p + o);
    return S16 ? rounded(v) : v;
  };
  const TS* w = PHASE == PHASE_X ? a.W1 + (size_t)k * n * m : a.W2 + (size_t)k * m * m;
  const TS* th = PHASE == PHASE_X ? a.th1 + (size_t)k * a.th1_k : a.th2 + (size_t)k * a.th2_k;
  const int th_c = PHASE == PHASE_X ? a.th1_c : a.th2_c;
  const int prox = PHASE == PHASE_X ? a.prox_x : a.prox_z;
  const float scale = PHASE == PHASE_X ? a.scale_x : a.scale_z;
  const int ct = dcdiv(N, T), items = dcdiv(S, T) * ct * sp.slices;
  const int tid = threadIdx.x, tr = tid / kPC, tc = tid % kPC;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it / sp.slices, s = it % sp.slices;
    const int row0 = tile / ct * T, col0 = tile % ct * T;
    const int k_lo = s * sp.len, k_hi = min(depth, k_lo + sp.len);
    float acc[TM][TN];
    if constexpr (PHASE == PHASE_AX) {
      tile_gemm<true, true, T, BF16>(
          sm, S, m, row0, col0, k_lo, k_hi,
          [&](int r, int q) { return __ldcg(a.x + (size_t)r * n + q); },
          [&](int c, int q) { return ldg(a.A + (size_t)c * n + q); }, acc);
    } else {
      // u (x phase) or v (z phase) = Ax + (z - b + lam / beta).
      tile_gemm<true, true, T, BF16>(
          sm, S, N, row0, col0, k_lo, k_hi,
          [&](int r, int q) {
            const size_t o = (size_t)r * m + q;
            float zi = 0.0f, li = 0.0f, ai = 0.0f;
            if (!zero) {
              zi = ldcg(z_in + o);
              li = ldcg(lam_in + o);
            }
            if (PHASE == PHASE_Z) {
              ai = __ldcg(a.ax + o);
            } else if (!zero) {
              ai = state(a.ax, a.ax0, o);
            }
            return ai + ((zi - ldg(a.b + o)) + li * inv_beta);
          },
          [&](int c, int q) { return ldg(w + (size_t)c * m + q); }, acc);
    }
    // The epilogue: its inputs e (x_in; or z_in, lam_in, Ax, b) and the
    // column's threshold do not depend on the sum, so they are loaded
    // before the reduction, so that their latency overlaps it.
    auto inputs = [&](int i, int j, float (&e)[4]) {
      const int r = row0 + tr + i * kPR, c = col0 + tc + j * kPC;
      e[0] = e[1] = e[2] = e[3] = 0.0f;
      if (r >= S || c >= N) return;
      if constexpr (PHASE == PHASE_X) {
        if (!zero) e[0] = state(a.x, a.x0, (size_t)r * n + c);
      } else if constexpr (PHASE == PHASE_Z) {
        const size_t o = (size_t)r * m + c;
        if (!zero) {
          e[0] = ldcg(z_in + o);
          e[1] = ldcg(lam_in + o);
        }
        e[2] = __ldcg(a.ax + o);
        e[3] = ldg(a.b + o);
      }
    };
    auto theta = [&](int j) {
      const int c = col0 + tc + j * kPC;
      return PHASE != PHASE_AX && c < N ? ldg(th + (size_t)c * th_c) : 0.0f;
    };
    auto output = [&](int i, int j, const float (&e)[4], float sum, float t) {
      const int r = row0 + tr + i * kPR, c = col0 + tc + j * kPC;
      if (r >= S || c >= N) return;
      if constexpr (PHASE == PHASE_X) {
        const size_t o = (size_t)r * n + c;
        const float x1 = prox_of(prox, e[0] - sum, t, scale);
        a.x[o] = x1;
        if constexpr (S16) {
          if (k + 1 == a.K) put(a.xo + o, x1);
        }
      } else if constexpr (PHASE == PHASE_AX) {
        const size_t o = (size_t)r * m + c;
        a.ax[o] = sum;
        if constexpr (S16) {
          if (a.axo != nullptr) put(a.axo + o, sum);
        }
      } else {
        const size_t o = (size_t)r * m + c;
        const float z1 = prox_of(prox, e[0] - sum, t, scale);
        const float lam1 = e[1] + beta * ((e[2] + z1) - e[3]);
        TS* zo = (a.K - 1 - k) & 1 ? a.z[1] : a.z[0];
        TS* lo = (a.K - 1 - k) & 1 ? a.lam[1] : a.lam[0];
        put(zo + o, z1);
        put(lo + o, lam1);
      }
    };
    float e[TM][TN][4], thv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) thv[j] = theta(j);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) inputs(i, j, e[i][j]);
    if (!reduce_slices<T>(sm, acc, a.part, a.cnt, tile, s, sp.slices)) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) output(i, j, e[i][j], acc[i][j], thv[j]);
  }
}

// -- the wide tile (wide_tile.cuh) -------------------------------------------
//
// The x and z phases' operands u and v are plain (S, m) fp32 matrices in
// the workspace, written once a layer by the epilogue that has their
// inputs, and not rebuilt by every column tile's staging: layer 0's u by
// a first elementwise phase (one grid barrier more than the 32 tile's,
// as the int8 kernel's), v = Ax1 + base by the Ax epilogue, the next
// layer's u = Ax1 + (z1 - b + lam1 / beta_{k+1}) by the z epilogue. Each
// element is the 32 tile's operand expression in its order, on the values
// the next reader would load (rounded as stored, with bf16 storage), so
// it has the same bits. u and v are two buffers: the z phase reads all of
// v in every block while its epilogue writes the next u.

__device__ __forceinline__ F4 rounded4(F4 f) {
#pragma unroll
  for (int q = 0; q < 4; ++q) f.v[q] = rounded(f.v[q]);
  return f;
}

// u for layer 0: Ax0 + ((z0 - b) + lam0 / beta_0), the zero state for
// the serving forward.
template <class TS>
__device__ void wide_u0(const ServeArgs<TS>& a) {
  const float inv_beta = 1.0f / fmaxf(a.beta16 ? __bfloat162float(a.beta16[0]) : __ldg(a.beta), 1e-6f);
  const bool zero = a.x0 == nullptr;
  const size_t total = (size_t)a.S * a.m;  // a multiple of 4 (wide_layout)
  for (size_t o = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4; o < total;
       o += (size_t)gridDim.x * blockDim.x * 4) {
    float zi[4] = {}, li[4] = {}, ai[4] = {}, bi[4];  // four elements' loads, then their stores
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!zero) {
        zi[q] = ldcg(a.z0 + o + q);
        li[q] = ldcg(a.lam0 + o + q);
        ai[q] = ldcg(a.ax0 + o + q);
      }
      bi[q] = ldg(a.b + o + q);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) a.u[o + q] = ai[q] + ((zi[q] - bi[q]) + li[q] * inv_beta);
  }
}

// One phase of layer k over all its items on 128 x 128 tiles: the
// mainloop of wide_tile.cuh on the phase's operand (u, x1 or v) and
// weight, then serve_phase's epilogue, four outputs of a row at a time,
// plus the operand the next phase reads (v after Ax, the next layer's u
// after z).
template <int PHASE, bool BF16, class TS>
__device__ void wide_phase(const ServeArgs<TS>& a, unsigned char* smem, int& last, int k) {
  constexpr bool S16 = sizeof(TS) == 2;
  const int S = a.S, m = a.m, n = a.n;
  const int N = PHASE == PHASE_X ? n : m, depth = PHASE == PHASE_AX ? n : m;
  const Split sp = PHASE == PHASE_X ? a.sx : (PHASE == PHASE_AX ? a.sax : a.sz);
  auto beta_of = [&](int j) { return fmaxf(a.beta16 ? __bfloat162float(a.beta16[j]) : __ldg(a.beta + j), 1e-6f); };
  const float beta = beta_of(k), inv_beta = 1.0f / beta;
  const float inv_beta_next = PHASE == PHASE_Z && k + 1 < a.K ? 1.0f / beta_of(k + 1) : 0.0f;
  const TS* z_in = k ? ((a.K - k) & 1 ? a.z[1] : a.z[0]) : a.z0;
  const TS* lam_in = k ? ((a.K - k) & 1 ? a.lam[1] : a.lam[0]) : a.lam0;
  const bool zero = k == 0 && a.x0 == nullptr;  // the zero state (serving, layer 0)
  const TS* w = PHASE == PHASE_X ? a.W1 + (size_t)k * n * m : (PHASE == PHASE_AX ? a.A : a.W2 + (size_t)k * m * m);
  const float* op = PHASE == PHASE_X ? a.u : (PHASE == PHASE_AX ? a.x : a.v);
  const TS* th = PHASE == PHASE_X ? a.th1 + (size_t)k * a.th1_k : a.th2 + (size_t)k * a.th2_k;
  const int th_c = PHASE == PHASE_X ? a.th1_c : a.th2_c;
  const int prox = PHASE == PHASE_X ? a.prox_x : a.prox_z;
  const float scale = PHASE == PHASE_X ? a.scale_x : a.scale_z;
  const int ct = dcdiv(N, kWT), items = dcdiv(S, kWT) * ct * sp.slices;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it / sp.slices, s = it % sp.slices;
    const int row0 = tile / ct * kWT, col0 = tile % ct * kWT;
    const int k_lo = s * sp.len, k_hi = min(depth, k_lo + sp.len);
    float acc[8][8];
    wide_gemm<BF16>(smem, S, N, row0, col0, k_lo, k_hi, op, depth, w, depth, acc);
    if (!wide_reduce(acc, a.part, a.cnt, tile, s, sp.slices, last)) continue;
    // The epilogue. The tile goes through shared memory (the ring is
    // free now), so that each warp then handles whole rows of it: a lane
    // takes 4 neighbouring columns, with 16-byte loads and stores, and
    // loads the inputs of 4 rows before it stores any (a store may alias
    // a later load, so the compiler would otherwise wait out one load
    // after another).
    float* ts = reinterpret_cast<float*>(smem);
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) ts[(ty + 16 * i) * kWTP + tx + 16 * j] = acc[i][j];
    __syncthreads();
    const int c = col0 + 4 * lane;  // N is a multiple of 4 (wide_layout)
    if (c < N) {
      float t[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) t[q] = PHASE != PHASE_AX ? ldg(th + (size_t)(c + q) * th_c) : 0.0f;
      constexpr int B = 4, NIN = PHASE == PHASE_X ? 1 : 4;  // rows a batch, inputs a row
#pragma unroll
      for (int r0 = 0; r0 < kWT / 8; r0 += B) {
        F4 e[B][NIN];  // [row][input]: x_in; or z_in, lam_in, Ax, b
#pragma unroll
        for (int h = 0; h < B; ++h) {
          const int r = row0 + warp + 8 * (r0 + h);
#pragma unroll
          for (int q = 0; q < NIN; ++q) e[h][q] = F4{};
          if (r >= S) continue;
          if constexpr (PHASE == PHASE_X) {
            const size_t o = (size_t)r * n + c;
            if (!zero) e[h][0] = k == 0 ? ld4cg(a.x0 + o) : (S16 ? rounded4(ld4cg(a.x + o)) : ld4cg(a.x + o));
          } else {
            const size_t o = (size_t)r * m + c;
            if (!zero) {
              e[h][0] = ld4cg(z_in + o);
              e[h][1] = ld4cg(lam_in + o);
            }
            e[h][NIN - 1] = ld4g(a.b + o);
            if constexpr (PHASE == PHASE_Z) e[h][2] = ld4cg(a.ax + o);
          }
        }
#pragma unroll
        for (int h = 0; h < B; ++h) {
          const int rr = warp + 8 * (r0 + h), r = row0 + rr;
          if (r >= S) continue;
          const float4 sum4 = *reinterpret_cast<const float4*>(ts + rr * kWTP + 4 * lane);
          const float sum[4] = {sum4.x, sum4.y, sum4.z, sum4.w};
          if constexpr (PHASE == PHASE_X) {
            const size_t o = (size_t)r * n + c;
            F4 x1;
#pragma unroll
            for (int q = 0; q < 4; ++q) x1.v[q] = prox_of(prox, e[h][0].v[q] - sum[q], t[q], scale);
            st4(a.x + o, x1);
            if constexpr (S16) {
              if (k + 1 == a.K) st4(a.xo + o, x1);
            }
          } else if constexpr (PHASE == PHASE_AX) {
            const size_t o = (size_t)r * m + c;
            F4 ax1, v;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              ax1.v[q] = sum[q];
              v.v[q] = sum[q] + ((e[h][0].v[q] - e[h][NIN - 1].v[q]) + e[h][1].v[q] * inv_beta);
            }
            st4(a.ax + o, ax1);
            if constexpr (S16) {
              if (a.axo != nullptr) st4(a.axo + o, ax1);
            }
            st4(a.v + o, v);
          } else {
            const size_t o = (size_t)r * m + c;
            F4 z1, lam1, u;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              z1.v[q] = prox_of(prox, e[h][0].v[q] - sum[q], t[q], scale);
              lam1.v[q] = e[h][1].v[q] + beta * ((e[h][2].v[q] + z1.v[q]) - e[h][NIN - 1].v[q]);
              // the next layer's u, from its inputs as stored
              const float ai = S16 ? rounded(e[h][2].v[q]) : e[h][2].v[q];
              const float zn = S16 ? rounded(z1.v[q]) : z1.v[q], ln = S16 ? rounded(lam1.v[q]) : lam1.v[q];
              u.v[q] = ai + ((zn - e[h][NIN - 1].v[q]) + ln * inv_beta_next);
            }
            st4(((a.K - 1 - k) & 1 ? a.z[1] : a.z[0]) + o, z1);
            st4(((a.K - 1 - k) & 1 ? a.lam[1] : a.lam[0]) + o, lam1);
            if (k + 1 < a.K) st4(a.u + o, u);
          }
        }
      }
    }
  }
}

// All K layers in one cooperative launch: x, Ax, z phases a layer with a
// grid barrier after each but the last. The 32 tile keeps the
// trajectory's 4 blocks a SM. The wide tile runs one block a SM: its
// 8 x 8 outputs a thread take up to 255 registers (held to 128 for two
// blocks a SM, it spilled and ran 7-8% slower, PERF.md); its ring is
// dynamic shared memory (wide_smem_bytes), and it writes layer 0's u
// first, behind one barrier more.
template <int T, bool BF16, class TS>
__global__ void __launch_bounds__(kPT, T == kT ? 4 : 1) unroll_persistent(const ServeArgs<TS> a) {
  cg::grid_group grid = cg::this_grid();
  if constexpr (T == kT) {
    __shared__ TileSmemT<T> sm;
    for (int k = 0; k < a.K; ++k) {
      serve_phase<PHASE_X, T, BF16, TS>(a, sm, k);
      grid.sync();
      serve_phase<PHASE_AX, T, BF16, TS>(a, sm, k);
      grid.sync();
      serve_phase<PHASE_Z, T, BF16, TS>(a, sm, k);
      if (k + 1 < a.K) grid.sync();
    }
  } else {
    extern __shared__ __align__(16) unsigned char wide_smem[];
    __shared__ int last;
    wide_u0(a);
    grid.sync();
    for (int k = 0; k < a.K; ++k) {
      wide_phase<PHASE_X, BF16, TS>(a, wide_smem, last, k);
      grid.sync();
      wide_phase<PHASE_AX, BF16, TS>(a, wide_smem, last, k);
      grid.sync();
      wide_phase<PHASE_Z, BF16, TS>(a, wide_smem, last, k);
      if (k + 1 < a.K) grid.sync();
    }
  }
}

// -- the trajectory forward ---------------------------------------------------
//
// Layer k of the fp32 trajectory as the serving kernel's wide phases see
// the first layer of a call: a layer step from slice k - 1 of the stacks
// (layer 0: the zero state) into slice k, with K - k layers left, so that
// its z epilogue also writes the next layer's u. The trajectory's wide
// tile runs wide_u0 and wide_phase on this view, unchanged: its x1, Ax1,
// v, z1, lam1 and u are the serving kernel's expressions, which are the
// 32 tile's (traj_phase's) in their order.
__host__ __device__ inline ServeArgs<float> traj_layer(const TrajArgs<float>& a, int k) {
  const size_t sn = (size_t)a.S * a.n, smm = (size_t)a.S * a.m;
  float *x = a.tx + k * sn, *z = a.tz + k * smm, *lam = a.tlam + k * smm;
  float* ax = a.with_tax ? a.tax + k * smm : a.tax;  // without tAx one buffer, in place (Races)
  return ServeArgs<float>{a.b, a.A, a.W1 + (size_t)k * a.n * a.m, a.W2 + (size_t)k * a.m * a.m,
                          a.th1 + (size_t)k * a.n, a.th2 + (size_t)k * a.m, a.beta + k, nullptr, 0, 1, 0, 1,
                          k ? x - sn : nullptr, k ? z - smm : nullptr, k ? lam - smm : nullptr,
                          k ? (a.with_tax ? ax - smm : ax) : nullptr,  // null: the zero state
                          x, ax, nullptr, nullptr, {z, z}, {lam, lam}, a.part, a.cnt,
                          a.S, a.m, a.n, a.K - k, PROX_L1, PROX_L1, 1.0f, 1.0f, a.sx, a.sax, a.sz, a.u, a.v};
}

// All K layers in one cooperative launch: x, Ax, z phases a layer with a
// grid barrier after each but the last. The 32 tile (either storage) at 4
// blocks a SM; the wide tile (fp32 storage) at one block a SM, its ring in
// dynamic shared memory, layer 0's u first, behind one barrier more, as
// unroll_persistent's.
template <int T, class TS>
__global__ void __launch_bounds__(kPT, T == kT ? 4 : 1) traj_persistent(const TrajArgs<TS> a) {
  cg::grid_group grid = cg::this_grid();
  if constexpr (T == kT) {
    __shared__ TileSmem sm;
    for (int k = 0; k < a.K; ++k) {
      traj_phase<PHASE_X, TS>(a, sm, k);
      grid.sync();
      traj_phase<PHASE_AX, TS>(a, sm, k);
      grid.sync();
      traj_phase<PHASE_Z, TS>(a, sm, k);
      if (k + 1 < a.K) grid.sync();
    }
  } else {
    extern __shared__ __align__(16) unsigned char wide_smem[];
    __shared__ int last;
    wide_u0(traj_layer(a, 0));
    grid.sync();
    for (int k = 0; k < a.K; ++k) {
      const ServeArgs<float> l = traj_layer(a, k);
      wide_phase<PHASE_X, false, float>(l, wide_smem, last, 0);
      grid.sync();
      wide_phase<PHASE_AX, false, float>(l, wide_smem, last, 0);
      grid.sync();
      wide_phase<PHASE_Z, false, float>(l, wide_smem, last, 0);
      if (k + 1 < a.K) grid.sync();
    }
  }
}

// A wide-tile instantiation `fn` with its ceiling of dynamic shared
// memory raised to its ring (`smem`), or null where that is refused.
template <class TS>
const void* wide_kernel(const void* fn, int* smem) {
  *smem = wide_smem_bytes<TS>();
  return with_smem(fn, *smem);
}

// The instantiation of a tile edge (32 or kWT), staging and storage, or
// null; its dynamic shared memory in `smem`, with the kernel's ceiling
// raised to it.
template <class TS>
const void* serve_kernel(int tile, int bf16, int* smem) {
  *smem = 0;
  if (tile == kT) return bf16 ? (const void*)unroll_persistent<kT, true, TS> : (const void*)unroll_persistent<kT, false, TS>;
  if (tile == kWT)
    return wide_kernel<TS>(bf16 ? (const void*)unroll_persistent<kWT, true, TS> : (const void*)unroll_persistent<kWT, false, TS>,
                           smem);
  return nullptr;
}

// The trajectory's instantiation of a tile edge: 32 for either storage,
// kWT for fp32 storage only (bf16 keeps the 32 tile); else null.
template <class TS>
const void* traj_kernel(int tile, int* smem) {
  *smem = 0;
  if (tile == kT) return (const void*)traj_persistent<kT, TS>;
  if constexpr (sizeof(TS) == 4) {
    if (tile == kWT) return wide_kernel<TS>((const void*)traj_persistent<kWT, TS>, smem);
  }
  return nullptr;
}

const void* serve_kernel(int tile, int bf16, int storage, int* smem) {
  if (storage == 0) return serve_kernel<float>(tile, bf16, smem);
  if (storage == 1) return serve_kernel<__nv_bfloat16>(tile, bf16, smem);
  return nullptr;
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// The wide tile's layout rules (ops/schedule.tile_edge): every row it
// stages, and every row its epilogue reads or writes 4 values at a time,
// starts on 16 bytes and is whole 16-byte chunks (m and n multiples of 4
// floats, of 8 bf16 for bf16 storage), and the u and v buffers are given.
template <class TS>
bool wide_layout(const ServeArgs<TS>& a) {
  constexpr int vec = 16 / sizeof(TS);
  const void* ptrs[] = {a.A, a.W1, a.W2, a.b, a.x0, a.z0, a.lam0, a.ax0, a.x, a.ax, a.xo, a.axo,
                        a.z[0], a.z[1], a.lam[0], a.lam[1], a.u, a.v};
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return a.u != nullptr && a.v != nullptr && a.m % vec == 0 && a.n % vec == 0 && a.sx.len % vec == 0 &&
         a.sax.len % vec == 0 && a.sz.len % vec == 0;
}

// Clear the counters (the only state a call needs zeroed) and launch
// `grid` blocks of the chosen instantiation on `stream`. A refused launch
// (a grid the card cannot hold resident) runs nothing; its error is
// cleared for later launches' checks and returned.
template <class TS>
cudaError_t launch_serve(ServeArgs<TS>& a, int n_counters, int tile, int bf16, int grid,
                         int device, cudaStream_t stream) {
  if (a.S < 1 || a.m < 1 || a.n < 1 || a.K < 1 || grid < 1 ||
      a.sx.len < 1 || a.sax.len < 1 || a.sz.len < 1 || (a.beta == nullptr) == (a.beta16 == nullptr) ||
      a.x == nullptr || a.ax == nullptr || (tile == kWT && !wide_layout(a)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int smem = 0;
  const void* fn = serve_kernel<TS>(tile, bf16, &smem);
  if (fn == nullptr) return cudaErrorInvalidValue;
  if (n_counters > 0) err = cudaMemsetAsync(a.cnt, 0, (size_t)n_counters * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kPT), args, smem, stream);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// Only grid barriers: their cost on the card (chip_smoke.py).
__global__ void __launch_bounds__(kPT) barrier_probe(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

// The serving forward of either storage (the C entries below).
template <class TS>
int unroll_forward(const TS* b, const TS* A, const TS* W1, const TS* W2, const TS* th1, const TS* th2,
                   const float* beta, const __nv_bfloat16* beta16, float* x, TS* xo, TS* z, TS* lam,
                   TS* z_tmp, TS* lam_tmp, float* ax, float* u, float* v, float* partials, int* counters,
                   int th1_k, int th1_c, int th2_k, int th2_c, int n_counters, int S, int m, int n, int K,
                   int prox_x, int prox_z, float scale_x, float scale_z, int tile, int grid,
                   const Split (&sp)[3], int device, void* stream_handle) {
  if (prox_x < PROX_L1 || prox_x > PROX_ELASTIC_NET || prox_z < PROX_L1 || prox_z > PROX_ELASTIC_NET)
    return (int)cudaErrorInvalidValue;
  ServeArgs<TS> a{b, A, W1, W2, th1, th2, beta, beta16, th1_k, th1_c, th2_k, th2_c,
                  nullptr, nullptr, nullptr, nullptr,  // layer 0 reads the zero state
                  x, ax, xo, nullptr,                  // x, Ax in place: see Races
                  {z, z_tmp}, {lam, lam_tmp}, partials, counters,
                  S, m, n, K, prox_x, prox_z, scale_x, scale_z, sp[0], sp[1], sp[2], u, v};
  return (int)launch_serve(a, n_counters, tile, 0, grid, device, static_cast<cudaStream_t>(stream_handle));
}

// One l1 layer of either storage (the C entries below).
template <class TS>
int layer_step(const TS* b, const TS* A, const TS* W1, const TS* W2, const TS* th1, const TS* th2,
               const float* beta, const TS* x, const TS* z, const TS* lam, const TS* ax, float* xw,
               TS* xo, TS* z1, TS* lam1, float* axw, TS* axo, float* u, float* v, float* partials,
               int* counters, int n_counters, int S, int m, int n, int bf16, int tile, int grid, const Split (&sp)[3],
               int device, void* stream_handle) {
  if (x == nullptr || z == nullptr || lam == nullptr || ax == nullptr) return (int)cudaErrorInvalidValue;
  ServeArgs<TS> a{b, A, W1, W2, th1, th2, beta, nullptr, 0, 1, 0, 1, x, z, lam, ax,
                  xw, axw, xo, axo, {z1, nullptr}, {lam1, nullptr}, partials, counters,
                  S, m, n, 1, PROX_L1, PROX_L1, 1.0f, 1.0f, sp[0], sp[1], sp[2], u, v};
  return (int)launch_serve(a, n_counters, tile, bf16 != 0, grid, device,
                           static_cast<cudaStream_t>(stream_handle));
}

}  // namespace

// All K layers of the inference unroll from zero state, as one
// cooperative launch of `grid` blocks of the `tile` (32 or 128) kernel on
// `stream`; no sync. Inputs: b (S,m), A (m,n), W1 (K,n,m), W2 (K,m,m),
// beta (K,), contiguous; thresholds th1 (K,n), th2 (K,m) read at
// th[k * th_k + c * th_c] (th_c = 0: a (K,1) scalar); all fp32 on
// `device`. Outputs x (S,n), z (S,m), lam (S,m); scratch z_tmp, lam_tmp,
// ax (S,m). Workspace (ops/schedule.serve_plan): the wide tile's operands
// u and v (S,m) each (null for the 32 tile), `partials` and `counters`
// (n_counters ints, cleared here). sched: the depth slices
// and their length for the x, Ax and z phases. A grid the card cannot
// hold resident is refused (cudaErrorCooperativeLaunchTooLarge) and
// nothing runs. Returns a cudaError_t.
extern "C" int dladmm_unroll_forward(
    const float* b, const float* A, const float* W1, const float* W2,
    const float* th1, const float* th2, const float* beta, float* x, float* z,
    float* lam, float* z_tmp, float* lam_tmp, float* ax, float* u, float* v, float* partials, int* counters,
    int th1_k, int th1_c, int th2_k, int th2_c, int n_counters, int S, int m, int n,
    int K, int prox_x, int prox_z, float scale_x, float scale_z, int tile, int grid,
    int x_slices, int x_len, int ax_slices, int ax_len, int z_slices, int z_len,
    int device, void* stream_handle) {
  const Split sp[3] = {{x_slices, x_len}, {ax_slices, ax_len}, {z_slices, z_len}};
  return unroll_forward<float>(b, A, W1, W2, th1, th2, beta, nullptr, x, nullptr, z, lam, z_tmp, lam_tmp, ax,
                               u, v, partials, counters, th1_k, th1_c, th2_k, th2_c, n_counters, S, m, n, K,
                               prox_x, prox_z, scale_x, scale_z, tile, grid, sp, device, stream_handle);
}

// dladmm_unroll_forward with bf16 storage: b, A, W1, W2, th1, th2 and
// the outputs x, z, lam (and the scratch z_tmp, lam_tmp) are bf16; beta
// is fp32 (`beta`) or bf16 (`beta16`), the other null. Arithmetic is
// fp32, rounded where a layer stores its state; the workspace holds that
// state's fp32 x (S,n) and Ax (S,m) between the phases (`x_work`,
// `ax_work`). Returns a cudaError_t.
extern "C" int dladmm_unroll_forward_bf16(
    const __nv_bfloat16* b, const __nv_bfloat16* A, const __nv_bfloat16* W1, const __nv_bfloat16* W2,
    const __nv_bfloat16* th1, const __nv_bfloat16* th2, const float* beta, const __nv_bfloat16* beta16,
    __nv_bfloat16* x, __nv_bfloat16* z, __nv_bfloat16* lam, __nv_bfloat16* z_tmp, __nv_bfloat16* lam_tmp,
    float* ax_work, float* x_work, float* u, float* v, float* partials, int* counters,
    int th1_k, int th1_c, int th2_k, int th2_c, int n_counters, int S, int m, int n,
    int K, int prox_x, int prox_z, float scale_x, float scale_z, int tile, int grid,
    int x_slices, int x_len, int ax_slices, int ax_len, int z_slices, int z_len,
    int device, void* stream_handle) {
  const Split sp[3] = {{x_slices, x_len}, {ax_slices, ax_len}, {z_slices, z_len}};
  return unroll_forward<__nv_bfloat16>(b, A, W1, W2, th1, th2, beta, beta16, x_work, x, z, lam, z_tmp,
                                       lam_tmp, ax_work, u, v, partials, counters, th1_k, th1_c, th2_k, th2_c,
                                       n_counters, S, m, n, K, prox_x, prox_z, scale_x, scale_z, tile,
                                       grid, sp, device, stream_handle);
}

// Blocks of unroll_persistent<tile, bf16, storage> (storage 0: fp32, 1:
// bf16) resident on one SM, and the card's SMs: the grid ceiling of its
// cooperative launch (ops/schedule.serve_plan).
extern "C" int dladmm_unroll_occupancy(int tile, int bf16, int storage, int device, int* blocks_per_sm,
                                       int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int smem = 0;
  const void* fn = serve_kernel(tile, bf16, storage, &smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kPT, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

// Blocks of traj_persistent<tile, storage> (storage 0: fp32, 1: bf16,
// which has the 32 tile only) resident on one SM, and the card's SMs: the
// grid ceiling of its cooperative launch (ops/schedule.traj_plan).
extern "C" int dladmm_traj_occupancy(int tile, int storage, int device, int* blocks_per_sm, int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int smem = 0;
  const void* fn = storage ? traj_kernel<__nv_bfloat16>(tile, &smem) : traj_kernel<float>(tile, &smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kPT, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

namespace {

// Clear the counters (and, for the 32 tile, `zeros`) and launch `grid`
// blocks of traj_persistent<tile, TS> on `stream`. A refused launch runs
// nothing; its error is cleared for later launches' checks and returned.
template <class TS>
int launch_traj(TrajArgs<TS>& a, int n_counters, int tile, int grid, int device, void* stream_handle) {
  if (a.S < 1 || a.m < 1 || a.n < 1 || a.K < 1 || grid < 1 || a.sx.len < 1 || a.sax.len < 1 ||
      a.sz.len < 1 || (tile == kT && a.zeros == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int smem = 0;
  const void* fn = traj_kernel<TS>(tile, &smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const size_t sn = (size_t)a.S * a.n, sm = (size_t)a.S * a.m;
  if (tile == kT) err = cudaMemsetAsync(const_cast<float*>(a.zeros), 0, (sn > sm ? sn : sm) * sizeof(float), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(a.cnt, 0, (size_t)n_counters * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kPT), args, smem, stream);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

}  // namespace

// All K layers of the trajectory forward (l1 prox) as one cooperative
// launch of `grid` blocks of the `tile` (32 or 128) kernel on `stream`; no
// sync. Inputs as dladmm_unroll_forward. Outputs the stacks tx (K,S,n),
// tz (K,S,m), tlam (K,S,m) and, with with_tax, tax (K,S,m); without it
// `tax` is one (S,m) scratch buffer. Workspace (ops/schedule.traj_workspace):
// for the 32 tile `zeros` of S*max(n,m) floats (null on the wide tile,
// whose layer 0 reads the zero state through a block-uniform branch), for
// the wide tile its operands u and v (S,m) each (null on the 32 tile),
// `counters` of n_counters ints, zeroed here with `zeros`, and `partials`.
// sched: the depth slices and their length for the x, Ax and z phases.
// The wide tile takes the serving kernel's layout rules (wide_layout). A
// grid the card cannot hold resident is refused
// (cudaErrorCooperativeLaunchTooLarge) and nothing runs. Returns a
// cudaError_t.
extern "C" int dladmm_unroll_trajectory(
    const float* b, const float* A, const float* W1, const float* W2,
    const float* th1, const float* th2, const float* beta, float* tx,
    float* tz, float* tlam, float* tax, float* zeros, float* u, float* v, float* partials, int* counters,
    int n_counters, int with_tax, int S, int m, int n, int K, int tile, int grid, int x_slices,
    int x_len, int ax_slices, int ax_len, int z_slices, int z_len, int device,
    void* stream_handle) {
  TrajArgs<float> a{b, A, W1, W2, th1, th2, beta, nullptr, tx, tz, tlam, tax, zeros,
                    nullptr, nullptr, {nullptr, nullptr}, {nullptr, nullptr}, partials, counters,
                    with_tax, S, m, n, K,
                    Split{x_slices, x_len}, Split{ax_slices, ax_len}, Split{z_slices, z_len}, u, v};
  if (tile == kWT && !wide_layout(traj_layer(a, 0))) return (int)cudaErrorInvalidValue;
  return launch_traj(a, n_counters, tile, grid, device, stream_handle);
}

// dladmm_unroll_trajectory with bf16 storage: b, A, W1, W2, th1, th2 and
// the stacks tx, tz, tlam (and, with with_tax, tax (K,S,m)) are bf16;
// beta is fp32 (`beta`) or bf16 (`beta16`), the other null. Arithmetic is
// fp32 and the state stays fp32 between the phases and layers, in the
// workspace (ops/schedule.traj_workspace with bf16_state): x_work (S,n),
// ax_work (S,m), and z_work, lam_work, each two (S,m) buffers one after
// the other; only the stack stores round. Without with_tax `tax` is
// null. Returns a cudaError_t.
extern "C" int dladmm_unroll_trajectory_bf16(
    const __nv_bfloat16* b, const __nv_bfloat16* A, const __nv_bfloat16* W1, const __nv_bfloat16* W2,
    const __nv_bfloat16* th1, const __nv_bfloat16* th2, const float* beta, const __nv_bfloat16* beta16,
    __nv_bfloat16* tx, __nv_bfloat16* tz, __nv_bfloat16* tlam, __nv_bfloat16* tax, float* x_work,
    float* ax_work, float* z_work, float* lam_work, float* zeros, float* partials, int* counters,
    int n_counters, int with_tax, int S, int m, int n, int K, int grid, int x_slices,
    int x_len, int ax_slices, int ax_len, int z_slices, int z_len, int device,
    void* stream_handle) {
  if ((beta == nullptr) == (beta16 == nullptr) || (with_tax != 0) != (tax != nullptr) || x_work == nullptr ||
      ax_work == nullptr || z_work == nullptr || lam_work == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t sm = (size_t)S * m;
  TrajArgs<__nv_bfloat16> a{b, A, W1, W2, th1, th2, beta, beta16, tx, tz, tlam, tax, zeros,
                            x_work, ax_work, {z_work, z_work + sm}, {lam_work, lam_work + sm},
                            partials, counters, with_tax, S, m, n, K,
                            Split{x_slices, x_len}, Split{ax_slices, ax_len}, Split{z_slices, z_len},
                            nullptr, nullptr};
  return launch_traj(a, n_counters, kT, grid, device, stream_handle);
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
// fresh outputs x1 (S,n), z1, lam1, ax1 (S,m): unroll_persistent at
// K = 1, one cooperative launch of `grid` blocks of the `tile` kernel on
// `stream`; no sync. Inputs b (S,m), A (m,n), W1 (n,m), W2 (m,m),
// th1 (n,), th2 (m,), beta (1,): this layer's, fp32, contiguous, on
// `device`. bf16 != 0 rounds the products' operands to bf16. No output
// aliases an input. Workspace and sched as dladmm_unroll_forward.
// Returns a cudaError_t.
extern "C" int dladmm_layer_step(
    const float* b, const float* A, const float* W1, const float* W2,
    const float* th1, const float* th2, const float* beta, const float* x,
    const float* z, const float* lam, const float* ax, float* x1, float* z1,
    float* lam1, float* ax1, float* u, float* v, float* partials, int* counters, int n_counters, int S, int m,
    int n, int bf16, int tile, int grid, int x_slices, int x_len, int ax_slices, int ax_len,
    int z_slices, int z_len, int device, void* stream_handle) {
  const Split sp[3] = {{x_slices, x_len}, {ax_slices, ax_len}, {z_slices, z_len}};
  return layer_step<float>(b, A, W1, W2, th1, th2, beta, x, z, lam, ax, x1, nullptr, z1, lam1, ax1,
                           nullptr, u, v, partials, counters, n_counters, S, m, n, bf16, tile, grid, sp,
                           device, stream_handle);
}

// dladmm_layer_step on bf16 state: b, A, W1, W2, th1, th2, the state
// x, z, lam, ax and the outputs x1, z1, lam1, ax1 are bf16, beta fp32.
// The layer runs in fp32 and rounds only its four stores; the fresh x1
// and Ax1 stay fp32 in the workspace (`x_work` (S,n), `ax_work` (S,m))
// for the Ax and z phases, which read them unrounded. Returns a
// cudaError_t.
extern "C" int dladmm_layer_step_bf16(
    const __nv_bfloat16* b, const __nv_bfloat16* A, const __nv_bfloat16* W1, const __nv_bfloat16* W2,
    const __nv_bfloat16* th1, const __nv_bfloat16* th2, const float* beta, const __nv_bfloat16* x,
    const __nv_bfloat16* z, const __nv_bfloat16* lam, const __nv_bfloat16* ax, __nv_bfloat16* x1,
    __nv_bfloat16* z1, __nv_bfloat16* lam1, __nv_bfloat16* ax1, float* ax_work, float* x_work,
    float* u, float* v, float* partials, int* counters, int n_counters, int S, int m, int n, int bf16, int tile, int grid,
    int x_slices, int x_len, int ax_slices, int ax_len, int z_slices, int z_len, int device,
    void* stream_handle) {
  const Split sp[3] = {{x_slices, x_len}, {ax_slices, ax_len}, {z_slices, z_len}};
  return layer_step<__nv_bfloat16>(b, A, W1, W2, th1, th2, beta, x, z, lam, ax, x_work, x1, z1, lam1,
                                   ax_work, ax1, u, v, partials, counters, n_counters, S, m, n, bf16, tile,
                                   grid, sp, device, stream_handle);
}

extern "C" const char* dladmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
