// Reverse sweep of the K-layer D-LADMM unroll for the final-state loss,
// for Hopper (sm_90a), fp32 arithmetic throughout, on fp32 or bf16
// storage (below).
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
//   gW2 = -gp2^T v, gW1 = -gp1^T u      weights   sums over S
//   gth2 = -sum_s gp2 sign(z1) * tie(th2), gth1 likewise on gp1, x1
//   gbeta = (sum glam (Ax1 + z1 - b) - sum gbase lam_in ib^2) * tie_b
//
// with tie(t) = (t > 0) + 0.5 (t == 0) and tie_b = (beta_k > 1e-6) +
// 0.5 (beta_k == 1e-6), jnp.maximum's split of a tie's gradient.
//
// Design. Three launches a call on the caller's stream.
// (1) bwd_chain, one persistent cooperative launch: the V, X and U phases
// of all K layers with a grid barrier between dependent phases (3K - 1).
// Each phase is a tiled fp32 GEMM (32 x 32 output tiles) that builds its
// operand while staging it (gp2 from gz, glam, z1) and fuses the
// elementwise work into its epilogue. At S = 64 a phase has 16-32 tiles,
// so it also cuts its depth into slices (ops/schedule.bwd_schedule): the
// items spread over the grid, each sliced item writes a partial tile,
// and the last block to finish a tile (an integer atomic per tile) sums
// the partials in slice order and runs the epilogue. The next depth
// step's loads stay in flight (registers) while the current one is
// computed from the other half of a double-buffered shared-memory tile;
// __launch_bounds__(kPT, 4) holds the chain at 64 registers, 4 blocks a
// SM (at 76 it held 3, and S = 1024 took 25% longer). Where the shape
// suits it (ops/schedule.tile_edge: fp32 storage, m and n whole 16-byte
// chunks and 256 or more, enough operations a layer) the chain runs on
// the wide 128 x 128 tile instead (bwd_chain<kWT, float>, below): the
// register-blocked mainloop of wide_tile.cuh with the weight staged by
// depth, as the chain reads it, at one block a SM.
// X's epilogue writes gp1 into a (K, S, n) stack (the next layer's gx
// carry is that slice), U's writes gp2 into a (K, S, m) stack, so the
// weight gradients leave the chain: (2) bwd_weights, one launch for all
// K layers' gW1 and gW2 tiles (2880 at synthetic_small), each summed
// over S in cdiv(S, bs) slices of bs rows: bs >= S is the whole batch,
// bs < S the chunked route, whose fp32 partials are summed in slice
// order by the last block of the tile (the H100's counterpart of the
// TPU's cross-tile accumulation). (3) finish: gth1, gth2, gbeta from the
// per-tile partials, in a fixed order, with the tie factors.
//
// bf16 storage. dladmm_unroll_bwd_bf16 (bwd_chain, bwd_weights and finish
// on __nv_bfloat16) replaces the same TPU kernels on bf16 refs (bf16
// training) and keeps their rule: the stacks, the cotangents, the weights
// and A are read as bf16 and widened exactly; the cotangent state stays
// fp32 from layer to layer (the carries in the workspace, the gp1 / gp2
// stacks and every partial); an activation is rounded to bf16 only where
// it meets a bf16 weight or A, as the chain stages it (gp2 for gv, gAx1
// for gp1, gp1 for gu: dot32 in pallas_bwd.py); gW1 and gW2 are fp32 sums
// (their other operand, u or v, is fp32 there) and every gradient is
// rounded once as it is stored (gbeta in beta's storage). gb (data
// grads) follows the TPU route: rounded to bf16 every layer on the whole
// batch (_bwd_kernel), summed in fp32 and rounded once on batch slices
// (_bwd_kernel_chunked). The plain version is
// ops/cuda_bwd.unroll_bwd_plain_bf16. The products stay fp32 FMA: a bf16
// tensor-core product would also round the fp32 activation where the
// rule keeps it fp32 (gW1, gW2).
//
// Determinism. No float atomics; every sum runs in a fixed order. A
// call repeats bit for bit on one card.
//
// Races. Inside the chain, a phase never writes what another block of
// the same phase reads across rows or columns: V reads gz, glam, z1
// across columns and writes gv and gAx1; X reads gAx1 across columns and
// writes this layer's gp1 slice; U reads gp1 across columns and rewrites
// gz, glam, gAx, gb element by element. Phases are ordered by the grid
// barrier. State written in the call is read with __ldcg (L2, never a
// stale L1 line). Layer K-1 reads the caller's final-state cotangents
// (its U phase writes the first carries), layer 0 a zero buffer.
//
// Alignment. Rows of m = 250 floats are only 8-byte aligned, so every
// load of the 32 tile is 4-byte: no 16-byte copy or TMA descriptor. The
// wide tile takes only rows of whole 16-byte chunks (wide_chain_layout).
//
// Bound. 2 S K (2 m^2 + 3 n m) flops, and the bytes of the weights, the
// trajectory and the outputs once; at S >= 64 the flops dominate, so the
// bound is the fp32 CUDA-core rate. At small S the chain is bound by its
// barriers and serial depth (PERF.md).
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/ops/cuda_bwd.py).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "persistent.cuh"
#include "wide_tile.cuh"

namespace cg = cooperative_groups;

namespace {

enum Phase { PHASE_V = 0, PHASE_X = 1, PHASE_U = 2 };

constexpr float kBetaMin = 1e-6f;

__device__ __forceinline__ float nonzero(float x) { return x != 0.0f ? 1.0f : 0.0f; }
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}
__device__ __forceinline__ float tie(float t, float at) {
  return t > at ? 1.0f : (t == at ? 0.5f : 0.0f);
}
int cdiv(int a, int b) { return (a + b - 1) / b; }

// Sum over the tile's rows of each of its columns: `colp[j]` is this
// thread's sum over its two rows of column tc + j*kPC. Thread tid < kT
// writes the tile's sum of column col0 + tid to out[col0 + tid].
__device__ __forceinline__ void column_sums(TileSmem& sm, const float (&colp)[2], int col0, int N,
                                            float* out) {
  const int tid = threadIdx.x, tr = tid / kPC, tc = tid % kPC;
#pragma unroll
  for (int j = 0; j < 2; ++j) sm.col[tr][tc + j * kPC] = colp[j];
  __syncthreads();
  if (tid < kT && col0 + tid < N) {
    float s = 0.0f;
    for (int r = 0; r < kPR; ++r) s += sm.col[r][tid];
    out[col0 + tid] = s;
  }
  __syncthreads();  // sm.col is free again
}

// Sum of v over the block, in a fixed order; thread 0 gets the result.
__device__ __forceinline__ double block_sum(double v, double (&red)[kWarps]) {
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

// Storage of the inputs, the stacks, the cotangents and the gradients:
// float, or __nv_bfloat16 (bf16 storage: read and widened exactly,
// rounded to nearest where a gradient or the gAx1 stack is stored).
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// v as a bf16 value holds it.
__device__ __forceinline__ float rounded(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

template <class TS>
__device__ __forceinline__ float beta_at(const float* beta, const __nv_bfloat16* beta16, int k) {
  if constexpr (sizeof(TS) == 2) {
    if (beta16 != nullptr) return __bfloat162float(beta16[k]);
  }
  return __ldg(beta + k);
}

template <class TS>
struct ChainArgs {
  const TS *b, *A, *W1, *W2;
  const float* beta;                  // (K,) fp32, or null where beta16 is given
  const __nv_bfloat16* beta16;        // (K,) bf16 (bf16 storage only), or null
  const TS *tx, *tz, *tlam, *tax;     // the forward's stacks (K, S, .)
  const TS *gx0, *gz0, *glam0;        // (S, n), (S, m), (S, m) final-state cotangents
  const TS* zeros;                    // (S, m) zeros: layer 0's lam_in
  float *gz, *glam, *gax, *gv;        // (S, m) carries, updated in place; this layer's gv
  float* gax1;                        // (K, S, m) stack with gax1_stack, else one (S, m)
  int gax1_stack;
  TS* gax1_out;                       // bf16 with data grads: the rounded (K, S, m) gAx1 stack, else null
  float* gb;                          // (S, m) accumulated gb, or null
  TS* gb_out;                         // bf16: gb rounded, written by layer 0, or null
  int gb_round;                       // bf16, whole batch: gb rounded to bf16 every layer
  float *gp1, *gp2;                   // (K, S, n) and (K, S, m) stacks
  float *th1p, *th2p;                 // (K, row tiles, n) / (K, row tiles, m) column partials
  double* betap;                      // (K, U tiles, 2) gbeta partials
  float* part;                        // split-K partials
  int* cnt;                           // one counter a tile
  int S, m, n, K;
  Split sv, sx, su;
};

// One chain phase of layer k over all its items. Layer K-1 reads the
// final-state cotangents gx0, gz0, glam0; the carries hold the later
// layers'. With bf16 storage the cotangent state stays fp32, and an
// activation is rounded to bf16 where it meets a bf16 weight or A (the
// staged operands gp2, gAx1, gp1: dot32 in pallas_bwd.py).
template <int PHASE, class TS>
__device__ void chain_phase(const ChainArgs<TS>& a, TileSmem& sm, int k) {
  constexpr bool S16 = sizeof(TS) == 2;
  const int S = a.S, m = a.m, n = a.n;
  const size_t sn = (size_t)S * n, smm = (size_t)S * m;
  const int N = PHASE == PHASE_X ? n : m, depth = PHASE == PHASE_U ? n : m;
  const Split sp = PHASE == PHASE_V ? a.sv : (PHASE == PHASE_X ? a.sx : a.su);
  const float beta = fmaxf(beta_at<TS>(a.beta, a.beta16, k), kBetaMin), ib = 1.0f / beta;
  const TS* x1 = a.tx + k * sn;
  const TS* z1s = a.tz + k * smm;
  const TS* ax1 = a.tax + k * smm;
  const TS* lam_in = k ? a.tlam + (k - 1) * smm : a.zeros;
  const bool top = k + 1 == a.K;
  float* gp1 = a.gp1 + k * sn;
  float* gp2 = a.gp2 + k * smm;
  float* gax1 = a.gax1_stack ? a.gax1 + k * smm : a.gax1;
  const TS* W1 = a.W1 + (size_t)k * n * m;
  const TS* W2 = a.W2 + (size_t)k * m * m;
  auto gz_at = [&](size_t o) { return top ? ldg(a.gz0 + o) : __ldcg(a.gz + o); };
  auto glam_at = [&](size_t o) { return top ? ldg(a.glam0 + o) : __ldcg(a.glam + o); };
  auto operand = [&](float v) { return S16 ? rounded(v) : v; };
  const int rt = dcdiv(S, kT), ct = dcdiv(N, kT), items = rt * ct * sp.slices;
  const int tid = threadIdx.x, tr = tid / kPC, tc = tid % kPC;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it / sp.slices, s = it % sp.slices;
    const int rb = tile / ct, row0 = rb * kT, col0 = tile % ct * kT;
    const int k_lo = s * sp.len, k_hi = min(depth, k_lo + sp.len);
    float acc[2][2];
    if constexpr (PHASE == PHASE_V) {
      tile_gemm<true, false>(
          sm, S, m, row0, col0, k_lo, k_hi,
          [&](int r, int q) {
            const size_t o = (size_t)r * m + q;
            return operand((gz_at(o) + beta * glam_at(o)) * nonzero(ldg(z1s + o)));
          },
          [&](int c, int q) { return ldg(W2 + (size_t)q * m + c); }, acc);
    } else if constexpr (PHASE == PHASE_X) {
      tile_gemm<true, false>(
          sm, S, n, row0, col0, k_lo, k_hi,
          [&](int r, int q) { return operand(__ldcg(gax1 + (size_t)r * m + q)); },
          [&](int c, int q) { return ldg(a.A + (size_t)q * n + c); }, acc);
    } else {
      tile_gemm<true, false>(
          sm, S, m, row0, col0, k_lo, k_hi, [&](int r, int q) { return operand(__ldcg(gp1 + (size_t)r * n + q)); },
          [&](int c, int q) { return ldg(W1 + (size_t)q * m + c); }, acc);
    }
    if (!reduce_slices(sm, acc, a.part, a.cnt, tile, s, sp.slices)) continue;

    float colp[2] = {0.0f, 0.0f};
    double p_res = 0.0, p_lam = 0.0;  // U: the two gbeta sums
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + tr + i * kPR;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = col0 + tc + j * kPC;
        if (r >= S || c >= N) continue;
        if constexpr (PHASE == PHASE_V) {
          const size_t o = (size_t)r * m + c;
          const float gv = -acc[i][j];
          a.gv[o] = gv;
          const float g = (__ldcg(a.gax + o) + beta * glam_at(o)) + gv;
          gax1[o] = g;
          if constexpr (S16) {
            if (a.gax1_out) put(a.gax1_out + k * smm + o, g);
          }
        } else if constexpr (PHASE == PHASE_X) {
          const size_t o = (size_t)r * n + c;
          const float x = ldg(x1 + o);
          const float gx = top ? ldg(a.gx0 + o) : __ldcg(a.gp1 + (k + 1) * sn + o);
          const float g = (gx + acc[i][j]) * nonzero(x);
          gp1[o] = g;
          colp[j] += g * sign_of(x);
        } else {
          const size_t o = (size_t)r * m + c;
          const float glam1 = glam_at(o), z1 = ldg(z1s + o);
          const float g2 = (gz_at(o) + beta * glam1) * nonzero(z1);
          const float gu = -acc[i][j];
          const float gbase = __ldcg(a.gv + o) + gu;
          gp2[o] = g2;
          a.gz[o] = g2 + gbase;
          a.glam[o] = glam1 + gbase * ib;
          a.gax[o] = gu;
          if (a.gb) {
            if constexpr (S16) {
              // gb + (-gbase - beta glam): per layer in bf16 on the whole
              // batch (_bwd_kernel), in fp32 on batch slices.
              const float step = -gbase - beta * glam1, prev = __ldcg(a.gb + o);
              const float gb = a.gb_round ? rounded(prev + rounded(step)) : prev + step;
              a.gb[o] = gb;
              if (k == 0) put(a.gb_out + o, gb);
            } else {
              a.gb[o] = (__ldcg(a.gb + o) - gbase) - beta * glam1;
            }
          }
          colp[j] += g2 * sign_of(z1);
          p_res += (double)(glam1 * ((ldg(ax1 + o) + z1) - ldg(a.b + o)));
          p_lam += (double)(gbase * ldg(lam_in + o));
        }
      }
    }
    if constexpr (PHASE == PHASE_X)
      column_sums(sm, colp, col0, n, a.th1p + ((size_t)k * rt + rb) * n);
    if constexpr (PHASE == PHASE_U) {
      column_sums(sm, colp, col0, m, a.th2p + ((size_t)k * rt + rb) * m);
      const double s_res = block_sum(p_res, sm.red);
      const double s_lam = block_sum(p_lam, sm.red);
      if (tid == 0) {
        double* out = a.betap + 2 * ((size_t)k * rt * ct + tile);
        out[0] = s_res;
        out[1] = s_lam;
      }
    }
  }
}

// -- the wide tile (wide_tile.cuh) -------------------------------------------
//
// bwd_chain<kWT, float>: the V, X and U phases on 128 x 128 tiles of the
// depth-major mainloop (wide_gemm_dm: the weight W2, A or W1 is read by
// depth, as stored), fp32 storage only. Its operands are plain (S, .)
// matrices staged 16 bytes at a time: X reads the gAx1 buffer, U the gp1
// stack slice, V the gp2 stack slice, which is not built while staging
// as on the 32 tile: layer k+1's U epilogue, which has the new gz and
// glam in registers, writes layer k's gp2 = (gz + beta_k glam)[z1_k != 0]
// into the stack slice k, and a first elementwise pass writes the top
// layer's from the final-state cotangents (one grid barrier more); U_k
// then overwrites the slice with its own gp2, which gW2 reads. The 32
// tile rounds that expression two ways: its V operand with one fma, its
// U epilogue's gp2 (and so the gz carry) with a separate multiply beta
// glam, which gb shares. The wide epilogues take each rounding where the
// 32 tile takes it, written out (__fmaf_rn, __fmul_rn, __fadd_rn: never
// contracted), so that where neither tile splits a phase they give the
// same bits. Each epilogue takes the tile through shared memory (the
// ring is free then), and a warp then handles whole rows of it, a lane 4
// neighbouring columns, with 16-byte loads and stores, keeping each
// element's arithmetic of chain_phase in its order. gth1, gth2: one
// column partial per 128-row block (each lane sums its 16 rows in order,
// then the 8 warps in order); gbeta one fp64 pair per U tile (block_sum).
// One block a SM (8 x 8 outputs a thread, up to 255 registers); the ring,
// the epilogue's tile and the warps' column partials are dynamic shared
// memory (kWChainSmem).

constexpr int kWChainSmem = wide_smem_bytes<float>() + kWarps * kWT * 4;

struct WideChainSmem {
  double red[kWarps];  // block sums (gbeta)
  int last;            // this block finishes the tile (split-K)
};

// V's operand (gz + beta glam)[z1 != 0] as the 32 tile stages it (one fma).
__device__ __forceinline__ float v_operand(float gz, float beta, float glam, float z1) {
  return __fmul_rn(__fmaf_rn(beta, glam, gz), nonzero(z1));
}

// V's operand of the top layer, from the final-state cotangents, into
// the gp2 stack's top slice.
__device__ void wide_gp2_top(const ChainArgs<float>& a) {
  const int k = a.K - 1;
  const float beta = fmaxf(beta_at<float>(a.beta, a.beta16, k), kBetaMin);
  const size_t smm = (size_t)a.S * a.m;  // a multiple of 4 (wide_chain_layout)
  const float* z1s = a.tz + k * smm;
  float* gp2 = a.gp2 + k * smm;
  for (size_t o = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4; o < smm;
       o += (size_t)gridDim.x * blockDim.x * 4) {
    const F4 gz = ld4g(a.gz0 + o), glam = ld4g(a.glam0 + o), z1 = ld4g(z1s + o);
    F4 g;
#pragma unroll
    for (int q = 0; q < 4; ++q) g.v[q] = v_operand(gz.v[q], beta, glam.v[q], z1.v[q]);
    st4(gp2 + o, g);
  }
}

// One chain phase of layer k over all its items on 128 x 128 tiles.
template <int PHASE>
__device__ void wide_chain_phase(const ChainArgs<float>& a, unsigned char* smem, WideChainSmem& sh, int k) {
  const int S = a.S, m = a.m, n = a.n;
  const size_t sn = (size_t)S * n, smm = (size_t)S * m;
  const int N = PHASE == PHASE_X ? n : m, depth = PHASE == PHASE_U ? n : m;
  const Split sp = PHASE == PHASE_V ? a.sv : (PHASE == PHASE_X ? a.sx : a.su);
  const float beta = fmaxf(beta_at<float>(a.beta, a.beta16, k), kBetaMin), ib = 1.0f / beta;
  // U: beta of layer k - 1, whose gp2 this epilogue writes
  const float beta_dn = PHASE == PHASE_U && k > 0 ? fmaxf(beta_at<float>(a.beta, a.beta16, k - 1), kBetaMin) : 0.0f;
  const float* x1 = a.tx + k * sn;
  const float* z1s = a.tz + k * smm;
  const float* ax1 = a.tax + k * smm;
  const float* lam_in = k ? a.tlam + (k - 1) * smm : a.zeros;
  const float* z_dn = k ? a.tz + (k - 1) * smm : nullptr;  // z1 of layer k - 1
  const bool top = k + 1 == a.K;
  float* gp1 = a.gp1 + k * sn;
  float* gp2 = a.gp2 + k * smm;
  float* gax1 = a.gax1_stack ? a.gax1 + k * smm : a.gax1;
  const float* P = PHASE == PHASE_V ? gp2 : (PHASE == PHASE_X ? gax1 : gp1);  // (S, depth)
  const float* W = PHASE == PHASE_V ? a.W2 + (size_t)k * m * m : (PHASE == PHASE_X ? a.A : a.W1 + (size_t)k * n * m);
  const int rt = dcdiv(S, kWT), ct = dcdiv(N, kWT), items = rt * ct * sp.slices;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  float* ts = reinterpret_cast<float*>(smem);
  float* cols = reinterpret_cast<float*>(smem + wide_smem_bytes<float>());  // [warp][kWT]
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it / sp.slices, s = it % sp.slices;
    const int rb = tile / ct, row0 = rb * kWT, col0 = tile % ct * kWT;
    const int k_lo = s * sp.len, k_hi = min(depth, k_lo + sp.len);
    float acc[8][8];
    wide_gemm_dm(smem, S, N, row0, col0, k_lo, k_hi, P, depth, W, N, acc);
    if (!wide_reduce(acc, a.part, a.cnt, tile, s, sp.slices, sh.last)) continue;
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(ts + (ty + 16 * i) * kWTP + 64 * h + 4 * tx) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
    __syncthreads();
    const int c = col0 + 4 * lane;  // N is a multiple of 4 (wide_chain_layout)
    float colp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    double p_res = 0.0, p_lam = 0.0;  // U: the two gbeta sums
    if (c < N) {
      // B rows a batch: their inputs are loaded before any is stored (a
      // store may alias a later load). U's inputs: glam, gz, z1, gv, Ax1,
      // b, lam_in, gb, z1 of layer k - 1.
      constexpr int B = PHASE == PHASE_U ? 2 : 4, NIN = PHASE == PHASE_U ? 9 : 2;
#pragma unroll
      for (int r0 = 0; r0 < kWT / 8; r0 += B) {
        F4 e[B][NIN];
#pragma unroll
        for (int h = 0; h < B; ++h) {
          const int r = row0 + warp + 8 * (r0 + h);
#pragma unroll
          for (int q = 0; q < NIN; ++q) e[h][q] = F4{};
          if (r >= S) continue;
          const size_t o = (size_t)r * N + c;
          if constexpr (PHASE == PHASE_V) {
            e[h][0] = ld4cg(a.gax + o);
            e[h][1] = top ? ld4g(a.glam0 + o) : ld4cg(a.glam + o);
          } else if constexpr (PHASE == PHASE_X) {
            e[h][0] = ld4g(x1 + o);
            e[h][1] = top ? ld4g(a.gx0 + o) : ld4cg(a.gp1 + (k + 1) * sn + o);
          } else {
            e[h][0] = top ? ld4g(a.glam0 + o) : ld4cg(a.glam + o);
            e[h][1] = top ? ld4g(a.gz0 + o) : ld4cg(a.gz + o);
            e[h][2] = ld4g(z1s + o);
            e[h][3] = ld4cg(a.gv + o);
            e[h][4] = ld4g(ax1 + o);
            e[h][5] = ld4g(a.b + o);
            e[h][6] = ld4g(lam_in + o);
            if (a.gb) e[h][7] = ld4cg(a.gb + o);
            if (k > 0) e[h][8] = ld4g(z_dn + o);
          }
        }
#pragma unroll
        for (int h = 0; h < B; ++h) {
          const int rr = warp + 8 * (r0 + h), r = row0 + rr;
          if (r >= S) continue;
          const size_t o = (size_t)r * N + c;
          const float4 sum4 = *reinterpret_cast<const float4*>(ts + rr * kWTP + 4 * lane);
          const float sum[4] = {sum4.x, sum4.y, sum4.z, sum4.w};
          if constexpr (PHASE == PHASE_V) {
            F4 gv, g;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              gv.v[q] = -sum[q];
              g.v[q] = __fadd_rn(__fmaf_rn(beta, e[h][1].v[q], e[h][0].v[q]), gv.v[q]);
            }
            st4(a.gv + o, gv);
            st4(gax1 + o, g);
          } else if constexpr (PHASE == PHASE_X) {
            F4 g;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float x = e[h][0].v[q];
              g.v[q] = (e[h][1].v[q] + sum[q]) * nonzero(x);
              colp[q] += g.v[q] * sign_of(x);
            }
            st4(gp1 + o, g);
          } else {
            F4 g2, gz, glam, gax, gb, op;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float glam1 = e[h][0].v[q], z1 = e[h][2].v[q];
              const float bg = __fmul_rn(beta, glam1);
              g2.v[q] = __fmul_rn(__fadd_rn(e[h][1].v[q], bg), nonzero(z1));
              const float gu = -sum[q];
              const float gbase = __fadd_rn(e[h][3].v[q], gu);
              gz.v[q] = __fadd_rn(g2.v[q], gbase);
              glam.v[q] = __fmaf_rn(gbase, ib, glam1);
              gax.v[q] = gu;
              gb.v[q] = __fsub_rn(__fsub_rn(e[h][7].v[q], gbase), bg);
              op.v[q] = v_operand(gz.v[q], beta_dn, glam.v[q], e[h][8].v[q]);  // layer k - 1's V operand
              colp[q] += g2.v[q] * sign_of(z1);
              p_res += (double)(glam1 * ((e[h][4].v[q] + z1) - e[h][5].v[q]));
              p_lam += (double)(gbase * e[h][6].v[q]);
            }
            st4(gp2 + o, g2);
            st4(a.gz + o, gz);
            st4(a.glam + o, glam);
            st4(a.gax + o, gax);
            if (a.gb) st4(a.gb + o, gb);
            if (k > 0) st4(a.gp2 + (k - 1) * smm + o, op);
          }
        }
      }
    }
    if constexpr (PHASE != PHASE_V) {
      *reinterpret_cast<float4*>(cols + warp * kWT + 4 * lane) = make_float4(colp[0], colp[1], colp[2], colp[3]);
      __syncthreads();
      if (tid < kWT && col0 + tid < N) {
        float sum = 0.0f;
        for (int w = 0; w < kWarps; ++w) sum += cols[w * kWT + tid];
        float* out = PHASE == PHASE_X ? a.th1p : a.th2p;
        out[((size_t)k * rt + rb) * N + col0 + tid] = sum;
      }
    }
    if constexpr (PHASE == PHASE_U) {
      const double s_res = block_sum(p_res, sh.red);
      const double s_lam = block_sum(p_lam, sh.red);
      if (tid == 0) {
        double* out = a.betap + 2 * ((size_t)k * rt * ct + tile);
        out[0] = s_res;
        out[1] = s_lam;
      }
    }
  }
}

// Layers K-1 ... 0 in one cooperative launch: V, X, U a layer with a
// grid barrier after each but the last. The 32 tile (either storage) at
// 4 blocks a SM; the wide tile (fp32 storage) at one block a SM, its
// ring in dynamic shared memory, the top layer's gp2 first, behind one
// barrier more.
template <int T, class TS>
__global__ void __launch_bounds__(kPT, T == kT ? 4 : 1) bwd_chain(const ChainArgs<TS> a) {
  cg::grid_group grid = cg::this_grid();
  if constexpr (T == kT) {
    __shared__ TileSmem sm;
    for (int k = a.K - 1; k >= 0; --k) {
      chain_phase<PHASE_V, TS>(a, sm, k);
      grid.sync();
      chain_phase<PHASE_X, TS>(a, sm, k);
      grid.sync();
      chain_phase<PHASE_U, TS>(a, sm, k);
      if (k > 0) grid.sync();
    }
  } else {
    extern __shared__ __align__(16) unsigned char wide_smem[];
    __shared__ WideChainSmem sh;
    wide_gp2_top(a);
    grid.sync();
    for (int k = a.K - 1; k >= 0; --k) {
      wide_chain_phase<PHASE_V>(a, wide_smem, sh, k);
      grid.sync();
      wide_chain_phase<PHASE_X>(a, wide_smem, sh, k);
      grid.sync();
      wide_chain_phase<PHASE_U>(a, wide_smem, sh, k);
      if (k > 0) grid.sync();
    }
  }
}

// The chain's instantiation of a tile edge: 32 for either storage, kWT
// for fp32 storage only; else null. Its dynamic shared memory in `smem`,
// with the kernel's ceiling raised to it.
template <class TS>
const void* chain_kernel(int tile, int* smem) {
  *smem = 0;
  if (tile == kT) return (const void*)bwd_chain<kT, TS>;
  if constexpr (sizeof(TS) == 4) {
    if (tile == kWT) return with_smem((const void*)bwd_chain<kWT, TS>, *smem = kWChainSmem);
  }
  return nullptr;
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// The wide chain's layout rules (ops/schedule.tile_edge): every matrix it
// reads or writes 16 bytes at a time starts on 16 bytes, m and n are
// whole chunks of 4 floats, and so is every depth slice of the operand.
bool wide_chain_layout(const ChainArgs<float>& c) {
  const void* ptrs[] = {c.b, c.A, c.W1, c.W2, c.tx, c.tz, c.tlam, c.tax, c.gx0, c.gz0, c.glam0, c.zeros,
                        c.gz, c.glam, c.gax, c.gv, c.gax1, c.gb, c.gp1, c.gp2, c.part};
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return c.m % 4 == 0 && c.n % 4 == 0 && c.sv.len % 4 == 0 && c.sx.len % 4 == 0 && c.su.len % 4 == 0;
}

template <class TS>
struct WeightArgs {
  const TS *b, *tz, *tlam, *tax, *zeros;
  const float* beta;
  const __nv_bfloat16* beta16;
  const float *gp1, *gp2;              // the chain's stacks
  TS *gW1, *gW2;                       // (K, n, m), (K, m, m)
  float* part;
  int* cnt;
  int S, m, n, K, bs;                  // rows per S slice (bs >= S: one slice)
};

// All K layers' gW1 = -gp1^T u and gW2 = -gp2^T v, one block per (layer,
// tile, S slice): item = tile * slices + slice; a layer's tiles are the
// 32-row tiles of gW1 (n rows) then of gW2 (m rows), by 32-column tiles
// (ops/schedule.WeightSplit counts them; tests/test_torch_schedule.py
// checks this map). The sums are fp32 in both storages (u and v are
// fp32 there too); bf16 rounds each gradient once as it stores it.
template <class TS>
__global__ void __launch_bounds__(kPT) bwd_weights(const WeightArgs<TS> a) {
  __shared__ TileSmem sm;
  const int S = a.S, m = a.m, n = a.n;
  const size_t sn = (size_t)S * n, smm = (size_t)S * m;
  const int t1 = dcdiv(n, kT), ct = dcdiv(m, kT), per = (t1 + dcdiv(m, kT)) * ct;
  const int slices = dcdiv(S, a.bs), items = a.K * per * slices;
  const int tid = threadIdx.x, tr = tid / kPC, tc = tid % kPC;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it / slices, s = it % slices;
    const int k = tile / per, t = tile % per, rt = t / ct, cb = t % ct;
    const bool w1 = rt < t1;
    const int rows = w1 ? n : m, row0 = (w1 ? rt : rt - t1) * kT, col0 = cb * kT;
    const int s_lo = s * a.bs, s_hi = min(S, s_lo + a.bs);
    const float ib = 1.0f / fmaxf(beta_at<TS>(a.beta, a.beta16, k), kBetaMin);
    const float* gp = w1 ? a.gp1 + k * sn : a.gp2 + k * smm;
    const int ld = w1 ? n : m;
    const TS* z_in = k ? a.tz + (k - 1) * smm : a.zeros;
    const TS* lam_in = k ? a.tlam + (k - 1) * smm : a.zeros;
    const TS* uv = w1 ? (k ? a.tax + (k - 1) * smm : a.zeros) : a.tax + k * smm;
    float acc[2][2];
    tile_gemm<false, false>(
        sm, rows, m, row0, col0, s_lo, s_hi, [&](int r, int q) { return __ldg(gp + (size_t)q * ld + r); },
        [&](int c, int q) {
          const size_t o = (size_t)q * m + c;
          const float base = (ldg(z_in + o) - ldg(a.b + o)) + ldg(lam_in + o) * ib;
          return ldg(uv + o) + base;
        },
        acc);
    if (!reduce_slices(sm, acc, a.part, a.cnt, tile, s, slices)) continue;
    TS* out = w1 ? a.gW1 + (size_t)k * n * m : a.gW2 + (size_t)k * m * m;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + tr + i * kPR;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = col0 + tc + j * kPC;
        if (r < rows && c < m) put(out + (size_t)r * m + c, -acc[i][j]);
      }
    }
  }
}

// After the chain: gth1, gth2 and gbeta of every layer from the partials,
// summed in row-tile (gth) or tile (gbeta) order. bf16 rounds gth1, gth2
// once as it stores them, and gbeta where beta is bf16 (gbeta16).
template <class TS>
__global__ void __launch_bounds__(256)
finish(const TS* __restrict__ th1, const TS* __restrict__ th2,
       const float* __restrict__ beta, const __nv_bfloat16* __restrict__ beta16,
       const float* __restrict__ th1_part, const float* __restrict__ th2_part,
       const double* __restrict__ beta_part, TS* __restrict__ gth1, TS* __restrict__ gth2,
       float* __restrict__ gbeta, __nv_bfloat16* __restrict__ gbeta16, int K, int m, int n, int nrb,
       int nblk_u) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < K * n) {
    const int k = i / n, c = i % n;
    const float* p = th1_part + (size_t)k * nrb * n + c;
    float s = 0.0f;
    for (int rb = 0; rb < nrb; ++rb) s += p[(size_t)rb * n];
    put(gth1 + i, -s * tie(ldg(th1 + i), 0.0f));
  } else if (i < K * (n + m)) {
    const int j = i - K * n, k = j / m, c = j % m;
    const float* p = th2_part + (size_t)k * nrb * m + c;
    float s = 0.0f;
    for (int rb = 0; rb < nrb; ++rb) s += p[(size_t)rb * m];
    put(gth2 + j, -s * tie(ldg(th2 + j), 0.0f));
  } else if (i < K * (n + m + 1)) {
    const int k = i - K * (n + m);
    const double* p = beta_part + (size_t)k * nblk_u * 2;
    double s_res = 0.0, s_lam = 0.0;
    for (int q = 0; q < nblk_u; ++q) {
      s_res += p[2 * q];
      s_lam += p[2 * q + 1];
    }
    const float braw = beta_at<TS>(beta, beta16, k);
    const float bt = fmaxf(braw, kBetaMin);
    const double ib = (double)(1.0f / bt);
    const float g = (float)(s_res - s_lam * ib * ib) * tie(braw, kBetaMin);
    if (gbeta16 != nullptr) {
      gbeta16[k] = __float2bfloat16_rn(g);
    } else {
      gbeta[k] = g;
    }
  }
}

// Workspace buffers, in the order ops/schedule.BWD_BUFFERS lists them.
enum Buf { B_GZ, B_GLAM, B_GAX, B_GV, B_GAX1, B_ZEROS, B_GP1, B_GP2, B_TH1P, B_TH2P, B_BETAP,
           B_PART, B_CNT, B_GB, B_COUNT };

// The three launches of one reverse sweep (the C entries below), after
// their workspace is cleared. A refused chain launch runs nothing; its
// error is cleared for later launches' checks and returned.
template <class TS>
int run_bwd(const TS* b, const TS* A, const TS* W1, const TS* W2, const TS* th1, const TS* th2,
            const float* beta, const __nv_bfloat16* beta16, const TS* tx, const TS* tz, const TS* tlam,
            const TS* tax, const TS* gx0, const TS* gz0, const TS* glam0, TS* gW1, TS* gW2, TS* gth1,
            TS* gth2, float* gbeta, __nv_bfloat16* gbeta16, float* gax1_stack, TS* gax1_out, TS* gb_out,
            void* const* bufs, int n_counters, const int* sched, int S, int m, int n, int K, int bs,
            int device, void* stream_handle) {
  constexpr bool S16 = sizeof(TS) == 2;
  if (S < 1 || m < 1 || n < 1 || K < 1 || bs < 1) return (int)cudaErrorInvalidValue;
  if ((beta == nullptr) == (beta16 == nullptr) || (gbeta == nullptr) == (gbeta16 == nullptr))
    return (int)cudaErrorInvalidValue;
  if (S16 ? (gax1_out == nullptr) != (gb_out == nullptr) : (gax1_stack == nullptr) != (gb_out == nullptr))
    return (int)cudaErrorInvalidValue;
  const int grid = sched[0], tile = sched[7];
  if (grid < 1 || sched[2] < 1 || sched[4] < 1 || sched[6] < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (bs > S) bs = S;
  float* ws[B_COUNT];
  for (int i = 0; i < B_COUNT; ++i) ws[i] = static_cast<float*>(bufs[i]);
  int* cnt = reinterpret_cast<int*>(ws[B_CNT]);
  const size_t smb = (size_t)S * m * sizeof(float);
  // fp32 accumulates gb in the caller's output; bf16 in the workspace.
  float* gb = S16 ? (gb_out ? ws[B_GB] : nullptr) : reinterpret_cast<float*>(gb_out);

  ChainArgs<TS> c;
  c.b = b;
  c.A = A;
  c.W1 = W1;
  c.W2 = W2;
  c.beta = beta;
  c.beta16 = beta16;
  c.tx = tx;
  c.tz = tz;
  c.tlam = tlam;
  c.tax = tax;
  c.gx0 = gx0;
  c.gz0 = gz0;
  c.glam0 = glam0;
  c.zeros = reinterpret_cast<const TS*>(ws[B_ZEROS]);
  c.gz = ws[B_GZ];
  c.glam = ws[B_GLAM];
  c.gax = ws[B_GAX];
  c.gv = ws[B_GV];
  c.gax1_stack = gax1_stack != nullptr;
  c.gax1 = gax1_stack ? gax1_stack : ws[B_GAX1];
  c.gax1_out = gax1_out;
  c.gb = gb;
  c.gb_out = S16 ? gb_out : nullptr;
  c.gb_round = bs >= S;
  c.gp1 = ws[B_GP1];
  c.gp2 = ws[B_GP2];
  c.th1p = ws[B_TH1P];
  c.th2p = ws[B_TH2P];
  c.betap = reinterpret_cast<double*>(ws[B_BETAP]);
  c.part = ws[B_PART];
  c.cnt = cnt;
  c.S = S;
  c.m = m;
  c.n = n;
  c.K = K;
  c.sv = Split{sched[1], sched[2]};
  c.sx = Split{sched[3], sched[4]};
  c.su = Split{sched[5], sched[6]};
  int smem = 0;
  const void* fn = chain_kernel<TS>(tile, &smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if constexpr (!S16) {
    if (tile == kWT && !wide_chain_layout(c)) return (int)cudaErrorInvalidValue;
  }

  err = cudaMemsetAsync(ws[B_GAX], 0, smb, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(ws[B_ZEROS], 0, smb, stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(cnt, 0, (size_t)n_counters * sizeof(int), stream);
  if (err == cudaSuccess && gb) err = cudaMemsetAsync(gb, 0, smb, stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&c};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kPT), args, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch: clear it for later launches' checks
    return (int)err;
  }

  WeightArgs<TS> w;
  w.b = b;
  w.tz = tz;
  w.tlam = tlam;
  w.tax = tax;
  w.zeros = reinterpret_cast<const TS*>(ws[B_ZEROS]);
  w.beta = beta;
  w.beta16 = beta16;
  w.gp1 = ws[B_GP1];
  w.gp2 = ws[B_GP2];
  w.gW1 = gW1;
  w.gW2 = gW2;
  w.part = ws[B_PART];
  w.cnt = cnt;
  w.S = S;
  w.m = m;
  w.n = n;
  w.K = K;
  w.bs = bs;
  const int items = K * (cdiv(n, kT) + cdiv(m, kT)) * cdiv(m, kT) * cdiv(S, bs);
  bwd_weights<TS><<<items, kPT, 0, stream>>>(w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int nrb = cdiv(S, tile), total = K * (n + m + 1);  // the chain's row blocks
  finish<TS><<<cdiv(total, 256), 256, 0, stream>>>(
      th1, th2, beta, beta16, ws[B_TH1P], ws[B_TH2P], reinterpret_cast<const double*>(ws[B_BETAP]),
      gth1, gth2, gbeta, gbeta16, K, m, n, nrb, nrb * cdiv(m, tile));
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of bwd_chain<tile, storage> (storage 0: fp32, 1: bf16, which has
// the 32 tile only) resident on one SM, and the card's SMs: the grid
// ceiling of its cooperative launch (ops/schedule.launch_grid).
extern "C" int dladmm_bwd_occupancy(int tile, int storage, int device, int* blocks_per_sm, int* sms) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int smem = 0;
  const void* fn = storage ? chain_kernel<__nv_bfloat16>(tile, &smem) : chain_kernel<float>(tile, &smem);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kPT, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

// Blocks of bwd_weights<storage> resident on one SM, and the card's SMs:
// the wave of the weight-gradient launch (ops/cuda_bwd.bwd_chunk_batch).
extern "C" int dladmm_bwd_weights_occupancy(int storage, int device, int* blocks_per_sm, int* sms) {
  const void* fn = storage ? (const void*)bwd_weights<__nv_bfloat16> : (const void*)bwd_weights<float>;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kPT, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

// The reverse sweep, enqueued on `stream`; no sync. Inputs, fp32,
// contiguous, on `device`: b (S,m), A (m,n), W1 (K,n,m), W2 (K,m,m),
// th1 (K,n), th2 (K,m), beta (K,); the forward's stacks tx (K,S,n),
// tz, tlam, tax (K,S,m); the final-state cotangents gx0 (S,n), gz0,
// glam0 (S,m). Outputs gW1 (K,n,m), gW2 (K,m,m), gth1 (K,n), gth2 (K,m),
// gbeta (K,); with data_grads also the gAx1 stack (K,S,m) and gb (S,m)
// (else both null). bs: rows per S slice of the weight gradients (bs >= S
// is the whole batch). bufs: the workspace's buffers in
// ops/schedule.BWD_BUFFERS order (ops/schedule.bwd_workspace sizes
// them); n_counters ints of counters. sched: the chain's grid, then the
// slices and length of its V, X and U phases, then its tile edge (32, or
// 128 where wide_chain_layout holds). The chain's grid, if the card
// cannot hold it resident, is refused (cudaErrorCooperativeLaunchTooLarge)
// and nothing runs. Returns a cudaError_t.
extern "C" int dladmm_unroll_bwd(
    const float* b, const float* A, const float* W1, const float* W2, const float* th1,
    const float* th2, const float* beta, const float* tx, const float* tz, const float* tlam,
    const float* tax, const float* gx0, const float* gz0, const float* glam0, float* gW1,
    float* gW2, float* gth1, float* gth2, float* gbeta, float* gax1_stack, float* gb,
    void* const* bufs, int n_counters, const int* sched, int S, int m, int n, int K, int bs,
    int device, void* stream_handle) {
  return run_bwd<float>(b, A, W1, W2, th1, th2, beta, nullptr, tx, tz, tlam, tax, gx0, gz0, glam0, gW1, gW2,
                        gth1, gth2, gbeta, nullptr, gax1_stack, nullptr, gb, bufs, n_counters, sched, S, m,
                        n, K, bs, device, stream_handle);
}

// dladmm_unroll_bwd with bf16 storage (bf16 training): b, A, W1, W2,
// th1, th2, the stacks, the cotangents and the outputs gW1, gW2, gth1,
// gth2 are bf16; beta is fp32 (`beta`, then gbeta is fp32) or bf16
// (`beta16`, then `gbeta16` is bf16), the other null. With data_grads
// the bf16 gAx1 stack (K,S,m) and gb (S,m), else both null. The
// cotangent state, the gp stacks and every partial stay fp32 in the
// workspace, which also holds gb's fp32 accumulator (B_GB). Returns a
// cudaError_t.
extern "C" int dladmm_unroll_bwd_bf16(
    const __nv_bfloat16* b, const __nv_bfloat16* A, const __nv_bfloat16* W1, const __nv_bfloat16* W2,
    const __nv_bfloat16* th1, const __nv_bfloat16* th2, const float* beta, const __nv_bfloat16* beta16,
    const __nv_bfloat16* tx, const __nv_bfloat16* tz, const __nv_bfloat16* tlam, const __nv_bfloat16* tax,
    const __nv_bfloat16* gx0, const __nv_bfloat16* gz0, const __nv_bfloat16* glam0, __nv_bfloat16* gW1,
    __nv_bfloat16* gW2, __nv_bfloat16* gth1, __nv_bfloat16* gth2, float* gbeta, __nv_bfloat16* gbeta16,
    __nv_bfloat16* gax1_stack, __nv_bfloat16* gb, void* const* bufs, int n_counters, const int* sched,
    int S, int m, int n, int K, int bs, int device, void* stream_handle) {
  return run_bwd<__nv_bfloat16>(b, A, W1, W2, th1, th2, beta, beta16, tx, tz, tlam, tax, gx0, gz0, glam0,
                                gW1, gW2, gth1, gth2, gbeta, gbeta16, nullptr, gax1_stack, gb, bufs,
                                n_counters, sched, S, m, n, K, bs, device, stream_handle);
}

extern "C" const char* dladmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
