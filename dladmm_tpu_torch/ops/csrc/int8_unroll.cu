// int8 whole-unroll D-LADMM inference for Hopper (sm_90a): one persistent
// cooperative launch a call, its products on the int8 tensor cores.
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
//   x1   = shrink(x - (u_q W1_q^T) * s_u * W1_s, theta1)   x phase   (S,m)x(m,n)
//   Ax1  = (x1_q A_q^T) * s_x * A_s                         Ax phase  (S,n)x(n,m)
//   v    = Ax1 + base                                        (x1, v quantized as u)
//   z1   = shrink(z - (v_q W2_q^T) * s_v * W2_s, theta2)    z phase   (S,m)x(m,m)
//   lam1 = lam + beta (Ax1 + z1 - b)
//
// Design. All K layers run in one cooperative launch with a grid
// barrier between dependent phases: a first phase writes layer 0's u and
// its row maxima, then three GEMM phases a layer (3K barriers a call).
// A row's scale needs the whole row's max |.|, but a max does not depend
// on the order its elements are combined in, so quantization needs no
// phase of its own: the epilogue that writes an activation (u, x1 or v)
// stores it in fp32 and folds its outputs' |.| into that row's maximum
// with an integer atomicMax on the float's bits (for floats >= 0 the int
// order is the float order: exact, and a repeat gives the same bits).
// The consuming phase, after the barrier, quantizes its operand as it
// stages it into shared memory. The u of layer k + 1 is formed in layer
// k's z epilogue, with beta_{k+1}; v in the Ax epilogue, from the old z
// and lam. Each phase is a tiled GEMM on mma.sync m16n8k32 s8 x s8 -> s32
// (row-major activations, weights stored (N, depth): the "col" operand
// as it is) over T x T output tiles (T = 32 or 64, chosen by
// ops/schedule.int8_plan), 8 warps a block, 64-byte depth steps
// double-buffered in shared memory with the next step's loads in
// registers. Where the tiles are few, the plan cuts the depth into
// slices: each slice stores an int32 partial tile and the last block to
// finish the tile (an integer counter per tile, reset by that block) sums
// them and runs the epilogue. Int32 sums are exact in any order (|code|
// <= 127 and depth <= 2000: |sum| < 2^31), so slices and tensor cores
// keep the result bit for bit. Weight rows are not padded (250 bytes at
// synthetic_small): they are staged by the widest word their depth and
// base allow (4, 2 or 1 bytes), zero past the slice's end.
//
// Per-row maxima. Three sets, one per activation: the Ax phase clears
// u's (its last reader, the x phase, is behind a barrier; the z phase
// writes it next), the z phase x1's, the x phase v's, the first phase
// x1's and the split-K counters. So nothing is cleared before the
// launch: the wrapper enqueues this one kernel and nothing else.
//
// Races. The x epilogue reads x elementwise before it writes it; the z
// epilogue z and lam; the Ax epilogue reads the old z and lam, which the
// z phase overwrites only after the next barrier. The operands cross
// rows only through the u, x1 and v buffers, each written one phase
// before it is read. State written in the call is read with __ldcg (L2,
// never a stale L1 line); weights, scales and b with __ldg.
//
// Bits. The kernel computes what its plain version
// (ops/cuda_int8.int8_unroll_forward_plain) computes, operation for
// operation: round-to-nearest intrinsics (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn), which nvcc never contracts into FMAs, in the
// plain version's order; codes rint(v / den) rounded half to even as
// torch.round, where v * (1 / den) decides the code unless it lies within
// 2^-14 of a half-integer and the correctly rounded division does (code()
// below: the same integer, a division for about 1 element in 8000);
// dequantization (acc * s_row) * s_col with the int32 sum converted by
// __int2float_rn (exact below 2^24; above, rounded as the plain version's
// int32 -> fp32 cast); the constants 1/127, 1e-12 and 1e-6 rounded from
// double as Python's are. A last-bit difference would flip a code and
// travel through every later layer, so none is allowed.
//
// Bound. Per call 2*S*m*(2n+m)*K integer operations; bytes: the int8
// weights and A, their scales, b and the fp32 outputs. Against the
// H100's int8 tensor-core peak both are microseconds at the serving
// shapes (PERF.md). What holds the kernel back at small S is its serial
// depth: 3K + 1 phases, each a grid barrier, a trip to L2 for the staged
// operand and three more for split-K (the partials' fence, the tile's
// counter, the last block's loads) before the epilogue. At synthetic_large
// it is the staging: every column tile reads and quantizes its rows'
// fp32 operand again (4 bytes a code). mma.sync reaches a fraction of the
// peak that wgmma would; wgmma needs 64-row tiles, which serving's
// S = 1-256 does not fill.
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/ops/cuda_int8.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Python rounds these from doubles to fp32 at use; so does the kernel.
constexpr float kInv127 = (float)(1.0 / 127.0);
constexpr float kTiny = (float)1e-12;
constexpr float kBetaMin = (float)1e-6;

constexpr int kThreads = 256;        // 8 warps: 2 (rows) x 4 (columns)
constexpr int kBK = 64;              // bytes of depth a staging step (ops/schedule.py INT8_BK)
constexpr int kWords = kBK / 4;      // 32-bit words of codes a row a step
constexpr int kLdw = kWords + 4;     // shared row stride in words: fragment reads conflict-free
constexpr int kAlign = 64;           // workspace buffers on 64-word boundaries (ops/schedule.py ALIGN)

enum Phase { PHASE_X = 0, PHASE_AX = 1, PHASE_Z = 2 };
enum Buffer { BUF_U = 0, BUF_V, BUF_AX, BUF_AMAX, BUF_PARTIALS, BUF_COUNTERS, BUF_TOTAL };

__device__ __forceinline__ int dcdiv(int a, int b) { return (a + b - 1) / b; }

struct Split {
  int slices, len;                   // depth slices of a phase and their length in bytes
};

struct Int8Args {
  const float* b;                    // (S, m)
  const int8_t *A_q, *W1_q, *W2_q;   // (m, n), (K, n, m), (K, m, m)
  const float *A_s, *W1_s, *W2_s;    // (m,), (K, n), (K, m)
  const float *th1, *th2, *beta;     // th[k * th_k + c * th_c], beta[k * beta_k]
  int th1_k, th1_c, th2_k, th2_c, beta_k;
  float *x, *z, *lam;                // outputs (S, n), (S, m), (S, m), updated in place
  float *u, *v, *ax;                 // (S, m) each
  int *amax_u, *amax_x, *amax_v;     // (S,) each: a row's max |.| as float bits
  int* part;                         // split-K int32 partials: T x T an item
  int* cnt;                          // one counter a tile
  int n_counters, S, m, n, K;
  Split sx, sax, sz;
};

template <int T>
struct Smem {
  unsigned op[2][T][kLdw];           // double-buffered operand codes, 4 a word
  unsigned w[2][T][kLdw];            // and weight codes
  int last;                          // this block finishes the tile (split-K)
};

__device__ __forceinline__ float shrink(float u, float theta) {
  const float s = fmaxf(__fsub_rn(fabsf(u), fmaxf(theta, 0.0f)), 0.0f);
  return u > 0.0f ? s : (u < 0.0f ? -s : 0.0f);
}

// (acc * s_row) * s_col, as the plain version's (acc * s_act) * w_s.
__device__ __forceinline__ float dequant(int acc, float s_row, float s_col) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s_row), s_col);
}

__device__ __forceinline__ float inv_beta_of(float beta) { return __fdiv_rn(1.0f, beta); }

// (z - b) + lam * (1 / beta)
__device__ __forceinline__ float base_of(float z, float b, float lam, float inv_beta) {
  return __fadd_rn(__fsub_rn(z, b), __fmul_rn(lam, inv_beta));
}

__device__ __forceinline__ float row_scale(const int* amax, int r) {
  return __fmul_rn(__int_as_float(__ldcg(amax + r)), kInv127);
}

// The code rint(v / den) of the plain version, whose quotient is
// correctly rounded before it is rounded to an integer. q = v * (1 / den)
// (both rounded) is within 2^-23 |v / den| <= 1.6e-5 of the exact
// quotient, and the rounded quotient within half an ulp (3.9e-6) of it
// (|v| <= max|row|, so |v / den| < 127.01). Where q lies further than
// kNearHalf = 2^-14 from every half-integer, q, the quotient and its
// rounding round to the same integer; nearer, the division decides. The
// division runs for about 1 element in 8000, instead of for every one.
constexpr float kNearHalf = 1.0f / 16384.0f;

__device__ __forceinline__ unsigned code(float v, float den, float rden) {
  const float q = __fmul_rn(v, rden);
  const float f = fabsf(__fsub_rn(q, rintf(q)));
  const int c = f > 0.5f - kNearHalf ? __float2int_rn(__fdiv_rn(v, den)) : __float2int_rn(q);
  return (unsigned)(c & 0xff);
}

// D += A * B on one m16n8k32 tile: A 16 x 32 s8 row-major, B 32 x 8 s8
// column-major, D 16 x 8 s32.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Bytes of the widest aligned word of a row of `depth` bytes from `base`.
__device__ __forceinline__ int word_align(const void* base, int depth) {
  const unsigned bits = (unsigned)(uintptr_t)base | (unsigned)depth;
  return (bits & 3) == 0 ? 4 : ((bits & 1) == 0 ? 2 : 1);
}

// Four codes of a weight row from byte k, zero at and past k_hi (k_hi is
// a multiple of `align` bytes, as the depth and every slice end are).
__device__ __forceinline__ unsigned load_w(const int8_t* row, int k, int k_hi, int align) {
  if (align == 4) return k < k_hi ? __ldg(reinterpret_cast<const unsigned*>(row + k)) : 0u;
  if (align == 2) {
    const unsigned lo = k < k_hi ? __ldg(reinterpret_cast<const unsigned short*>(row + k)) : 0u;
    const unsigned hi = k + 2 < k_hi ? __ldg(reinterpret_cast<const unsigned short*>(row + k + 2)) : 0u;
    return lo | (hi << 16);
  }
  unsigned w = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (k + q < k_hi) w |= (unsigned)(uint8_t)__ldg(row + k + q) << (8 * q);
  return w;
}

// Four fp32 operand values of a row from element k, zero at and past
// k_hi; `align` (4, 2, 1 floats) as load_w's.
__device__ __forceinline__ void load_op(const float* row, int k, int k_hi, int align, float (&v)[4]) {
  if (align == 4) {
    const float4 f = k < k_hi ? __ldcg(reinterpret_cast<const float4*>(row + k)) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else if (align == 2) {
    const float2 lo = k < k_hi ? __ldcg(reinterpret_cast<const float2*>(row + k)) : make_float2(0.f, 0.f);
    const float2 hi = k + 2 < k_hi ? __ldcg(reinterpret_cast<const float2*>(row + k + 2)) : make_float2(0.f, 0.f);
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = k + q < k_hi ? __ldcg(row + k + q) : 0.0f;
  }
}

// acc = q(OP)[row0:+T, k_lo:k_hi] * W[col0:+T, k_lo:k_hi]^T for one tile:
// OP (S, depth) fp32 quantized by its rows' maxima as it is staged, W
// (N, depth) int8, kBK bytes of depth a step. Thread tid stages word
// tid % kWords of rows tid / kWords + e * (kThreads / kWords). Warp (wm,
// wn) owns rows wm * T / 2 + [0, T / 2) and columns wn * T / 4 + [0, T / 4).
template <int T>
__device__ __forceinline__ void tile_mma(Smem<T>& sm, const float* op, const int* amax, int S, int row0,
                                         const int8_t* w, int N, int col0, int depth, int k_lo, int k_hi,
                                         int (&acc)[T / 32][T / 32][4]) {
  constexpr int MF = T / 32, NF = T / 32, E = T * kWords / kThreads;  // E: words a thread stages
  constexpr int kRowStep = kThreads / kWords;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 4, wn = warp % 4;
  const int oal = depth % 4 == 0 ? 4 : (depth % 2 == 0 ? 2 : 1);
  const int wal = word_align(w, depth);
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  const int wd = tid % kWords, rr0 = tid / kWords;
  float den[E], rden[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int r = row0 + rr0 + e * kRowStep;
    den[e] = r < S ? fmaxf(row_scale(amax, r), kTiny) : 1.0f;
    rden[e] = __frcp_rn(den[e]);
  }
  float ro[E][4];
  unsigned rw[E];
  auto fetch = [&](int k0) {
    const int k = k0 + 4 * wd;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int r = row0 + rr0 + e * kRowStep, c = col0 + rr0 + e * kRowStep;
      if (r < S) {
        load_op(op + (size_t)r * depth, k, k_hi, oal, ro[e]);
      } else {
        ro[e][0] = ro[e][1] = ro[e][2] = ro[e][3] = 0.0f;
      }
      rw[e] = c < N ? load_w(w + (size_t)c * depth, k, k_hi, wal) : 0u;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int rr = rr0 + e * kRowStep;
      sm.op[buf][rr][wd] = code(ro[e][0], den[e], rden[e]) | code(ro[e][1], den[e], rden[e]) << 8 |
                           code(ro[e][2], den[e], rden[e]) << 16 | code(ro[e][3], den[e], rden[e]) << 24;
      sm.w[buf][rr][wd] = rw[e];
    }
  };
  __syncthreads();  // the previous item may still read the buffers or sm.last
  fetch(k_lo);
  stash(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    const bool more = k0 + kBK < k_hi;
    if (more) fetch(k0 + kBK);
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      unsigned a[MF][4], bf[NF][2];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const int r = wm * (T / 2) + i * 16 + g;
        a[i][0] = sm.op[buf][r][ks * 8 + t];
        a[i][1] = sm.op[buf][r + 8][ks * 8 + t];
        a[i][2] = sm.op[buf][r][ks * 8 + 4 + t];
        a[i][3] = sm.op[buf][r + 8][ks * 8 + 4 + t];
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const int c = wn * (T / 4) + j * 8 + g;
        bf[j][0] = sm.w[buf][c][ks * 8 + t];
        bf[j][1] = sm.w[buf][c][ks * 8 + 4 + t];
      }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_s8(acc[i][j], a[i], bf[j]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
}

// Split-K: each slice stores its int32 partial tile (in the threads'
// fragment order, no atomics on the data); the last block to arrive at
// the tile's counter sums them in slice order, up to four slices' loads in
// flight at once, and resets the counter. Int32 sums are exact, so any
// order gives the same bits; plain stores measured faster than integer
// atomics into one sum (PERF.md, PR 8). Returns whether this block now
// holds the tile's full sum (always, for one slice). Block-uniform.
template <int T>
__device__ __forceinline__ bool reduce_slices(Smem<T>& sm, int (&acc)[T / 32][T / 32][4], int* part,
                                              int* cnt, int tile, int slice, int slices) {
  constexpr int NACC = (T / 32) * (T / 32) * 4;
  if (slices == 1) return true;
  const int tid = threadIdx.x;
  int* p = part + (size_t)tile * slices * (T * T) + tid;
  int* flat = &acc[0][0][0];
#pragma unroll
  for (int e = 0; e < NACC; ++e) __stcg(p + (size_t)slice * (T * T) + e * kThreads, flat[e]);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(cnt + tile, 1);
    sm.last = done == slices - 1;
    if (sm.last) cnt[tile] = 0;  // next used after a grid barrier
  }
  __syncthreads();
  if (!sm.last) return false;
  __threadfence();
#pragma unroll
  for (int e = 0; e < NACC; ++e) flat[e] = 0;
  for (int z0 = 0; z0 < slices; z0 += 4) {
    int v[4][NACC];
#pragma unroll
    for (int dz = 0; dz < 4; ++dz)
#pragma unroll
      for (int e = 0; e < NACC; ++e)
        v[dz][e] = z0 + dz < slices ? __ldcg(p + (size_t)(z0 + dz) * (T * T) + e * kThreads) : 0;
#pragma unroll
    for (int dz = 0; dz < 4; ++dz)
#pragma unroll
      for (int e = 0; e < NACC; ++e) flat[e] += v[dz][e];
  }
  return true;
}

// Set a vector to 0, spread over the whole grid.
__device__ __forceinline__ void clear(int* p, int count) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < count; i += gridDim.x * kThreads) p[i] = 0;
}

// The first phase: layer 0's u = (0 - b) + 0 * (1 / beta_0) + 0 (the zero
// state, in the plain version's operations) and its row maxima, one warp
// a row; clears x1's maxima and the counters.
__device__ void first_phase(const Int8Args& a) {
  clear(a.amax_x, a.S);
  clear(a.cnt, a.n_counters);
  const float inv_beta = inv_beta_of(fmaxf(__ldg(a.beta), kBetaMin));
  const int lane = threadIdx.x % 32;
  for (int r = (blockIdx.x * kThreads + threadIdx.x) / 32; r < a.S; r += gridDim.x * (kThreads / 32)) {
    float mx = 0.0f;
    for (int c = lane; c < a.m; c += 32) {
      const size_t o = (size_t)r * a.m + c;
      const float u = __fadd_rn(0.0f, base_of(0.0f, __ldg(a.b + o), 0.0f, inv_beta));
      a.u[o] = u;
      mx = fmaxf(mx, fabsf(u));
    }
#pragma unroll
    for (int d = 16; d > 0; d /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    if (lane == 0) a.amax_u[r] = __float_as_int(mx);
  }
}

// One GEMM phase of layer k over all its items.
template <int PHASE, int T>
__device__ void int8_phase(const Int8Args& a, Smem<T>& sm, int k) {
  constexpr int MF = T / 32, NF = T / 32;
  const int S = a.S, m = a.m, n = a.n;
  const int N = PHASE == PHASE_X ? n : m, depth = PHASE == PHASE_AX ? n : m;
  const Split sp = PHASE == PHASE_X ? a.sx : (PHASE == PHASE_AX ? a.sax : a.sz);
  const float* op = PHASE == PHASE_X ? a.u : (PHASE == PHASE_AX ? a.x : a.v);
  const int* amax_in = PHASE == PHASE_X ? a.amax_u : (PHASE == PHASE_AX ? a.amax_x : a.amax_v);
  int* amax_out = PHASE == PHASE_X ? a.amax_x : (PHASE == PHASE_AX ? a.amax_v : a.amax_u);
  const int8_t* w = PHASE == PHASE_X ? a.W1_q + (size_t)k * n * m
                                     : (PHASE == PHASE_AX ? a.A_q : a.W2_q + (size_t)k * m * m);
  const float* w_s = PHASE == PHASE_X ? a.W1_s + (size_t)k * n : (PHASE == PHASE_AX ? a.A_s : a.W2_s + (size_t)k * m);
  const float* th = PHASE == PHASE_X ? a.th1 + (size_t)k * a.th1_k : a.th2 + (size_t)k * a.th2_k;
  const int th_c = PHASE == PHASE_X ? a.th1_c : a.th2_c;
  const float beta = fmaxf(__ldg(a.beta + (size_t)k * a.beta_k), kBetaMin), inv_beta = inv_beta_of(beta);
  const bool next = k + 1 < a.K;  // the z phase forms the next layer's u
  const float inv_beta_next =
      next ? inv_beta_of(fmaxf(__ldg(a.beta + (size_t)(k + 1) * a.beta_k), kBetaMin)) : 1.0f;
  const bool zero = k == 0;  // layer 0 reads the zero state

  // The set the next phase writes: its last reader is behind a barrier.
  clear(PHASE == PHASE_X ? a.amax_v : (PHASE == PHASE_AX ? a.amax_u : a.amax_x), S);

  const int ct = dcdiv(N, T), items = dcdiv(S, T) * ct * sp.slices;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 4, wn = warp % 4;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it / sp.slices, s = it % sp.slices;
    const int row0 = tile / ct * T, col0 = tile % ct * T;
    const int k_lo = s * sp.len, k_hi = min(depth, k_lo + sp.len);
    int acc[MF][NF][4];
    tile_mma<T>(sm, op, amax_in, S, row0, w, N, col0, depth, k_lo, k_hi, acc);
    // Epilogue: fragment (i, j), element 2h + q is row g + 8h and column
    // 2t + q of its m16n8 tile. Its inputs do not depend on the sum: the
    // columns' scales and thresholds, and at the 32 tile every input,
    // are loaded before the reduction, so that their latency overlaps it.
    float wsv[NF][2], thv[NF][2];
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int c = col0 + wn * (T / 4) + j * 8 + 2 * t + q;
        wsv[j][q] = c < N ? __ldg(w_s + c) : 0.0f;
        thv[j][q] = PHASE != PHASE_AX && c < N ? __ldg(th + (size_t)c * th_c) : 0.0f;
      }
    // The row's scale and each output's state: x_in (x phase); z_in,
    // lam_in, b (Ax phase); z_in, lam_in, b, Ax1 (z phase).
    auto inputs = [&](int i, int h, float& s_row, float (&e)[NF][2][4]) {
      const int r = row0 + wm * (T / 2) + i * 16 + g + 8 * h;
      s_row = r < S ? row_scale(amax_in, r) : 0.0f;
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = col0 + wn * (T / 4) + j * 8 + 2 * t + q;
          float* v = e[j][q];
          v[0] = v[1] = v[2] = v[3] = 0.0f;
          if (r >= S || c >= N) continue;
          if constexpr (PHASE == PHASE_X) {
            if (!zero) v[0] = __ldcg(a.x + (size_t)r * n + c);
          } else {
            const size_t o = (size_t)r * m + c;
            if (!zero) {
              v[0] = __ldcg(a.z + o);
              v[1] = __ldcg(a.lam + o);
            }
            v[2] = __ldg(a.b + o);
            if (PHASE == PHASE_Z) v[3] = __ldcg(a.ax + o);
          }
        }
    };
    // One row's outputs, and its max |.| folded into amax_out.
    auto outputs = [&](int i, int h, float s_row, const float (&e)[NF][2][4]) {
      const int r = row0 + wm * (T / 2) + i * 16 + g + 8 * h;
      float mx = 0.0f;
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = col0 + wn * (T / 4) + j * 8 + 2 * t + q;
          if (r >= S || c >= N) continue;
          const float y = dequant(acc[i][j][2 * h + q], s_row, wsv[j][q]);
          const float* v = e[j][q];
          if constexpr (PHASE == PHASE_X) {
            const float x1 = shrink(__fsub_rn(v[0], y), thv[j][q]);
            a.x[(size_t)r * n + c] = x1;
            mx = fmaxf(mx, fabsf(x1));
          } else if constexpr (PHASE == PHASE_AX) {
            const size_t o = (size_t)r * m + c;
            const float vv = __fadd_rn(y, base_of(v[0], v[2], v[1], inv_beta));
            a.ax[o] = y;
            a.v[o] = vv;
            mx = fmaxf(mx, fabsf(vv));
          } else {
            const size_t o = (size_t)r * m + c;
            const float z1 = shrink(__fsub_rn(v[0], y), thv[j][q]);
            // lam + beta * ((Ax1 + z1) - b)
            const float lam1 = __fadd_rn(v[1], __fmul_rn(beta, __fsub_rn(__fadd_rn(v[3], z1), v[2])));
            a.z[o] = z1;
            a.lam[o] = lam1;
            if (next) {
              const float u = __fadd_rn(v[3], base_of(z1, v[2], lam1, inv_beta_next));
              a.u[o] = u;
              mx = fmaxf(mx, fabsf(u));
            }
          }
        }
      // The row's max over the 4 threads that hold it, then one atomic.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (t == 0 && r < S && (PHASE != PHASE_Z || next)) atomicMax(amax_out + r, __float_as_int(mx));
    };
    if constexpr (T == 32) {
      float s_row[MF][2], e[MF][2][NF][2][4];
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) inputs(i, h, s_row[i][h], e[i][h]);
      if (!reduce_slices<T>(sm, acc, a.part, a.cnt, tile, s, sp.slices)) continue;
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) outputs(i, h, s_row[i][h], e[i][h]);
    } else {
      if (!reduce_slices<T>(sm, acc, a.part, a.cnt, tile, s, sp.slices)) continue;
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s_row, e[NF][2][4];
          inputs(i, h, s_row, e);
          outputs(i, h, s_row, e);
        }
    }
  }
}

// All K layers in one cooperative launch. Both tiles ask for 2 blocks a
// SM: at 64 registers the 32 tile spilled, and every serving bucket
// (S <= 256) ran slower on its 4 blocks a SM (PERF.md, PR 8).
template <int T>
__global__ void __launch_bounds__(kThreads, 2) int8_persistent(const Int8Args a) {
  __shared__ Smem<T> sm;
  cg::grid_group grid = cg::this_grid();
  first_phase(a);
  for (int k = 0; k < a.K; ++k) {
    grid.sync();
    int8_phase<PHASE_X, T>(a, sm, k);
    grid.sync();
    int8_phase<PHASE_AX, T>(a, sm, k);
    grid.sync();
    int8_phase<PHASE_Z, T>(a, sm, k);
  }
}

// The instantiation of a tile edge, or null.
const void* int8_kernel(int tile) {
  if (tile == 32) return (const void*)int8_persistent<32>;
  if (tile == 64) return (const void*)int8_persistent<64>;
  return nullptr;
}

long long acdiv(long long a, long long b) { return (a + b - 1) / b; }

// The layout rules of a plan (ops/schedule.int8_plan computes the same):
// each phase's slices of a whole number of kBK steps partition its
// depth; the workspace holds u, v, Ax (S x m floats each), the three
// row-maxima vectors (3S), the int32 partials of the largest split phase
// (items x T x T) and a counter a tile of the widest split phase, in that
// order, each on a kAlign-word boundary. Fills `want` with the offsets
// (BUF_TOTAL: the words to allocate); false if a split breaks a rule.
bool lay_out(int S, int m, int n, int tile, const Split (&sp)[3], long long (&want)[BUF_TOTAL + 1],
             int* n_counters) {
  const int cols[3] = {n, m, m}, depth[3] = {m, n, m};
  long long partials = 0, counters = 0;
  for (int p = 0; p < 3; ++p) {
    if (sp[p].len < kBK || sp[p].len % kBK != 0 || sp[p].slices != acdiv(depth[p], sp[p].len)) return false;
    const long long tiles = acdiv(S, tile) * acdiv(cols[p], tile);
    if (sp[p].slices > 1) {
      const long long words = tiles * sp[p].slices * tile * tile;
      partials = partials > words ? partials : words;
      counters = counters > tiles ? counters : tiles;
    }
  }
  const long long sizes[BUF_TOTAL] = {(long long)S * m, (long long)S * m, (long long)S * m, 3LL * S, partials,
                                      counters};
  long long off = 0;
  for (int i = 0; i < BUF_TOTAL; ++i) {
    want[i] = off;
    off += acdiv(sizes[i], kAlign) * kAlign;
  }
  want[BUF_TOTAL] = off;
  *n_counters = (int)counters;
  return off < (1LL << 40);
}

}  // namespace

// All K layers of the int8 inference unroll, as one cooperative launch of
// `grid` blocks of the `tile` (32 or 64) kernel on `stream`; no sync, no
// memset. Inputs: b (S,m) fp32; A_q (m,n) int8, A_s (m,); W1_q (K,n,m)
// int8, W1_s (K,n); W2_q (K,m,m) int8, W2_s (K,m); contiguous; thresholds
// read at th[k * th_k + c * th_c] (th_c = 0: a (K,1) scalar), beta at
// beta[k * beta_k]; all on `device`. Outputs x (S,n), z (S,m), lam (S,m).
// Workspace `work` of ws_total words with its buffers at the ws_*
// offsets in words (ops/schedule.int8_plan). sched: the depth slices and
// their length in bytes for the x, Ax and z phases. A plan
// that breaks lay_out's rules is refused (cudaErrorInvalidValue), as is a
// grid the card cannot hold resident (cudaErrorCooperativeLaunchTooLarge),
// before anything runs; a refused launch's error is cleared. Returns a
// cudaError_t.
extern "C" int dladmm_int8_unroll_forward(
    const float* b, const int8_t* A_q, const float* A_s, const int8_t* W1_q, const float* W1_s,
    const int8_t* W2_q, const float* W2_s, const float* th1, const float* th2, const float* beta,
    float* x, float* z, float* lam, float* work, int ws_u, int ws_v, int ws_ax, int ws_amax,
    int ws_partials, int ws_counters, int ws_total, int th1_k, int th1_c, int th2_k, int th2_c,
    int beta_k, int S, int m, int n, int K, int tile, int grid,
    int x_slices, int x_len, int ax_slices, int ax_len, int z_slices, int z_len, int device,
    void* stream_handle) {
  const void* fn = int8_kernel(tile);
  const long long ws[BUF_TOTAL + 1] = {ws_u, ws_v, ws_ax, ws_amax, ws_partials, ws_counters, ws_total};
  const Split sp[3] = {{x_slices, x_len}, {ax_slices, ax_len}, {z_slices, z_len}};
  long long want[BUF_TOTAL + 1];
  int n_counters = 0;
  if (fn == nullptr || S < 1 || m < 1 || n < 1 || K < 1 || grid < 1 ||
      !lay_out(S, m, n, tile, sp, want, &n_counters))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i <= BUF_TOTAL; ++i)
    if (ws[i] != want[i]) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int* amax = reinterpret_cast<int*>(work + ws[BUF_AMAX]);
  Int8Args a{b, A_q, W1_q, W2_q, A_s, W1_s, W2_s, th1, th2, beta,
             th1_k, th1_c, th2_k, th2_c, beta_k, x, z, lam,
             work + ws[BUF_U], work + ws[BUF_V], work + ws[BUF_AX], amax, amax + S, amax + 2 * S,
             reinterpret_cast<int*>(work + ws[BUF_PARTIALS]), reinterpret_cast<int*>(work + ws[BUF_COUNTERS]),
             n_counters, S, m, n, K, sp[0], sp[1], sp[2]};
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream_handle));
  if (err != cudaSuccess) cudaGetLastError();  // a refused launch: clear it for later launches' checks
  return (int)err;
}

// Blocks of int8_persistent<tile> resident on one SM, and the card's SMs:
// the grid ceiling of its cooperative launch (ops/schedule.int8_plan).
extern "C" int dladmm_int8_occupancy(int tile, int device, int* blocks_per_sm, int* sms) {
  const void* fn = int8_kernel(tile);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  return (int)err;
}

extern "C" const char* dladmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
