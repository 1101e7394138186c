// fp32 Adam as the optax chain computes it, in place, in one sweep over
// every leaf of a step, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package leaves fp32 Adam (optax's
// clip_by_global_norm or the delayed clip, scale_by_adam,
// scale_by_learning_rate, apply_updates) to XLA, which fuses the chain
// into one pass and donates the state's buffers. PyTorch runs the chain
// eagerly; on a state too large for the whole-leaf update's new tensors
// (tp_large: 4.0B parameters on one card) it ran one layer of a leaf at a
// time, 14 elementwise kernels and a copy back of each new tensor: ~164
// bytes an element. This sweep is the chain in one pass. For each element,
// in place:
//
//   gc  = g                                   (no clip)
//       = trigger ? g : (g / norm) * max_norm   (clip_by_global_norm)
//       = g * scale                           (delayed_clip_by_global_norm)
//   mu' = (1 - b1) * gc + b1 * mu
//   nu' = (1 - b2) * (gc * gc) + b2 * nu
//   p'  = p + ((mu' / c1) / (sqrt(nu' / c2) + eps)) * (-lr)
//
// Each operation is rounded as the eager kernel that computes it rounds
// it, with the round-to-nearest intrinsics (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), which nvcc never contracts into an FMA: p', mu'
// and nu' equal the eager chain's bit for bit. That is not row 6's order
// (qadam_dense.cu: (1 - b2) * g' * g', g * clip_scale), which follows the
// JAX package's Pallas kernel; this one follows the optax chain.
//
// A frozen leaf's gradient is 0 (its g pointer null). The step's scalars
// (c1, c2, -lr; the clip's norm and trigger, or its scale) are 0-d device
// tensors that the wrapper computes with the chain's own torch operations,
// read by pointer: the host never reads them.
//
// Design. The sweep is bound by device memory: 28 bytes an element (g, p,
// mu, nu read once; p, mu, nu written once), 112.8 GB at tp_large, 33.66
// ms at 3.35 TB/s, through a 50 MB L2 that holds none of it twice. So: one
// launch over a table of at most kMaxLeaves leaves, passed by value; a
// grid of as many blocks as the card holds at once, each taking work
// items of kItem elements of one leaf in a grid-stride loop; a thread
// takes two 16-byte accesses of each array a work item, a warp's each 512
// contiguous bytes, all eight loads issued before any arithmetic, so a
// resident thread keeps 128 bytes in flight. Loads and stores are
// streaming (evict-first, __ldcs / __stcs): nothing is read again. Where
// a leaf's pointers are not all 16-byte aligned, and at a leaf's tail,
// the accesses are scalar. Indices are 64-bit (W1 alone is 2.7e9
// elements at tp_large).
//
// Plain C interface, loaded with ctypes (dladmm_tpu_torch/train/qadam_cuda.py
// adam_inplace).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalf = kThreads * 4;  // elements of half a work item: one float4 a thread
constexpr int kItem = 2 * kHalf;     // elements of a work item
constexpr int kMaxLeaves = 8;

enum Clip { CLIP_NONE = 0, CLIP_GLOBAL = 1, CLIP_DELAYED = 2 };

struct Leaf {
  const float* g;   // null: a frozen leaf, whose gradient is 0
  float* p;
  float* mu;
  float* nu;
  long long n;      // elements
  long long item0;  // first work item
  int vec;          // every pointer 16-byte aligned
};

struct Table {
  Leaf leaf[kMaxLeaves];
  long long items;
  int nleaves;
};

struct Scalars {  // 0-d device tensors
  const float* c1;
  const float* c2;
  const float* neg_lr;
  const float* clip;     // the global norm, or the delayed clip's scale
  const bool* trigger;   // the global clip's norm < max_norm
};

struct Coeffs {  // (1 - b1), (1 - b2) rounded once from double, as PyTorch takes a Python scalar
  float b1, omb1, b2, omb2, eps, max_norm;
};

template <int CLIP>
struct Step {
  float c1, c2, neg_lr, clip;
  bool trigger;
  Coeffs k;

  __device__ __forceinline__ void operator()(float g, float& p, float& m, float& v) const {
    float gc = g;
    if (CLIP == CLIP_GLOBAL) gc = trigger ? g : __fmul_rn(__fdiv_rn(g, clip), k.max_norm);
    if (CLIP == CLIP_DELAYED) gc = __fmul_rn(g, clip);
    m = __fadd_rn(__fmul_rn(k.omb1, gc), __fmul_rn(k.b1, m));
    v = __fadd_rn(__fmul_rn(k.omb2, __fmul_rn(gc, gc)), __fmul_rn(k.b2, v));
    const float u = __fdiv_rn(__fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), k.eps));
    p = __fadd_rn(p, __fmul_rn(u, neg_lr));
  }
};

// Four elements from x + i: one 16-byte streaming load when `full`, else
// scalar loads of those below n (0 past it, and everywhere for a null x).
__device__ __forceinline__ float4 load4(const float* x, long long i, long long n, bool full) {
  if (x == nullptr) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (full) return __ldcs(reinterpret_cast<const float4*>(x + i));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < n) v.x = __ldcs(x + i);
  if (i + 1 < n) v.y = __ldcs(x + i + 1);
  if (i + 2 < n) v.z = __ldcs(x + i + 2);
  if (i + 3 < n) v.w = __ldcs(x + i + 3);
  return v;
}

__device__ __forceinline__ void store4(float* x, long long i, long long n, bool full, float4 v) {
  if (full) {
    __stcs(reinterpret_cast<float4*>(x + i), v);
    return;
  }
  if (i < n) __stcs(x + i, v.x);
  if (i + 1 < n) __stcs(x + i + 1, v.y);
  if (i + 2 < n) __stcs(x + i + 2, v.z);
  if (i + 3 < n) __stcs(x + i + 3, v.w);
}

template <int CLIP>
__global__ void __launch_bounds__(kThreads)
adam_inplace_sweep(const __grid_constant__ Table t, const Scalars s, const Coeffs k) {
  const Step<CLIP> step{*s.c1, *s.c2, *s.neg_lr, CLIP == CLIP_NONE ? 0.0f : *s.clip,
                        CLIP == CLIP_GLOBAL ? *s.trigger : false, k};
  for (long long w = blockIdx.x; w < t.items; w += gridDim.x) {
    int li = 0;
#pragma unroll
    for (int j = 1; j < kMaxLeaves; ++j)
      if (j < t.nleaves && w >= t.leaf[j].item0) li = j;
    const Leaf& lf = t.leaf[li];
    const long long i0 = (w - lf.item0) * kItem + 4 * threadIdx.x;
    long long i[2];
    bool full[2];
    float4 g[2], p[2], m[2], v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      i[h] = i0 + h * kHalf;
      full[h] = lf.vec && i[h] + 4 <= lf.n;
      g[h] = load4(lf.g, i[h], lf.n, full[h]);
      p[h] = load4(lf.p, i[h], lf.n, full[h]);
      m[h] = load4(lf.mu, i[h], lf.n, full[h]);
      v[h] = load4(lf.nu, i[h], lf.n, full[h]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (i[h] >= lf.n) continue;
      step(g[h].x, p[h].x, m[h].x, v[h].x);
      step(g[h].y, p[h].y, m[h].y, v[h].y);
      step(g[h].z, p[h].z, m[h].z, v[h].z);
      step(g[h].w, p[h].w, m[h].w, v[h].w);
      store4(lf.p, i[h], lf.n, full[h], p[h]);
      store4(lf.mu, i[h], lf.n, full[h], m[h]);
      store4(lf.nu, i[h], lf.n, full[h], v[h]);
    }
  }
}

const void* sweep(int clip) {
  switch (clip) {
    case CLIP_NONE: return (const void*)adam_inplace_sweep<CLIP_NONE>;
    case CLIP_GLOBAL: return (const void*)adam_inplace_sweep<CLIP_GLOBAL>;
    case CLIP_DELAYED: return (const void*)adam_inplace_sweep<CLIP_DELAYED>;
    default: return nullptr;
  }
}

bool aligned16(const void* x) { return ((uintptr_t)x % 16) == 0; }

}  // namespace

// One fp32 Adam step over `nleaves` leaves, in place, enqueued on
// `stream`; no sync. ptrs holds g, p, mu, nu a leaf (g null for a frozen
// leaf), ns each leaf's elements; c1, c2 and neg_lr are fp32 device
// scalars; clip is 0 (none), 1 (global: clip_value the norm, trigger a
// bool on the device, max_norm the limit) or 2 (delayed: clip_value the
// scale). b1, omb1 = 1 - b1, b2, omb2 = 1 - b2 and eps as the chain's
// Python scalars rounded to fp32. Returns a cudaError_t; a refused launch
// runs nothing and its error is cleared for later launches' checks.
extern "C" int dladmm_adam_inplace(const long long* ptrs, const long long* ns, int nleaves, const float* c1,
                                   const float* c2, const float* neg_lr, const float* clip_value,
                                   const bool* trigger, int clip, float b1, float omb1, float b2, float omb2,
                                   float eps, float max_norm, int device, void* stream_handle) {
  const void* fn = sweep(clip);
  if (fn == nullptr || nleaves < 1 || nleaves > kMaxLeaves || c1 == nullptr || c2 == nullptr ||
      neg_lr == nullptr || (clip != CLIP_NONE && clip_value == nullptr) || (clip == CLIP_GLOBAL && trigger == nullptr))
    return (int)cudaErrorInvalidValue;
  Table t{};
  t.nleaves = nleaves;
  long long items = 0;
  for (int li = 0; li < nleaves; ++li) {
    Leaf& lf = t.leaf[li];
    lf.g = reinterpret_cast<const float*>(ptrs[4 * li]);
    lf.p = reinterpret_cast<float*>(ptrs[4 * li + 1]);
    lf.mu = reinterpret_cast<float*>(ptrs[4 * li + 2]);
    lf.nu = reinterpret_cast<float*>(ptrs[4 * li + 3]);
    lf.n = ns[li];
    if (lf.n < 1 || lf.p == nullptr || lf.mu == nullptr || lf.nu == nullptr) return (int)cudaErrorInvalidValue;
    lf.vec = (lf.g == nullptr || aligned16(lf.g)) && aligned16(lf.p) && aligned16(lf.mu) && aligned16(lf.nu);
    lf.item0 = items;
    items += (lf.n + kItem - 1) / kItem;
  }
  t.items = items;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int blocks_per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, fn, kThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long resident = (long long)(blocks_per_sm > 0 ? blocks_per_sm : 1) * (sms > 0 ? sms : 1);
  const unsigned grid = (unsigned)(items < resident ? items : resident);
  Scalars s{c1, c2, neg_lr, clip_value, trigger};
  Coeffs k{b1, omb1, b2, omb2, eps, max_norm};
  void* args[] = {(void*)&t, (void*)&s, (void*)&k};
  err = cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream_handle));
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

extern "C" const char* dladmm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
