// Fused RMSNorm and LayerNorm forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/fused_norms.py ::
// _rms_kernel and _ln_kernel (launched by _row_call).  What they compute,
// for x reshaped to [R, H]: each row in f32,
//   RMSNorm    y = (x * rsqrt(mean(x^2) + eps)) * w
//   LayerNorm  y = ((x - mu) * rsqrt(mean((x - mu)^2) + eps)) * w + b,
// mu = mean(x), the variance taken in a second pass over x - mu as _ln_ref
// takes it (not Welford), and y written in x's type.  x is float or
// bfloat16; w and b are each float or bfloat16, independently of x (f32
// master weights against bf16 activations).
//
// What bounds it: memory bandwidth.  It moves R * H * (in + out) bytes of x
// and y plus the H-vectors, and does a handful of flops per element, far
// below the card's ~295 flop/byte ridge.  So the design moves each byte of
// x once and keeps bytes in flight:
//
// fused_norm_walk_kernel, every row that fits a shared-memory slot (with
// 1 KB of barriers, 227 KB: H <= 57,856 in f32, 115,712 in bf16).  A
// persistent grid of 256-thread blocks; a block holds `teams` row teams of
// `team_warps` warps (one warp a row, several at a few rows), and team g of
// G walks rows g, g + G, ...  Each team owns a ring of `stages` row slots:
// its first thread bulk-copies (cp.async.bulk, one copy a row) its next
// rows into them, each slot on its own mbarrier, while the team reduces the
// rows that have arrived.  The team reads its slot as 16-byte vectors
// (vector i to the team's thread i % team threads) for the sum, again for
// LayerNorm's variance, and once more for the output: x comes from device
// memory once.  The weight and bias are bulk-copied into shared memory once
// a block, in their own types, and converted on use; they are waited for
// only before the first row's output, so their copy overlaps the first
// reduction.  A block whose slots and vectors do not fit together reads the
// vectors from device memory (L2) instead (kStaged false).  Sums reduce in a
// fixed order (each thread's vectors into kVec partial sums, those in a
// fixed tree, an xor-shuffle tree in each warp, the team's warps in order
// through shared memory and a named barrier), so repeated launches give
// identical bits; a team of one warp has no barrier inside a row.  The
// host's plan (paddle_tpu_torch/ops/fused_norms.py, _norm_plan) picks the
// team width, teams, stages, grid and shared bytes.
//
// fused_norm_kernel, rows wider than a slot (PR 6's first version): one
// block per row, each thread keeping up to kMaxVecs 16-byte vectors in
// registers across the passes and re-reading the rest of the row in each.
//
// In both, the multiplies and adds of the output are rounded one by one
// (__fmul_rn, __fadd_rn), never contracted into FMAs, as the plain version
// computes them, and y leaves as 16-byte stores from registers.
//
// Entry points (plain C, bound with ctypes by
// paddle_tpu_torch/ops/fused_norms.py, which has checked shapes, types,
// contiguity and 16-byte alignment): paddle_fused_rms_norm and
// paddle_fused_layer_norm; dtype codes 0 = float32, 1 = bfloat16; the plan
// as (path: 0 the row kernel, 1 the walk reading the vectors from device
// memory, 2 the walk with the vectors staged; threads, team_warps, stages,
// grid, shared bytes); each returns cudaGetLastError() after its launch (0
// on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;
constexpr int kMaxVecs = 8;      // 16-byte vectors a thread keeps

constexpr int kWalkThreads = 256;
constexpr int kWalkHead = 1024;  // shared bytes before the ring
constexpr int kMaxSlots = 64;    // teams * stages (barriers in the head)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive elements of T at p (16-byte aligned when N * sizeof(T) is
// a multiple of 16, 8-byte aligned when it is 8), widened to f32
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < 16 / (int)sizeof(T); ++j)
        out[c * (16 / (int)sizeof(T)) + j] = to_f(e[j]);
    }
  } else {
    static_assert(kBytes == 8, "8- or 16-byte multiples only");
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f(e[j]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[N]) {
  static_assert(N * sizeof(T) == 16, "one 16-byte store");
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < N; ++j) e[j] = from_f<T>(v[j]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// y = (x - mu) * r * w (+ b) of one vector, each step rounded on its own
template <typename XT, typename WT, typename BT, bool kLN, int kVec>
__device__ __forceinline__ void norm_vec(const float (&t)[kVec],
                                         const WT* __restrict__ w,
                                         const BT* __restrict__ b, float mu,
                                         float r, XT* __restrict__ y) {
  float wv[kVec], bv[kVec], o[kVec];
  load_vec<WT, kVec>(w, wv);
  if (kLN) load_vec<BT, kVec>(b, bv);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const float xn = __fmul_rn(kLN ? __fsub_rn(t[j], mu) : t[j], r);
    o[j] = __fmul_rn(xn, wv[j]);
    if (kLN) o[j] = __fadd_rn(o[j], bv[j]);
  }
  store_vec<XT, kVec>(y, o);
}

// a fixed tree over a thread's kVec partial sums
template <int N>
__device__ __forceinline__ float tree_sum(const float (&a)[N]) {
  float s[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s[j] = a[j];
#pragma unroll
  for (int w = N / 2; w > 0; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) s[j] += s[j + w];
  return s[0];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// the row walk
// ---------------------------------------------------------------------------

// One row team: its threads, its ring and its partial-sum buffers.
struct Team {
  int warps, threads, id, t, wit, lane;
  float* red;       // [2][warps]: the warps' partial sums, double-buffered
  int buf;

  // the team's sum of v (every thread of the team calls it), in a fixed
  // order: the warp's shuffle tree, then the warps in order
  __device__ __forceinline__ float sum(float v) {
    v = warp_sum(v);
    if (warps == 1) return v;
    float* r = red + buf * warps;
    buf ^= 1;     // the next sum writes the other half: every thread has
                  // read this one before it passes that sum's barrier
    if (lane == 0) r[wit] = v;
    named_sync(1 + id, threads);
    float s = 0.f;
    for (int i = 0; i < warps; ++i) s += r[i];
    return s;
  }
  __device__ __forceinline__ void sync() {
    if (warps == 1)
      __syncwarp();
    else
      named_sync(1 + id, threads);
  }
};

template <typename XT, typename WT, typename BT, bool kLN, bool kStaged>
__global__ void __launch_bounds__(kWalkThreads, 4)
fused_norm_walk_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                       const BT* __restrict__ b, XT* __restrict__ y, int R,
                       int H, float eps, int team_warps, int stages) {
  constexpr int kVec = 16 / (int)sizeof(XT);
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  Team tm;
  tm.warps = team_warps;
  tm.threads = team_warps * 32;
  tm.id = tid / tm.threads;
  tm.t = tid % tm.threads;
  tm.wit = tm.t >> 5;
  tm.lane = tid & 31;
  tm.buf = 0;
  const int teams = blockDim.x / tm.threads;
  const int n_vec = H / kVec;
  const uint32_t row_bytes = (uint32_t)H * sizeof(XT);

  // head: the vectors' barrier, the slots' barriers, the partial sums
  uint64_t* vbar = reinterpret_cast<uint64_t*>(smem);
  uint64_t* full = vbar + 1 + tm.id * stages;
  tm.red = reinterpret_cast<float*>(smem + 8 * (1 + kMaxSlots)) +
           tm.id * 2 * tm.warps;
  unsigned char* ring = smem + kWalkHead + (size_t)tm.id * stages * row_bytes;
  const WT* ws = reinterpret_cast<const WT*>(
      smem + kWalkHead + (size_t)teams * stages * row_bytes);
  const BT* bs = reinterpret_cast<const BT*>(
      reinterpret_cast<const unsigned char*>(ws) + (size_t)H * sizeof(WT));
  const WT* wv = kStaged ? ws : w;
  const BT* bv = kStaged ? bs : b;

  // the team's rows: g, g + G, ... (the plan's grid leaves no block idle,
  // so team 0 of every block has a row and waits for the vectors' copy)
  const int g = blockIdx.x * teams + tm.id, G = gridDim.x * teams;
  const int n_rows = g < R ? (R - 1 - g) / G + 1 : 0;
  const bool leader = tm.t == 0;

  if (tid == 0) {
    mbar_init(vbar, 1);
    for (int i = 0; i < teams * stages; ++i) mbar_init(vbar + 1 + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kStaged && tid == 0) {
    const uint32_t wb = (uint32_t)H * sizeof(WT);
    const uint32_t bb = kLN ? (uint32_t)H * sizeof(BT) : 0u;
    mbar_expect(vbar, wb + bb);
    bulk_copy((void*)ws, w, wb, vbar);
    if (kLN) bulk_copy((void*)bs, b, bb, vbar);
  }
  if (leader)
    for (int k = 0; k < min(stages, n_rows); ++k) {
      mbar_expect(full + k, row_bytes);
      bulk_copy(ring + (size_t)k * row_bytes,
                x + (size_t)(g + (size_t)k * G) * H, row_bytes, full + k);
    }

  for (int k = 0; k < n_rows; ++k) {
    const int s = k % stages;
    const size_t row = (size_t)g + (size_t)k * G;
    const XT* xs = reinterpret_cast<const XT*>(ring + (size_t)s * row_bytes);
    mbar_wait(full + s, (k / stages) & 1);

    // pass 1: sum x (LayerNorm) or x^2 (RMSNorm)
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
    for (int i = tm.t; i < n_vec; i += tm.threads) {
      float v[kVec];
      load_vec<XT, kVec>(xs + (size_t)i * kVec, v);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        acc[j] = kLN ? acc[j] + v[j] : fmaf(v[j], v[j], acc[j]);
    }
    const float total = tm.sum(tree_sum(acc));

    float mu = 0.f, r;
    if (kLN) {
      // pass 2: the variance around the mean, from the slot again
      mu = total / (float)H;
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
      for (int i = tm.t; i < n_vec; i += tm.threads) {
        float v[kVec];
        load_vec<XT, kVec>(xs + (size_t)i * kVec, v);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = v[j] - mu;
          acc[j] = fmaf(d, d, acc[j]);
        }
      }
      r = rsqrtf(tm.sum(tree_sum(acc)) / (float)H + eps);
    } else {
      r = rsqrtf(total / (float)H + eps);
    }

    // last pass: y in x's type, 16-byte stores from registers
    if (kStaged && k == 0) mbar_wait(vbar, 0);
    XT* yr = y + row * H;
    for (int i = tm.t; i < n_vec; i += tm.threads) {
      float v[kVec];
      load_vec<XT, kVec>(xs + (size_t)i * kVec, v);
      norm_vec<XT, WT, BT, kLN, kVec>(v, wv + (size_t)i * kVec,
                                      bv + (size_t)i * kVec, mu, r,
                                      yr + (size_t)i * kVec);
    }

    // the slot is free: refill it with the team's row k + stages
    tm.sync();
    if (leader && k + stages < n_rows) {
      fence_async_smem();
      mbar_expect(full + s, row_bytes);
      bulk_copy(ring + (size_t)s * row_bytes,
                x + (row + (size_t)stages * G) * H, row_bytes, full + s);
    }
  }
}

// ---------------------------------------------------------------------------
// rows wider than a slot: one block per row (PR 6's kernel)
// ---------------------------------------------------------------------------

// the block's sum of v, in a fixed order, returned to every thread
__device__ __forceinline__ float block_sum(float v, float* partial) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();                   // partial[] is free (an earlier sum)
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < n_warps ? partial[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) partial[32] = s;
  }
  __syncthreads();
  return partial[32];
}

template <typename XT, typename WT, typename BT, bool kLN>
__global__ void __launch_bounds__(kMaxThreads)
fused_norm_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                  const BT* __restrict__ b, XT* __restrict__ y, int H,
                  float eps) {
  constexpr int kVec = 16 / (int)sizeof(XT);
  __shared__ float partial[33];
  const int n_vec = H / kVec;
  const int tid = threadIdx.x, nt = blockDim.x;
  const XT* xr = x + (size_t)blockIdx.x * H;
  XT* yr = y + (size_t)blockIdx.x * H;

  // pass 1: the row into registers (the rest re-read), sum x or x^2
  float v[kMaxVecs][kVec];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxVecs; ++c) {
    const int i = c * nt + tid;
    if (i < n_vec) {
      load_vec<XT, kVec>(xr + (size_t)i * kVec, v[c]);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        s = kLN ? s + v[c][j] : fmaf(v[c][j], v[c][j], s);
    }
  }
  for (int i = kMaxVecs * nt + tid; i < n_vec; i += nt) {
    float t[kVec];
    load_vec<XT, kVec>(xr + (size_t)i * kVec, t);
#pragma unroll
    for (int j = 0; j < kVec; ++j) s = kLN ? s + t[j] : fmaf(t[j], t[j], s);
  }
  const float total = block_sum(s, partial);

  float mu = 0.f, r;
  if (kLN) {
    // pass 2: the variance around the mean
    mu = total / (float)H;
    float s2 = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxVecs; ++c) {
      if (c * nt + tid < n_vec) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = v[c][j] - mu;
          s2 = fmaf(d, d, s2);
        }
      }
    }
    for (int i = kMaxVecs * nt + tid; i < n_vec; i += nt) {
      float t[kVec];
      load_vec<XT, kVec>(xr + (size_t)i * kVec, t);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = t[j] - mu;
        s2 = fmaf(d, d, s2);
      }
    }
    r = rsqrtf(block_sum(s2, partial) / (float)H + eps);
  } else {
    r = rsqrtf(total / (float)H + eps);
  }

  // last pass: y = (x - mu) * r * w (+ b), in x's type
#pragma unroll
  for (int c = 0; c < kMaxVecs; ++c) {
    const int i = c * nt + tid;
    if (i < n_vec)
      norm_vec<XT, WT, BT, kLN, kVec>(v[c], w + (size_t)i * kVec,
                                      b + (size_t)i * kVec, mu, r,
                                      yr + (size_t)i * kVec);
  }
  for (int i = kMaxVecs * nt + tid; i < n_vec; i += nt) {
    float t[kVec];
    load_vec<XT, kVec>(xr + (size_t)i * kVec, t);
    norm_vec<XT, WT, BT, kLN, kVec>(t, w + (size_t)i * kVec,
                                    b + (size_t)i * kVec, mu, r,
                                    yr + (size_t)i * kVec);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// the host's plan (ops/fused_norms.py _norm_plan)
struct Plan {
  int path, threads, team_warps, stages, grid, smem;
};

template <typename XT, typename WT, typename BT, bool kLN, bool kStaged>
int launch_walk(const void* x, const void* w, const void* b, void* y, int R,
                int H, float eps, const Plan& p, cudaStream_t stream) {
  auto kern = fused_norm_walk_kernel<XT, WT, BT, kLN, kStaged>;
  if (p.threads % (32 * p.team_warps) != 0 ||
      p.threads / (32 * p.team_warps) * p.stages > kMaxSlots ||
      p.smem < kWalkHead)
    return (int)cudaErrorInvalidValue;
  static int smem_set = 48 * 1024;      // per instantiation
  if (p.smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = p.smem;
  }
  kern<<<p.grid, p.threads, p.smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<const BT*>(b), static_cast<XT*>(y), R, H, eps,
      p.team_warps, p.stages);
  return (int)cudaGetLastError();
}

template <typename XT, typename WT, typename BT, bool kLN>
int launch(const void* x, const void* w, const void* b, void* y, int R,
           int H, float eps, const Plan& p, cudaStream_t stream) {
  if (p.path == 1)
    return launch_walk<XT, WT, BT, kLN, false>(x, w, b, y, R, H, eps, p,
                                               stream);
  if (p.path == 2)
    return launch_walk<XT, WT, BT, kLN, true>(x, w, b, y, R, H, eps, p,
                                              stream);
  if (p.path != 0 || p.threads % 32 != 0 || p.threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  fused_norm_kernel<XT, WT, BT, kLN><<<R, p.threads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<const BT*>(b), static_cast<XT*>(y), H, eps);
  return (int)cudaGetLastError();
}

// dispatch over the weight's and bias's types for one x type
template <typename XT, bool kLN>
int launch_x(const void* x, const void* w, const void* b, void* y, int R,
             int H, int w_dtype, int b_dtype, float eps, const Plan& p,
             cudaStream_t s) {
  if (w_dtype == 0 && b_dtype == 0)
    return launch<XT, float, float, kLN>(x, w, b, y, R, H, eps, p, s);
  if (w_dtype == 1 && b_dtype == 0)
    return launch<XT, bf16, float, kLN>(x, w, b, y, R, H, eps, p, s);
  if constexpr (kLN) {           // RMSNorm has no bias: one type code
    if (w_dtype == 0 && b_dtype == 1)
      return launch<XT, float, bf16, kLN>(x, w, b, y, R, H, eps, p, s);
    if (w_dtype == 1 && b_dtype == 1)
      return launch<XT, bf16, bf16, kLN>(x, w, b, y, R, H, eps, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool kLN>
int dispatch(const void* x, const void* w, const void* b, void* y, int R,
             int H, int x_dtype, int w_dtype, int b_dtype, float eps,
             const Plan& p, void* stream) {
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_x<float, kLN>(x, w, b, y, R, H, w_dtype, b_dtype, eps, p,
                                s);
  if (x_dtype == 1)
    return launch_x<bf16, kLN>(x, w, b, y, R, H, w_dtype, b_dtype, eps, p,
                               s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y [R, H] = rms_norm(x [R, H]) * w [H]; H a multiple of 128.
extern "C" int paddle_fused_rms_norm(const void* x, const void* w, void* y,
                                     int R, int H, int x_dtype, int w_dtype,
                                     float eps, int path, int threads,
                                     int team_warps, int stages, int grid,
                                     int smem, void* stream) {
  // the bias is unused: its type code only picks an instantiation
  return dispatch<false>(x, w, nullptr, y, R, H, x_dtype, w_dtype, 0, eps,
                         {path, threads, team_warps, stages, grid, smem},
                         stream);
}

// y [R, H] = layer_norm(x [R, H]) * w [H] + b [H]; H a multiple of 128.
extern "C" int paddle_fused_layer_norm(const void* x, const void* w,
                                       const void* b, void* y, int R, int H,
                                       int x_dtype, int w_dtype, int b_dtype,
                                       float eps, int path, int threads,
                                       int team_warps, int stages, int grid,
                                       int smem, void* stream) {
  return dispatch<true>(x, w, b, y, R, H, x_dtype, w_dtype, b_dtype, eps,
                        {path, threads, team_warps, stages, grid, smem},
                        stream);
}
