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
// Layout: one block per row.  The TPU's block_r row tiling has no
// counterpart: a row is the unit of work and blocks run in parallel.  Each
// thread loads 16-byte vectors of the row (kVec elements: 4 floats or 8
// bfloat16s; vector i of the row goes to thread i % blockDim.x) and keeps
// up to kMaxVecs of them in registers across the passes, so x is read from
// device memory once; a row longer than blockDim.x * kMaxVecs vectors
// re-reads the rest in each pass.  The row sums reduce in a fixed order
// (each thread's vectors in order, a shuffle tree in each warp, the warps'
// partials summed in warp order by one warp), so repeated launches give
// identical bits.  The multiplies and adds of the output are rounded one
// by one (__fmul_rn, __fadd_rn), never contracted into FMAs, as the plain
// version computes them.
//
// What bounds it: memory bandwidth.  It moves R * H * (in + out) bytes of x
// and y plus the H-vectors, and does a handful of flops per element, far
// below the card's ~295 flop/byte ridge.  This first version makes no use
// of TMA or of a persistent grid; at a few rows (a decode step's 8) it
// fills 8 of 132 SMs and is launch-latency bound.
//
// Entry points (plain C, bound with ctypes by
// paddle_tpu_torch/ops/fused_norms.py, which has checked shapes, types,
// contiguity and 16-byte alignment): paddle_fused_rms_norm and
// paddle_fused_layer_norm; dtype codes 0 = float32, 1 = bfloat16; each
// returns cudaGetLastError() after its launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;
constexpr int kMaxVecs = 8;      // 16-byte vectors a thread keeps

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

// the block's sum of v, in a fixed order, returned to every thread
__device__ __forceinline__ float block_sum(float v, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();                   // partial[] is free (an earlier sum)
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < n_warps ? partial[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
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
  auto out = [&](const float (&t)[kVec], int i) {
    float wv[kVec], bv[kVec], o[kVec];
    load_vec<WT, kVec>(w + (size_t)i * kVec, wv);
    if (kLN) load_vec<BT, kVec>(b + (size_t)i * kVec, bv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float xn = __fmul_rn(kLN ? __fsub_rn(t[j], mu) : t[j], r);
      o[j] = __fmul_rn(xn, wv[j]);
      if (kLN) o[j] = __fadd_rn(o[j], bv[j]);
    }
    store_vec<XT, kVec>(yr + (size_t)i * kVec, o);
  };
#pragma unroll
  for (int c = 0; c < kMaxVecs; ++c) {
    const int i = c * nt + tid;
    if (i < n_vec) out(v[c], i);
  }
  for (int i = kMaxVecs * nt + tid; i < n_vec; i += nt) {
    float t[kVec];
    load_vec<XT, kVec>(xr + (size_t)i * kVec, t);
    out(t, i);
  }
}

template <typename XT, typename WT, typename BT, bool kLN>
int launch(const void* x, const void* w, const void* b, void* y, int R,
           int H, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(XT);
  const int n_vec = H / kVec;
  // one vector a thread where the row allows, in whole warps
  const int threads = min(kMaxThreads, max(32, (n_vec + 31) / 32 * 32));
  fused_norm_kernel<XT, WT, BT, kLN><<<R, threads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const WT*>(w),
      static_cast<const BT*>(b), static_cast<XT*>(y), H, eps);
  return (int)cudaGetLastError();
}

// dispatch over the weight's and bias's types for one x type
template <typename XT, bool kLN>
int launch_x(const void* x, const void* w, const void* b, void* y, int R,
             int H, int w_dtype, int b_dtype, float eps, cudaStream_t s) {
  if (w_dtype == 0 && b_dtype == 0)
    return launch<XT, float, float, kLN>(x, w, b, y, R, H, eps, s);
  if (w_dtype == 0 && b_dtype == 1)
    return launch<XT, float, bf16, kLN>(x, w, b, y, R, H, eps, s);
  if (w_dtype == 1 && b_dtype == 0)
    return launch<XT, bf16, float, kLN>(x, w, b, y, R, H, eps, s);
  if (w_dtype == 1 && b_dtype == 1)
    return launch<XT, bf16, bf16, kLN>(x, w, b, y, R, H, eps, s);
  return (int)cudaErrorInvalidValue;
}

template <bool kLN>
int dispatch(const void* x, const void* w, const void* b, void* y, int R,
             int H, int x_dtype, int w_dtype, int b_dtype, float eps,
             void* stream) {
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch_x<float, kLN>(x, w, b, y, R, H, w_dtype, b_dtype, eps, s);
  if (x_dtype == 1)
    return launch_x<bf16, kLN>(x, w, b, y, R, H, w_dtype, b_dtype, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y [R, H] = rms_norm(x [R, H]) * w [H]; H a multiple of 128.
extern "C" int paddle_fused_rms_norm(const void* x, const void* w, void* y,
                                     int R, int H, int x_dtype, int w_dtype,
                                     float eps, void* stream) {
  // the bias is unused: its type code only picks an instantiation
  return dispatch<false>(x, w, nullptr, y, R, H, x_dtype, w_dtype, 0, eps,
                         stream);
}

// y [R, H] = layer_norm(x [R, H]) * w [H] + b [H]; H a multiple of 128.
extern "C" int paddle_fused_layer_norm(const void* x, const void* w,
                                       const void* b, void* y, int R, int H,
                                       int x_dtype, int w_dtype, int b_dtype,
                                       float eps, void* stream) {
  return dispatch<true>(x, w, b, y, R, H, x_dtype, w_dtype, b_dtype, eps,
                        stream);
}
