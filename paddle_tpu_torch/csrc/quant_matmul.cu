// Fused dequant matmul for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/quant_matmul.py ::
// _qmm_kernel (launched by matmul).  What it computes:
//
//   out[m, n] = sum_k float(x[m, k]) * (float(w[k, n]) * scale(k, n))
//
// in f32, with x [M, K] f32 or bf16 upcast exactly and w a quantized pool:
// int8 q [K, N] with per-column scales s[N], or int4 q [K/2, N] whose
// packed row r holds K-row 2r in its low nibble and 2r+1 in its high nibble
// (signed), with per-128-row-group scales s[ceil(K/128), N].  The f32
// weight tile never exists in device memory: each slab is dequantized in
// shared memory, as the TPU kernel does in VMEM.
//
// Layout: a block computes a [BM, BN] output tile and walks K in slabs of
// BK rows.  Per slab it copies x [BM, BK] into shared memory (transposed,
// f32) and the weight slab [BK, BN] (int8, or BK/2 packed int4 rows) with
// 4-byte loads along N, unpacks and dequantizes it once into shared memory
// as f32, then every thread accumulates a TM x TN register tile with f32
// FMAs.  A thread owns rows ty + i * BM/TM and columns tx + j * BN/TN, so a
// warp reads consecutive weight columns (no bank conflicts) and one x value
// (a broadcast).  Edge tiles in M, N and K are masked with zeros.  Two tile
// shapes: BM = 8 for M <= 16 (decode, the logit head), BM = 64 above.
//
// Small outputs split K: when the output tiles alone would leave the card's
// 132 SMs idle (decode at M = 8 has 64 tiles for N = 4096), blockIdx.z takes
// a contiguous K range, each split writes its partial [M, N] product to a
// scratch buffer the caller allocates, and a second kernel sums the splits
// in order 0, 1, ... -- deterministic, unlike atomics.  The split count
// comes from geometry(), which both C entries use.
//
// What bounds it on this card.  At decode (M = 8) the weights dominate the
// bytes and the work is 2 * M flops per weight byte (int8), far below the
// H100's ridge: memory bandwidth bounds it.  At prefill (M = 512) it is
// 2 * 512 flops per weight byte, above the ridge even for tensor cores,
// and this version runs on the CUDA cores in f32 (67 TFLOP/s peak), so
// operations bound it.  This first version loads a slab, then computes on
// it, with no overlap.  What a later version should change: dequantize to
// bf16 tiles and feed wgmma (tensor cores), keep loads in flight with TMA
// or cp.async into a ring of slabs, and pick the tile by autotuning.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 128;          // int4 scale-group length along K
constexpr int kSmallM = 16;          // M at or below this takes BM = 8
constexpr int kTargetBlocks = 2 * 132;
constexpr int kMaxSplits = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// sign-extended low and high nibble of a packed int4 byte
__device__ __forceinline__ int nib_lo(int8_t b) {
  return (int)((unsigned)(int)b << 28) >> 28;
}
__device__ __forceinline__ int nib_hi(int8_t b) { return (int)b >> 4; }

struct Geom {
  bool small;
  int bm, bn, bk;
  int splits;
  int k_per_split;  // a multiple of bk
};

Geom geometry(int M, int N, int K) {
  Geom g;
  g.small = M <= kSmallM;
  g.bm = g.small ? 8 : 64;
  g.bn = 64;
  g.bk = g.small ? 64 : 32;
  const long long tiles =
      (long long)((M + g.bm - 1) / g.bm) * ((N + g.bn - 1) / g.bn);
  const int slabs = (K + g.bk - 1) / g.bk;
  long long want = (kTargetBlocks + tiles - 1) / tiles;
  if (want > kMaxSplits) want = kMaxSplits;
  if (want > slabs) want = slabs;
  if (want < 1) want = 1;
  g.k_per_split = (int)((slabs + want - 1) / want) * g.bk;
  g.splits = (K + g.k_per_split - 1) / g.k_per_split;
  return g;
}

template <int BM, int BN, int BK, int TM, int TN, typename XT, bool INT4>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
qmm_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ s, float* __restrict__ out, int M,
           int N, int K, int k_per_split, int vec4) {
  constexpr int kBMT = BM / TM;  // threads along M
  constexpr int kBNT = BN / TN;  // threads along N
  constexpr int kThreads = kBMT * kBNT;
  static_assert(BN % 4 == 0 && BK % 2 == 0, "tile shape");
  __shared__ float xs[BK][BM + 1];
  __shared__ __align__(16) float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kBNT;
  const int ty = tid / kBNT;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  float* o = out + (size_t)blockIdx.z * M * N;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    // 1. x slab, upcast exactly, stored [k][m]
    for (int i = tid; i < BM * BK; i += kThreads) {
      const int m = i / BK, kk = i - m * BK;
      const int gm = m0 + m, gk = k0 + kk;
      xs[kk][m] = (gm < M && gk < kend) ? to_f(x[(size_t)gm * K + gk]) : 0.f;
    }
    // 2. weight slab, unpacked and dequantized once, stored [k][n]
    if (!INT4) {
      if (vec4) {
        for (int i = tid; i < BK * (BN / 4); i += kThreads) {
          const int kk = i / (BN / 4), n = (i - kk * (BN / 4)) * 4;
          const int gk = k0 + kk, gn = n0 + n;
          float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
          if (gk < kend && gn < N) {  // N % 4 == 0: gn + 3 < N
            const char4 b =
                *reinterpret_cast<const char4*>(q + (size_t)gk * N + gn);
            w = make_float4((float)b.x * __ldg(s + gn),
                            (float)b.y * __ldg(s + gn + 1),
                            (float)b.z * __ldg(s + gn + 2),
                            (float)b.w * __ldg(s + gn + 3));
          }
          *reinterpret_cast<float4*>(&ws[kk][n]) = w;
        }
      } else {
        for (int i = tid; i < BK * BN; i += kThreads) {
          const int kk = i / BN, n = i - kk * BN;
          const int gk = k0 + kk, gn = n0 + n;
          ws[kk][n] = (gk < kend && gn < N)
                          ? (float)q[(size_t)gk * N + gn] * __ldg(s + gn)
                          : 0.f;
        }
      }
    } else {
      // packed row gk / 2 holds K-rows gk (low nibble) and gk + 1 (high);
      // k0 and kend are even, so both rows are in range or neither is,
      // and both fall in the same 128-row scale group
      if (vec4) {
        for (int i = tid; i < (BK / 2) * (BN / 4); i += kThreads) {
          const int pr = i / (BN / 4), n = (i - pr * (BN / 4)) * 4;
          const int gk = k0 + 2 * pr, gn = n0 + n;
          float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
          if (gk < kend && gn < N) {
            const char4 b = *reinterpret_cast<const char4*>(
                q + (size_t)(gk / 2) * N + gn);
            const float* sr = s + (size_t)(gk / kGroup) * N + gn;
            const float s0 = __ldg(sr), s1 = __ldg(sr + 1),
                        s2 = __ldg(sr + 2), s3 = __ldg(sr + 3);
            lo = make_float4((float)nib_lo(b.x) * s0, (float)nib_lo(b.y) * s1,
                             (float)nib_lo(b.z) * s2, (float)nib_lo(b.w) * s3);
            hi = make_float4((float)nib_hi(b.x) * s0, (float)nib_hi(b.y) * s1,
                             (float)nib_hi(b.z) * s2, (float)nib_hi(b.w) * s3);
          }
          *reinterpret_cast<float4*>(&ws[2 * pr][n]) = lo;
          *reinterpret_cast<float4*>(&ws[2 * pr + 1][n]) = hi;
        }
      } else {
        for (int i = tid; i < (BK / 2) * BN; i += kThreads) {
          const int pr = i / BN, n = i - pr * BN;
          const int gk = k0 + 2 * pr, gn = n0 + n;
          float lo = 0.f, hi = 0.f;
          if (gk < kend && gn < N) {
            const int8_t b = q[(size_t)(gk / 2) * N + gn];
            const float sc = __ldg(s + (size_t)(gk / kGroup) * N + gn);
            lo = (float)nib_lo(b) * sc;
            hi = (float)nib_hi(b) * sc;
          }
          ws[2 * pr][n] = lo;
          ws[2 * pr + 1][n] = hi;
        }
      }
    }
    __syncthreads();

    // 3. f32 FMAs from shared memory
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * kBMT];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * kBNT];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * kBMT;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * kBNT;
      if (gm < M && gn < N) o[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

// out[i] = part[0][i] + part[1][i] + ... in split order
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t mn,
                                  int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = part[i];
    for (int z = 1; z < splits; ++z) acc += part[(size_t)z * mn + i];
    out[i] = acc;
  }
}

template <int BM, int BN, int BK, int TM, int TN, typename XT, bool INT4>
int launch_tiles(const Geom& g, const void* x, const void* q, const void* s,
                 float* dst, int M, int N, int K, int vec4,
                 cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, g.splits);
  qmm_kernel<BM, BN, BK, TM, TN, XT, INT4>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const XT*>(x), static_cast<const int8_t*>(q),
          static_cast<const float*>(s), dst, M, N, K, g.k_per_split, vec4);
  return (int)cudaGetLastError();
}

template <typename XT, bool INT4>
int launch(const Geom& g, const void* x, const void* q, const void* s,
           float* dst, int M, int N, int K, int vec4, cudaStream_t stream) {
  if (g.small)
    return launch_tiles<8, 64, 64, 1, 2, XT, INT4>(g, x, q, s, dst, M, N, K,
                                                   vec4, stream);
  return launch_tiles<64, 64, 32, 4, 4, XT, INT4>(g, x, q, s, dst, M, N, K,
                                                  vec4, stream);
}

}  // namespace

// Scratch (in floats) that paddle_quant_matmul needs for this shape: the
// split partial products, or 0 when K is not split.
extern "C" long long paddle_quant_matmul_scratch(int M, int N, int K) {
  const Geom g = geometry(M, N, K);
  return g.splits > 1 ? (long long)g.splits * M * N : 0;
}

// C entry, bound with ctypes.  x_dtype: 0 = float32, 1 = bfloat16; int4: 0
// for int8 pools, 1 for nibble-packed int4.  ``scratch`` holds at least
// paddle_quant_matmul_scratch(M, N, K) floats.  Returns cudaGetLastError()
// after the launches (0 on success); the caller checks it.  The wrapper
// (paddle_tpu_torch/ops/quant_matmul.py) has already checked shapes, types
// and contiguity: M, N, K >= 1, K even for int4.
extern "C" int paddle_quant_matmul(const void* x, const void* q,
                                   const void* s, void* out, void* scratch,
                                   int M, int N, int K, int x_dtype,
                                   int int4, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom g = geometry(M, N, K);
  float* dst = static_cast<float*>(g.splits > 1 ? scratch : out);
  const int vec4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  int err;
  if (x_dtype == 0 && !int4)
    err = launch<float, false>(g, x, q, s, dst, M, N, K, vec4, st);
  else if (x_dtype == 0 && int4)
    err = launch<float, true>(g, x, q, s, dst, M, N, K, vec4, st);
  else if (x_dtype == 1 && !int4)
    err = launch<__nv_bfloat16, false>(g, x, q, s, dst, M, N, K, vec4, st);
  else if (x_dtype == 1 && int4)
    err = launch<__nv_bfloat16, true>(g, x, q, s, dst, M, N, K, vec4, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || g.splits == 1) return err;
  const size_t mn = (size_t)M * N;
  size_t blocks = (mn + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<float*>(out), mn,
      g.splits);
  return (int)cudaGetLastError();
}
