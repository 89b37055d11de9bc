// Device code shared by the flash attention kernels of flash_attention.cu
// (fixed-length, causal and GQA) and flash_attention_varlen.cu (packed
// sequences with segment masks): tile loads, the f32 products on the CUDA
// cores, the bf16 mma.sync fragments and products, row reductions and the
// launch helper.  The two families differ only in their masks, their tile
// walks and their rounding points, which stay in their own files.  Each
// .cu file includes this header once; everything here has internal
// linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;        // rows of the tile a block owns

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

// x rounded to T and back: a rounding point
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// bfloat16 at D in {64, 128} takes the tensor-core kernels; float (every
// D) and bfloat16 at D = 256 the CUDA-core ones, which walk tiles of 64
// rows (32 at D = 256, where four 64-row f32 tiles would not fit the 227
// KB of shared memory)
template <typename T, int D>
constexpr bool kMma = std::is_same<T, bf16>::value && D <= 128;
template <int D>
constexpr int walk() { return D == 256 ? 32 : 64; }

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
//
// A block is 256 threads, (ty, tx) = (tid / 16, tid % 16).  Operand tiles
// sit in shared memory as f32 with a row stride of D + 1 floats, so the
// column reads of the products fall on distinct banks.  A 64 x N score
// tile is split into 4 x N/16 micro-tiles, thread (ty, tx) owning rows ty +
// 16 i and columns tx + 16 j; a 64 x D output tile into 4 x D/16
// micro-tiles, rows ty + 16 i and columns tx + 16 j.  A row's 16 owners
// are one half-warp, so row maxima and sums are four shuffles.  Every
// product is an IEEE f32 FMA (never TF32).
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

// reductions over the 16 lanes of a half-warp (the 16 owners of a row)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [0, rows) of an R-row tile of T (row r at src + r * stride) into
// shared memory as f32 with row stride D + 1, zeros past `rows`; with
// kScale each element becomes (x * scale) rounded to T.  16-byte global
// loads.
template <typename T, int D, int R, bool kScale = false>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          size_t stride, int rows,
                                          float scale = 1.f) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = D / kVec;
  for (int i = threadIdx.x; i < R * kVecsPerRow; i += kThreads) {
    const int r = i / kVecsPerRow;
    const int c = (i - r * kVecsPerRow) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      raw = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * (D + 1) + c;
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      d[j] = kScale ? round_to<T>(to_f(e[j]) * scale) : to_f(e[j]);
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d]: a 64 x NB tile of
// A . B^T, A [64, D] and B [NB, D] in shared memory (stride D + 1)
template <int D, int NB>
__device__ __forceinline__ void mm_abt(float (&acc)[4][NB / 16],
                                       const float* __restrict__ A,
                                       const float* __restrict__ B, int ty,
                                       int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NB / 16; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], b[NB / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < NB / 16; ++j) b[j] = B[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k P[ty + 16 i][k] * V[k][tx + 16 j]: a 64 x D tile of
// P . V, P [64, NK] (stride NK + 1) and V [NK, D] (stride D + 1)
template <int D, int NK>
__device__ __forceinline__ void mm_ab(float (&acc)[4][D / 16],
                                      const float* __restrict__ P,
                                      const float* __restrict__ V, int ty,
                                      int tx) {
#pragma unroll 4
  for (int k = 0; k < NK; ++k) {
    float a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(ty + 16 * i) * (NK + 1) + k];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float b = V[k * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
    }
  }
}

// Rows [0, rows) of a 64 x D micro-tiled accumulator, rounded to T.
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* __restrict__ dst, size_t stride,
                                           int rows,
                                           const float (&acc)[4][D / 16],
                                           int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        dst[(size_t)r * stride + tx + 16 * j] = from_f<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
//
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators.  A block is 4
// warps; warp w owns 16 rows of the block's 64 and keeps its accumulators
// in the mma C layout: thread (g = lane / 4, t = lane % 4) holds rows g and
// g + 8, columns 2t and 2t + 1 of each 8-wide n-tile.  A score tile in
// that layout is already the A operand of the next product once packed to
// bf16 pairs (the FA2 register trick), so p and dS never touch shared
// memory.  Tiles sit in shared memory as bf16 with rows padded by 8
// elements (every 32-bit fragment load of a warp hits 32 distinct banks);
// an operand read along its rows by one product and along its columns by
// another is stored twice, once transposed.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;     // 4 warps x 16 rows = one 64-row tile
constexpr int kLdT = kTile + 8;      // row stride of a transposed tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b for one m16n8k16 tile (a row-major 16 x 16, b 16 x 8)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment (16 rows x 16 of k) at rows [r, r + 16), columns
// [c, c + 16) of a row-major bf16 tile with row stride ld.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld,
                                       int r, int c, int g, int t) {
  const bf16* p = s + (r + g) * ld + c + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// acc[n][.] += A . B^T over n-tiles n of 8 rows of B: A is the warp's 16
// rows at row r of a (row-major, stride lda), B rows [n0 + 8 n, ...) of b
// (row-major, stride ldb), the shared dimension K long.
template <int K, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N][4], const bf16* a,
                                        int lda, int r, const bf16* b, int ldb,
                                        int n0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    load_a(af, a, lda, r, kk * 16, g, t);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bf16* p = b + (n0 + 8 * n + g) * ldb + kk * 16 + 2 * t;
      mma_bf16(acc[n], af, lds32(p), lds32(p + 8));
    }
  }
}

// acc[n][.] += P . B over n-tiles of 8 columns: P the warp's 16 x (16 KS)
// operand as packed A fragments, B^T given transposed (bt[col][k], stride
// ldt) from k offset k0.
template <int KS, int N>
__device__ __forceinline__ void mma_pb(float (&acc)[N][4],
                                       const uint32_t (&pa)[KS][4],
                                       const bf16* bt, int ldt, int k0, int g,
                                       int t) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const bf16* p = bt + (8 * n + g) * ldt + k0 + kk * 16 + 2 * t;
      mma_bf16(acc[n], pa[kk], lds32(p), lds32(p + 8));
    }
  }
}

// Pack a 16 x (16 KS) tile held in C layout (x[2 kk + h][.]) into A
// fragments of the next product.
template <int KS>
__device__ __forceinline__ void to_a(uint32_t (&pa)[KS][4],
                                     const float (&x)[2 * KS][4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    pa[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    pa[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    pa[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// Copy rows [0, rows) of a 64-row bf16 tile (row r at src + r * stride)
// into shared memory, zeros past `rows`; with kScale each element becomes
// (x * scale) rounded to bf16.  Row-major (dst[r][c], stride D + 8) or,
// with kTrans, transposed (dst[c][r], stride kLdT).
template <int D, bool kScale, bool kTrans>
__device__ __forceinline__ void load_bf16(bf16* __restrict__ dst,
                                          const bf16* __restrict__ src,
                                          size_t stride, int rows,
                                          float scale = 1.f) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < kTile * kVecs; i += kMmaThreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      raw = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c);
    bf16* e = reinterpret_cast<bf16*>(&raw);
    if (kScale) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale);
    }
    if (kTrans) {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[(c + j) * kLdT + r] = e[j];
    } else {
      *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = raw;
    }
  }
}

// max and sum over the 4 lanes that share a row of the C layout
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// Launch one kernel after raising its dynamic shared memory limit where it
// needs more than 48 KB; returns the first CUDA error (0 on success).
template <typename K, typename... Args>
int launch(K kern, dim3 grid, int threads, size_t smem, cudaStream_t stream,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
