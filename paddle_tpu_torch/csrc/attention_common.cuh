// Device code shared by the flash attention kernels of flash_attention.cu
// (fixed-length, causal and GQA) and flash_attention_varlen.cu (packed
// sequences with segment masks): tile loads, the f32 products on the CUDA
// cores, the bf16 packing and mma.sync product (the dequant matmul's), the
// Hopper pieces of the wgmma kernels (their constants, operand steps, tile
// copies, row stores and the forward's online-softmax walk, which both families
// run), row reductions and the launch helper.  The two families differ only in
// their masks, their tile walks and their rounding points, which stay in their
// own files.  Each .cu file includes this header once; everything here has
// internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
// bf16 on the tensor cores: mma.sync.m16n8k16 with bf16 operands and f32
// accumulators (the dequant matmul's decode tiles), and the C layout's
// packing and row reductions, which the wgmma accumulators share: thread
// (g = lane / 4, t = lane % 4) of a warp holds rows g and g + 8, columns
// 2t and 2t + 1 of each 8-wide n-tile.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
// bf16 on Hopper's tensor cores (D in {64, 128}): wgmma from TMA-filled
// shared memory, warp-specialised
//
// A block is three warpgroups: two consumers (240 registers a thread after
// setmaxnreg) run every product as wgmma.mma_async (bf16 operands, f32
// accumulators), and one producer (24 registers) whose first warp fills an
// mbarrier ring of tiles with TMA, so the next tiles' copies are in flight
// while this tile's products run (the varlen backward, whose dK and dV
// accumulators need more registers than ptxas gives beside a producer
// warp, fills its ring from the consumers: flash_attention_varlen.cu).  Tiles are 64 rows of one head, copied as
// boxes of 64 rows x 64 columns (128 bytes) from a 3D tensor map over
// [B, S, heads * D] in the 128-byte swizzle: rows past S read zeros, and a
// tile wider than 64 columns is two boxes (hopper.cuh's layout).  Every
// operand is read in place from its box: K-major where a product sums over
// the head dim (scores, dP), N-major (wgmma's transpose flag) where it sums
// over the rows (P V, dV, dK, dQ); no tile is ever stored transposed.
// Probabilities and dS go from the score accumulators straight into
// register A operands.  exp is exp2 of a log2(e)-scaled argument.  No
// atomics: each block writes its own rows once, so repeats are bit for bit.
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;          // consumers 0, 1; producer 2
constexpr int kConsumerRegs = 240, kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x on the SFU (ex2.approx, relative error 2^-22; results below 2^-126
// flush to 0, where p is rounded to bf16 next anyway; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// byte offset of k16 step kk in a K-major 64-row tile (column blocks of
// 64 x 128 bytes), and in an N-major one (16 rows a step)
__device__ __forceinline__ uint32_t kmajor_step(int kk) {
  return (kk >> 2) * 8192 + (kk & 3) * 32;
}
__device__ __forceinline__ uint32_t nmajor_step(int kk) { return kk * 2048; }

// d (+)= A . B over one tile product with B N-major: N = D
template <int D>
__device__ __forceinline__ void wgmma_rs_nd(float (&d)[D / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (D == 64)
    wgmma_rs_n64<1>(d, a, desc_b, 1);
  else
    wgmma_rs_n128<1>(d, a, desc_b, 1);
}

// d = A . B + (scale_d ? d : 0), A and B K-major in shared memory, N wide
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 64)
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  else
    wgmma_ss_n32(d, desc_a, desc_b, scale_d);
}
// d = A . B, write-only (the first k16 step of a sum)
template <int N>
__device__ __forceinline__ void wgmma_ss_first(float (&d)[N / 2],
                                               uint64_t desc_a,
                                               uint64_t desc_b) {
  if constexpr (N == 64)
    wgmma_ss_n64_first(d, desc_a, desc_b);
  else
    wgmma_ss_n32_first(d, desc_a, desc_b);
}

// Rows r0 and r0 + 8 (accumulator layout) of a 64 x D f32 tile, times
// `mul`, rounded to bf16 and stored at dst + row * stride (rows >= n
// skipped).
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           size_t stride, int r0, int n,
                                           const float (&acc)[D / 2],
                                           float mul, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r < n) {
      bf16* p = dst + (size_t)r * stride + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(p + 8 * j) =
            pack_bf16(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
    }
  }
}

// acc (64 x 16 KS, accumulator layout) packed to bf16 A operands
template <int KS>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[KS][4],
                                         const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void keep_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) keep(a[i]);
}

// 64-row tile `src` (64 x D bf16) rewritten as bf16(x * scale) into `dst`
// by `threads` threads, thread index `i0`; elementwise, so the swizzle
// stays as it landed
template <int D>
__device__ __forceinline__ void scale_tile(unsigned char* dst,
                                           const unsigned char* src,
                                           float scale, int i0,
                                           int threads) {
  for (int i = i0; i < 64 * D / 8; i += threads) {
    uint4 raw = reinterpret_cast<const uint4*>(src)[i];
    bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16_rn(__bfloat162float(e[j]) * scale);
    reinterpret_cast<uint4*>(dst)[i] = raw;
  }
}

// one 64-row tile of head column `col` (in elements) at row `row` of
// batch b, as D / 64 boxes
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, int col,
                                         int row, int b, uint64_t* bar) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_3d(dst + c * 8192, map, col + 64 * c, row, b, bar);
}

// a [B, S, heads * D] bf16 tensor as TMA boxes of 64 rows x 64 columns
// in the 128-byte swizzle (rows past S read zeros)
bool head_map(CUtensorMap* m, const void* p, int B, int S, int heads, int D) {
  const uint64_t row = (uint64_t)heads * D * sizeof(bf16);
  return tensor_map_3d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p,
                       (uint64_t)heads * D, S, B, row, row * S, 64, 64,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------------------
// The forward on wgmma (both families).  A block owns 128 queries of one
// head; consumer warpgroup w owns the 64 rows q0 + 64 w .., whose Q tile
// lands once (2 * kTile bytes for the block).  The producer walks the
// block's key tiles [t0, t1) through the ring: a stage is one 64-key tile
// of K and of V, plus kMeta bytes the family adds (varlen: the keys'
// segment ids and positions).  Each warpgroup computes the tiles of its own
// range [a0, a1) and only waits for and releases the others.  Per tile:
// S = Q K^T (both K-major), the online softmax in f32 registers (running
// max m in the log2 domain, running sum l of the unrounded p, per thread,
// added over the row's 4 lanes at the end), p rounded to bf16 into
// register A operands, O += P V with V read N-major from its box.  The
// next tile's Q K^T is issued before this tile's P V and waited for first,
// so the scores' softmax runs while P V is in flight; a stage is released
// once the P V that read it is waited for.  The loop is peeled so that
// every wgmma sits on a straight path (under a branch the compiler cannot
// prove warp-uniform it serializes them), and each tile's first score step
// only writes its accumulators.
// ---------------------------------------------------------------------------

template <int D, int kMeta>
struct FwdSmem {
  static constexpr int kStages = D == 64 ? 6 : 4;
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kStage = 2 * kTile + kMeta;     // K, V (, metadata)
  static constexpr int kRing = 2 * kTile;              // after Q x 2
  static constexpr int kBytes = kRing + kStages * kStage;
  static constexpr size_t kDynamic = kBytes + 8 * (2 * kStages + 1) + 1024;
};

// S = Q K^T over one 64-key tile (K K-major at `k`), committed
template <int D>
__device__ __forceinline__ void fwd_scores(float (&s)[32], uint64_t q_desc,
                                           const unsigned char* k) {
  const uint64_t k_desc = sw128_desc(k);
  wgmma_fence();
  wgmma_ss_n64_first(s, q_desc, k_desc);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss_n64(s, q_desc + (kmajor_step(kk) >> 4),
                 k_desc + (kmajor_step(kk) >> 4), 1);
  wgmma_commit();
}

// O += P V over one 64-key tile, V N-major at `v`, committed
template <int D>
__device__ __forceinline__ void fwd_pv(float (&o)[D / 2],
                                       const uint32_t (&pa)[4][4],
                                       const unsigned char* v) {
  const uint64_t v_mn = sw128_desc_mn(v, 8192);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_nd<D>(o, pa[kk], v_mn + (nmajor_step(kk) >> 4));
  wgmma_commit();
}

// The scores' softmax for one tile, in place: on entry s holds the raw
// scores (-inf where masked), times s_mul they are the log2-domain
// scores; on exit s holds p = 2^(s s_mul - m_new), m is the new running
// max (-inf while the row has seen no key), alpha the factor for the old
// O and l, sum this thread's part of the row sums.
__device__ __forceinline__ void fwd_softmax(float (&s)[32], float (&m)[2],
                                            float (&alpha)[2],
                                            float (&sum)[2], float s_mul) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
  float mu[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mn = fmaxf(m[i], quad_max(mx[i]) * s_mul);
    mu[i] = mn == -INFINITY ? 0.f : mn;
    alpha[i] = ex2(m[i] - mu[i]);
    m[i] = mn;
    sum[i] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = (e >> 1) & 1;
    s[e] = ex2(fmaf(s[e], s_mul, -mu[i]));
    sum[i] += s[e];
  }
}

// A tile's landed scores to p in s (masked first where masked(kt, stage)
// says so, visible(kt, stage, key column, i) deciding per element; i: the
// thread's row r or r + 8, key column 8 j + 2 t + (e & 1) of accumulator
// element 4 j + e), then the new running max; returns alpha in `alpha`
template <class Masked, class Visible>
__device__ __forceinline__ void fwd_probs(float (&s)[32], float (&m)[2],
                                          float (&alpha)[2],
                                          float (&sum)[2], float s_mul,
                                          int kt, const unsigned char* st,
                                          int t, Masked masked,
                                          Visible visible) {
  if (masked(kt, st)) {
#pragma unroll
    for (int e = 0; e < 32; ++e)
      if (!visible(kt, st, 8 * (e >> 2) + 2 * t + (e & 1), (e >> 1) & 1))
        s[e] = -INFINITY;
  }
  fwd_softmax(s, m, alpha, sum, s_mul);
}

// the old O and l times alpha, plus this tile's row sums; p to bf16 A
// operands for P V
template <int D>
__device__ __forceinline__ void fwd_fold(float (&o)[D / 2], float (&l)[2],
                                         uint32_t (&pa)[4][4],
                                         const float (&s)[32],
                                         const float (&alpha)[2],
                                         const float (&sum)[2]) {
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
  acc_to_a(pa, s);                            // p rounded to bf16 for P V
}

// One consumer warpgroup's walk over the block's ring tiles [t0, t1) (ring
// slot (kt - t0) % kStages), computing those of [a0, a1) (a1 <= a0: none).
// All bounds must be warp-uniform (uniform()).  Every tile's stage is
// waited for and released by both warpgroups; a warpgroup holds at most the stage of the tile before the
// one it waits for, so the producer, which refills a stage kStages tiles
// later, never waits on it.
template <int D, class L, class Masked, class Visible>
__device__ __forceinline__ void fwd_walk(
    unsigned char* ring, uint64_t* full, uint64_t* empty, int t0, int t1,
    int a0, int a1, uint64_t q_desc, float s_mul, int t, Masked masked,
    Visible visible, float (&o)[D / 2], float (&m)[2], float (&l)[2]) {
  if (a1 <= a0) a0 = a1 = t1;
  auto slot = [&](int kt) { return (kt - t0) % L::kStages; };
  auto landed = [&](int kt) {
    mbar_wait(full + slot(kt), ((kt - t0) / L::kStages) & 1);
    return ring + slot(kt) * L::kStage;
  };
  for (int kt = t0; kt < a0; ++kt) {
    landed(kt);
    mbar_arrive(empty + slot(kt));
  }
  if (a0 < a1) {
    float s[32], alpha[2], sum[2];
    uint32_t pa[4][4];
    const unsigned char* st = landed(a0);
    fwd_scores<D>(s, q_desc, st);
    wgmma_wait<0>();
    keep(s);
    fwd_probs(s, m, alpha, sum, s_mul, a0, st, t, masked, visible);
    fwd_fold<D>(o, l, pa, s, alpha, sum);
    int prev = slot(a0);
    for (int kt = a0 + 1; kt < a1; ++kt) {
      st = landed(kt);
      fwd_scores<D>(s, q_desc, st);
      fwd_pv<D>(o, pa, ring + prev * L::kStage + L::kTile);
      wgmma_wait<1>();
      keep(s);
      fwd_probs(s, m, alpha, sum, s_mul, kt, st, t, masked, visible);
      wgmma_wait<0>();
      keep(o);
      keep_frags(pa);
      mbar_arrive(empty + prev);
      fwd_fold<D>(o, l, pa, s, alpha, sum);
      prev = slot(kt);
    }
    wgmma_fence();
    fwd_pv<D>(o, pa, ring + prev * L::kStage + L::kTile);
    wgmma_wait<0>();
    keep(o);
    keep_frags(pa);
    mbar_arrive(empty + prev);
  }
  for (int kt = a1; kt < t1; ++kt) {
    landed(kt);
    mbar_arrive(empty + slot(kt));
  }
}

// Rows r and r + 8 (accumulator layout) of a warpgroup's output: O / l
// rounded to bf16 at dst + row * stride (rows >= n skipped), lse = m + log
// l in the natural log at lse[row]; a row whose l is 0 (it saw no key)
// gets 0 and -inf.  Called by every lane (the row sums' shuffles).
template <int D>
__device__ __forceinline__ void fwd_store(bf16* __restrict__ dst,
                                          size_t stride,
                                          float* __restrict__ lse, int r,
                                          int n, const float (&o)[D / 2],
                                          const float (&m)[2],
                                          const float (&l)[2], int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = quad_sum(l[i]);
    const int row = r + 8 * i;
    if (row < n) {
      const bool has = lt > 0.f;
      const float inv = has ? 1.f / lt : 0.f;
      bf16* p = dst + (size_t)row * stride + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(p + 8 * j) =
            pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
      if (t == 0) lse[row] = has ? (m[i] + log2f(lt)) * kLn2 : -INFINITY;
    }
  }
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
