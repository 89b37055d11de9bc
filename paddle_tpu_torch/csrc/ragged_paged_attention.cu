// Ragged paged-KV attention for Hopper (sm_90a), written by hand: the float
// kernel here, and its int8-page variant further down.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py ::
// _ragged_kernel (launched by _ragged_launch).  What it computes, for each
// flat query token t and kv head h: the query group q[t, h*G:(h+1)*G, :]
// ([G, D], G = H / H_kv) attends causally (key position <= rel[t]) over the
// pages bt[seg[t], 0 .. rel[t] / bs] of the key/value caches
// [num_blocks, H_kv, bs, D], visited in ascending order with an online
// softmax whose running max m, sum l and accumulator acc stay in f32.  As on
// the TPU, q is pre-scaled by 1/sqrt(D) and rounded to its storage type, the
// scores and the PV product accumulate in f32, p is rounded to V's type
// before the PV product, l sums the unrounded p, and the output is acc / l.
//
// Layout: grid (Tq, H_kv), one 128-thread block per (token, kv head).  There
// is no scalar prefetch on Hopper, so each block reads its own seg/rel and
// block-table row.  The query group lives in registers, split over the 32
// lanes of every warp.  Keys are walked in tiles of whole pages (64 keys for
// bs = 16): each tile's K and V pages are copied into shared memory with
// 16-byte loads, each warp scores a quarter of the tile's keys (lane-split
// dot products reduced by shuffles), one warp per query row does the
// online-softmax update, and every thread then owns one head-dim column of
// the [G, D] accumulator for the PV product.  Keys past rel[t] are never
// touched, which is the TPU kernel's -inf mask (exp(-inf) == 0) without the
// arithmetic.  A padding token (seg naming the engine's null table row,
// rel == 0) reads one key of the null page and gives a finite row the caller
// discards.
//
// What bounds it: memory bandwidth.  Every token reads every live page of
// its row once per kv head, and does 4 * (rel + 1) * G * D flops against
// 4 * (rel + 1) * D bytes of bf16 K/V, far below the card's ~295 flop/byte
// ridge.  This first version loads a tile, then computes on it, with no
// overlap, and a prefill chunk's tokens each re-read the row's pages.  What
// a later version should change: tile a row's query tokens together so a
// prefill chunk reads each page once for many tokens (and reaches a tensor
// core tile, via wgmma), double-buffer the page tiles with TMA/cp.async, and
// split long rows over several blocks for decode.  The TPU's pages_per_step
// grid dimension has no counterpart: the key walk is a loop in the block.
//
// Paged decode (kDecode = true) replaces paddle_tpu/ops/pallas/
// paged_attention.py :: _decode_kernel (launched by _paged_decode_launch),
// which serves block_multihead_attention's decode.  It is the same walk
// with one query token per row: block (b, h) takes row b of the block table
// and reads lengths[b] keys, which is the ragged mask keypos <= rel with
// seg = b and rel = lengths[b] - 1, so no seg/rel arrays are built.  The
// TPU kernel's rounding points are the ragged kernel's (q * scale and p
// rounded to the storage type), and it too reads only live pages (the TPU
// kernel copies every table entry and skips the compute).  What bounds it:
// memory bandwidth, as above; B x H_kv blocks (256 at LLaMA-7B's B 8, H_kv
// 32) each walk a whole row, so long rows want a split over blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr int kTileKeys = 64;  // keys per tile when bs divides it

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// kDecode: block x is row x, and `rel` holds lengths (see the header)
template <typename T, int D, bool kDecode>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_kernel(const T* __restrict__ q,
                              const T* __restrict__ kc,
                              const T* __restrict__ vc,
                              const int* __restrict__ bt,
                              const int* __restrict__ seg,
                              const int* __restrict__ rel,
                              T* __restrict__ out, int H, int Hkv, int bs,
                              int num_blocks, int R, int nblk,
                              int pages_per_tile, float scale) {
  constexpr int kDpl = D / 32;                 // q/k elements per lane
  constexpr int kTpc = kThreads / D;           // threads per output column
  constexpr int kGpt = (kMaxG + kTpc - 1) / kTpc;  // query rows per thread
  constexpr int kVec = 16 / sizeof(T);         // elements per 16-byte load

  const int G = H / Hkv;
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile_keys = pages_per_tile * bs;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_tile = reinterpret_cast<T*>(smem_raw);            // [tile_keys, D]
  T* v_tile = k_tile + tile_keys * D;                    // [tile_keys, D]
  float* p_tile = reinterpret_cast<float*>(v_tile + tile_keys * D);
                                                         // [kMaxG, tile_keys]
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int row = kDecode ? t : min(max(seg[t], 0), R - 1);
  const int r = kDecode ? rel[t] - 1 : rel[t];
  const int n_keys = min(r + 1, nblk * bs);    // keys at positions <= r
  const int* bt_row = bt + (size_t)row * nblk;

  // query group in registers: lane owns elements lane*kDpl .. +kDpl of
  // every row, pre-scaled and rounded to T as the TPU kernel does
  float qr[kMaxG][kDpl];
  const T* q_t = q + ((size_t)t * H + (size_t)h * G) * D;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int i = 0; i < kDpl; ++i) {
      qr[g][i] = g < G ? to_f(from_f<T>(to_f(q_t[g * D + lane * kDpl + i])
                                        * scale))
                       : 0.f;
    }
  }
  if (tid < kMaxG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kGpt];
#pragma unroll
  for (int k = 0; k < kGpt; ++k) acc[k] = 0.f;
  const int col = tid % D;
  const int gsub = tid / D;
  __syncthreads();

  const int vecs_per_page = bs * D / kVec;
  for (int base = 0; base < n_keys; base += tile_keys) {
    const int nk = min(tile_keys, n_keys - base);
    const int np = (nk + bs - 1) / bs;
    const int page0 = base / bs;

    // 1. copy this tile's pages (one contiguous [bs, D] slab each)
    for (int i = tid; i < np * vecs_per_page; i += kThreads) {
      const int p = i / vecs_per_page;
      const int o = i - p * vecs_per_page;
      const int blk = min(max(bt_row[page0 + p], 0), num_blocks - 1);
      const size_t src = ((size_t)blk * Hkv + h) * bs * D;
      reinterpret_cast<uint4*>(k_tile + p * bs * D)[o] =
          reinterpret_cast<const uint4*>(kc + src)[o];
      reinterpret_cast<uint4*>(v_tile + p * bs * D)[o] =
          reinterpret_cast<const uint4*>(vc + src)[o];
    }
    __syncthreads();

    // 2. scores s[g, j] = q[g] . k[j], f32 accumulation
    for (int j = warp; j < nk; j += kWarps) {
      float kf[kDpl];
#pragma unroll
      for (int i = 0; i < kDpl; ++i) kf[i] = to_f(k_tile[j * D + lane * kDpl + i]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kDpl; ++i) s = fmaf(qr[g][i], kf[i], s);
          s = warp_sum(s);
          if (lane == 0) p_tile[g * tile_keys + j] = s;
        }
      }
    }
    __syncthreads();

    // 3. online softmax, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* prow = p_tile + g * tile_keys;
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, prow[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(prow[j] - m_new);
        sum += p;
        prow[j] = to_f(from_f<T>(p));          // p rounded to V's type
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p @ v
#pragma unroll
    for (int k = 0; k < kGpt; ++k) {
      const int g = gsub + k * kTpc;
      if (g < G) {
        const float* prow = p_tile + g * tile_keys;
        float pv = 0.f;
        for (int j = 0; j < nk; ++j)
          pv = fmaf(prow[j], to_f(v_tile[j * D + col]), pv);
        acc[k] = acc[k] * alpha_s[g] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kGpt; ++k) {
    const int g = gsub + k * kTpc;
    if (g < G) {
      out[((size_t)t * H + (size_t)h * G + g) * D + col] =
          from_f<T>(acc[k] / l_s[g]);
    }
  }
}

template <typename T, int D, bool kDecode = false>
int launch(const void* q, const void* kc, const void* vc, const void* bt,
           const void* seg, const void* rel, void* out, int Tq, int H,
           int Hkv, int bs, int num_blocks, int R, int nblk, float scale,
           cudaStream_t stream) {
  const int pages_per_tile = bs >= kTileKeys ? 1 : kTileKeys / bs;
  const int tile_keys = pages_per_tile * bs;
  const size_t smem = 2 * (size_t)tile_keys * D * sizeof(T) +
                      (size_t)kMaxG * tile_keys * sizeof(float);
  auto kern = ragged_paged_attention_kernel<T, D, kDecode>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Tq, Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(bt),
      static_cast<const int*>(seg), static_cast<const int*>(rel),
      static_cast<T*>(out), H, Hkv, bs, num_blocks, R, nblk, pages_per_tile,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int8 pages
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py :: _ragged_quant_kernel
// (launched by _ragged_quant_launch).  The same walk over int8 caches
// [num_blocks, H_kv, bs, D] with f32 scales [num_blocks, H_kv]: a page's
// value is int8 * scale[bt[seg[t], page], h], the scale looked up through
// the same block-table indirection as the page.  Each tile's pages are
// copied into shared memory as int8 (half the bytes of a bf16 tile) with
// their scales beside them, and dequantized as they are read.  The rounding
// is the TPU kernel's, not the float kernel's: q * scale stays f32, K and V
// are dequantized to f32, p is not rounded before the PV product, and only
// the output is cast to q's type.  What bounds it: memory bandwidth, as for
// the float kernel, on half the page bytes.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attention_q8_kernel(const T* __restrict__ q,
                                 const int8_t* __restrict__ kc,
                                 const int8_t* __restrict__ vc,
                                 const float* __restrict__ ks,
                                 const float* __restrict__ vs,
                                 const int* __restrict__ bt,
                                 const int* __restrict__ seg,
                                 const int* __restrict__ rel,
                                 T* __restrict__ out, int H, int Hkv, int bs,
                                 int num_blocks, int R, int nblk,
                                 int pages_per_tile, float scale) {
  constexpr int kDpl = D / 32;
  constexpr int kTpc = kThreads / D;
  constexpr int kGpt = (kMaxG + kTpc - 1) / kTpc;
  constexpr int kVec = 16;                     // int8 elements per 16 bytes
  constexpr int kMaxPages = kTileKeys / 8;     // bs >= 8

  const int G = H / Hkv;
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile_keys = pages_per_tile * bs;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* k_tile = reinterpret_cast<int8_t*>(smem_raw);  // [tile_keys, D]
  int8_t* v_tile = k_tile + tile_keys * D;               // [tile_keys, D]
  float* p_tile = reinterpret_cast<float*>(v_tile + tile_keys * D);
                                                         // [kMaxG, tile_keys]
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  __shared__ float ksc_s[kMaxPages], vsc_s[kMaxPages];

  const int row = min(max(seg[t], 0), R - 1);
  const int r = rel[t];
  const int n_keys = min(r + 1, nblk * bs);
  const int* bt_row = bt + (size_t)row * nblk;

  // query group in registers, pre-scaled in f32 (not rounded to T)
  float qr[kMaxG][kDpl];
  const T* q_t = q + ((size_t)t * H + (size_t)h * G) * D;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int i = 0; i < kDpl; ++i) {
      qr[g][i] = g < G ? to_f(q_t[g * D + lane * kDpl + i]) * scale : 0.f;
    }
  }
  if (tid < kMaxG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kGpt];
#pragma unroll
  for (int k = 0; k < kGpt; ++k) acc[k] = 0.f;
  const int col = tid % D;
  const int gsub = tid / D;
  __syncthreads();

  const int vecs_per_page = bs * D / kVec;
  for (int base = 0; base < n_keys; base += tile_keys) {
    const int nk = min(tile_keys, n_keys - base);
    const int np = (nk + bs - 1) / bs;
    const int page0 = base / bs;

    // 1. copy this tile's int8 pages and their scales
    for (int i = tid; i < np * vecs_per_page; i += kThreads) {
      const int p = i / vecs_per_page;
      const int o = i - p * vecs_per_page;
      const int blk = min(max(bt_row[page0 + p], 0), num_blocks - 1);
      const size_t src = ((size_t)blk * Hkv + h) * bs * D;
      reinterpret_cast<uint4*>(k_tile + p * bs * D)[o] =
          reinterpret_cast<const uint4*>(kc + src)[o];
      reinterpret_cast<uint4*>(v_tile + p * bs * D)[o] =
          reinterpret_cast<const uint4*>(vc + src)[o];
    }
    if (tid < np) {
      const int blk = min(max(bt_row[page0 + tid], 0), num_blocks - 1);
      ksc_s[tid] = ks[(size_t)blk * Hkv + h];
      vsc_s[tid] = vs[(size_t)blk * Hkv + h];
    }
    __syncthreads();

    // 2. scores s[g, j] = q[g] . (k[j] * kscale), f32
    for (int j = warp; j < nk; j += kWarps) {
      const float ksc = ksc_s[j / bs];
      float kf[kDpl];
#pragma unroll
      for (int i = 0; i < kDpl; ++i)
        kf[i] = (float)k_tile[j * D + lane * kDpl + i] * ksc;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < kDpl; ++i) s = fmaf(qr[g][i], kf[i], s);
          s = warp_sum(s);
          if (lane == 0) p_tile[g * tile_keys + j] = s;
        }
      }
    }
    __syncthreads();

    // 3. online softmax, one warp per query row; p stays f32
    for (int g = warp; g < G; g += kWarps) {
      float* prow = p_tile + g * tile_keys;
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, prow[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(prow[j] - m_new);
        sum += p;
        prow[j] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p @ (v * vscale)
#pragma unroll
    for (int k = 0; k < kGpt; ++k) {
      const int g = gsub + k * kTpc;
      if (g < G) {
        const float* prow = p_tile + g * tile_keys;
        float pv = 0.f;
        for (int j = 0; j < nk; ++j)
          pv = fmaf(prow[j], (float)v_tile[j * D + col] * vsc_s[j / bs], pv);
        acc[k] = acc[k] * alpha_s[g] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kGpt; ++k) {
    const int g = gsub + k * kTpc;
    if (g < G) {
      out[((size_t)t * H + (size_t)h * G + g) * D + col] =
          from_f<T>(acc[k] / l_s[g]);
    }
  }
}

template <typename T, int D>
int launch_q8(const void* q, const void* kc, const void* vc, const void* ks,
              const void* vs, const void* bt, const void* seg,
              const void* rel, void* out, int Tq, int H, int Hkv, int bs,
              int num_blocks, int R, int nblk, float scale,
              cudaStream_t stream) {
  const int pages_per_tile = bs >= kTileKeys ? 1 : kTileKeys / bs;
  const int tile_keys = pages_per_tile * bs;
  const size_t smem = 2 * (size_t)tile_keys * D +
                      (size_t)kMaxG * tile_keys * sizeof(float);
  auto kern = ragged_paged_attention_q8_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(Tq, Hkv);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kc),
      static_cast<const int8_t*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(bt),
      static_cast<const int*>(seg), static_cast<const int*>(rel),
      static_cast<T*>(out), H, Hkv, bs, num_blocks, R, nblk, pages_per_tile,
      scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Every other head dim and query group
//
// The kernels above keep the query group in registers (qr[kMaxG][D / 32])
// and give each output column kThreads / D threads, which holds for D in
// {64, 128} and G <= kMaxG only.  This kernel takes the rest of what the
// JAX rules (paged_attention.py supports / ragged_supports) take: D 64 or
// any multiple of 128, any G = H / H_kv.  Grid (Tq, H_kv, n_gc * n_dc): the
// query group is split into chunks of at most kMaxG heads and the output
// columns into chunks of kThreads, one column a thread; every block walks
// its row's keys for its own pair of chunks.  It scores its query heads
// against the whole head dim, reading q and each key row straight from
// device memory (lane i takes elements i, i + 32, ...), keeps the online
// softmax of the kernels above, and accumulates its columns of p @ v.  So
// shared memory does not grow with D, and a block re-reads its pages once
// for each chunk pair: simple and right, not fast.  The rounding points
// are those of the kernel it stands in for: kQuant the int8-page kernel's
// (q * scale in f32, p unrounded), otherwise the float kernel's (q * scale
// and p rounded to T).  kDecode as above.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T, typename KV, bool kQuant, bool kDecode>
__global__ void __launch_bounds__(kThreads)
paged_attention_any_kernel(const T* __restrict__ q,
                           const KV* __restrict__ kc,
                           const KV* __restrict__ vc,
                           const float* __restrict__ ks,
                           const float* __restrict__ vs,
                           const int* __restrict__ bt,
                           const int* __restrict__ seg,
                           const int* __restrict__ rel,
                           T* __restrict__ out, int H, int Hkv, int D,
                           int bs, int num_blocks, int R, int nblk, int n_dc,
                           float scale) {
  const int G = H / Hkv;
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int gc = blockIdx.z / n_dc;
  const int col = (blockIdx.z - gc * n_dc) * kThreads + threadIdx.x;
  const int g0 = gc * kMaxG;
  const int Gc = min(kMaxG, G - g0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ float p_tile[kMaxG][kTileKeys];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  __shared__ size_t key_off[kTileKeys];    // element offset of each key row
  __shared__ float ksc_s[kTileKeys], vsc_s[kTileKeys];

  const int row = kDecode ? t : min(max(seg[t], 0), R - 1);
  const int r = kDecode ? rel[t] - 1 : rel[t];
  const int n_keys = min(r + 1, nblk * bs);
  const int* bt_row = bt + (size_t)row * nblk;
  const T* q_t = q + ((size_t)t * H + (size_t)h * G + g0) * D;

  if (tid < kMaxG) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;

  for (int base = 0; base < n_keys; base += kTileKeys) {
    const int nk = min(kTileKeys, n_keys - base);

    // 1. where each key of the tile lives (and its page's scales)
    if (tid < nk) {
      const int key = base + tid;
      const int blk = min(max(bt_row[key / bs], 0), num_blocks - 1);
      key_off[tid] = (((size_t)blk * Hkv + h) * bs + key % bs) * D;
      if (kQuant) {
        ksc_s[tid] = ks[(size_t)blk * Hkv + h];
        vsc_s[tid] = vs[(size_t)blk * Hkv + h];
      }
    }
    __syncthreads();

    // 2. scores s[g, j] = q[g] . k[j] over the whole head dim, f32
    for (int j = warp; j < nk; j += kWarps) {
      const KV* krow = kc + key_off[j];
      const float ksc = kQuant ? ksc_s[j] : 1.f;
      float s[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
      for (int i = lane; i < D; i += 32) {
        const float kf = kQuant ? to_f(krow[i]) * ksc : to_f(krow[i]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < Gc) {
            const float qs = to_f(q_t[g * D + i]) * scale;
            s[g] = fmaf(kQuant ? qs : to_f(from_f<T>(qs)), kf, s[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < Gc) {
          const float v = warp_sum(s[g]);
          if (lane == 0) p_tile[g][j] = v;
        }
      }
    }
    __syncthreads();

    // 3. online softmax, one warp per query row
    for (int g = warp; g < Gc; g += kWarps) {
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, p_tile[g][j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(p_tile[g][j] - m_new);
        sum += p;
        p_tile[g][j] = kQuant ? p : to_f(from_f<T>(p));
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 4. this thread's column: acc = acc * alpha + p @ v
    if (col < D) {
      float pv[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) pv[g] = 0.f;
      for (int j = 0; j < nk; ++j) {
        const float vf = kQuant ? to_f(vc[key_off[j] + col]) * vsc_s[j]
                                : to_f(vc[key_off[j] + col]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) pv[g] = fmaf(p_tile[g][j], vf, pv[g]);
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < Gc) acc[g] = acc[g] * alpha_s[g] + pv[g];
    }
    __syncthreads();
  }

  if (col < D) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < Gc)
        out[((size_t)t * H + (size_t)h * G + g0 + g) * D + col] =
            from_f<T>(acc[g] / l_s[g]);
    }
  }
}

template <typename T, typename KV, bool kQuant, bool kDecode>
int launch_any(const void* q, const void* kc, const void* vc, const void* ks,
               const void* vs, const void* bt, const void* seg,
               const void* rel, void* out, int Tq, int H, int Hkv, int D,
               int bs, int num_blocks, int R, int nblk, float scale,
               cudaStream_t stream) {
  const int n_gc = (H / Hkv + kMaxG - 1) / kMaxG;
  const int n_dc = (D + kThreads - 1) / kThreads;
  dim3 grid(Tq, Hkv, n_gc * n_dc);
  paged_attention_any_kernel<T, KV, kQuant, kDecode>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(kc),
          static_cast<const KV*>(vc), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(bt),
          static_cast<const int*>(seg), static_cast<const int*>(rel),
          static_cast<T*>(out), H, Hkv, D, bs, num_blocks, R, nblk, n_dc,
          scale);
  return (int)cudaGetLastError();
}

// the kernels above where they apply, this one elsewhere
bool specialised(int H, int Hkv, int D) {
  return (D == 64 || D == 128) && H / Hkv <= kMaxG;
}

}  // namespace

// C entry of the int8-page kernel, bound with ctypes.  As the float entry,
// plus the f32 scale pools ks/vs [num_blocks, H_kv]; kc/vc are int8, and
// dtype names q's (and out's) type.
extern "C" int paddle_ragged_paged_attention_q8(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* bt, const void* seg, const void* rel,
    void* out, int Tq, int H, int Hkv, int D, int bs, int num_blocks, int R,
    int nblk, int dtype, float scale, void* stream) {
  if (Tq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!specialised(H, Hkv, D)) {
    if (dtype == 0)
      return launch_any<float, int8_t, true, false>(
          q, kc, vc, ks, vs, bt, seg, rel, out, Tq, H, Hkv, D, bs,
          num_blocks, R, nblk, scale, s);
    if (dtype == 1)
      return launch_any<__nv_bfloat16, int8_t, true, false>(
          q, kc, vc, ks, vs, bt, seg, rel, out, Tq, H, Hkv, D, bs,
          num_blocks, R, nblk, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0 && D == 64)
    return launch_q8<float, 64>(q, kc, vc, ks, vs, bt, seg, rel, out, Tq, H,
                                Hkv, bs, num_blocks, R, nblk, scale, s);
  if (dtype == 0 && D == 128)
    return launch_q8<float, 128>(q, kc, vc, ks, vs, bt, seg, rel, out, Tq, H,
                                 Hkv, bs, num_blocks, R, nblk, scale, s);
  if (dtype == 1 && D == 64)
    return launch_q8<__nv_bfloat16, 64>(q, kc, vc, ks, vs, bt, seg, rel, out,
                                        Tq, H, Hkv, bs, num_blocks, R, nblk,
                                        scale, s);
  if (dtype == 1 && D == 128)
    return launch_q8<__nv_bfloat16, 128>(q, kc, vc, ks, vs, bt, seg, rel,
                                         out, Tq, H, Hkv, bs, num_blocks, R,
                                         nblk, scale, s);
  return (int)cudaErrorInvalidValue;
}

// C entry, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch (0 on success); the caller checks it.
// The wrapper (paddle_tpu_torch/ops/paged_attention.py) has already checked
// shapes, types and contiguity: D 64 or a multiple of 128, H % Hkv == 0,
// bs % 8 == 0.  D in {64, 128} with H / Hkv <= 8 takes the specialised
// kernel, every other shape paged_attention_any_kernel.
extern "C" int paddle_ragged_paged_attention(
    const void* q, const void* kc, const void* vc, const void* bt,
    const void* seg, const void* rel, void* out, int Tq, int H, int Hkv,
    int D, int bs, int num_blocks, int R, int nblk, int dtype, float scale,
    void* stream) {
  if (Tq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!specialised(H, Hkv, D)) {
    if (dtype == 0)
      return launch_any<float, float, false, false>(
          q, kc, vc, nullptr, nullptr, bt, seg, rel, out, Tq, H, Hkv, D, bs,
          num_blocks, R, nblk, scale, s);
    if (dtype == 1)
      return launch_any<__nv_bfloat16, __nv_bfloat16, false, false>(
          q, kc, vc, nullptr, nullptr, bt, seg, rel, out, Tq, H, Hkv, D, bs,
          num_blocks, R, nblk, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, kc, vc, bt, seg, rel, out, Tq, H, Hkv, bs,
                             num_blocks, R, nblk, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, kc, vc, bt, seg, rel, out, Tq, H, Hkv, bs,
                              num_blocks, R, nblk, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, kc, vc, bt, seg, rel, out, Tq, H,
                                     Hkv, bs, num_blocks, R, nblk, scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, kc, vc, bt, seg, rel, out, Tq, H,
                                      Hkv, bs, num_blocks, R, nblk, scale, s);
  return (int)cudaErrorInvalidValue;
}

// C entry of the paged decode kernel, bound with ctypes.  q and out are
// [B, H, D]; bt is [B, nblk] int32 (entries clamped into range in the
// kernel); lens is [B] int32, the valid positions of each row (>= 1).  The
// wrapper has checked what the float entry's has.
extern "C" int paddle_paged_decode_attention(
    const void* q, const void* kc, const void* vc, const void* bt,
    const void* lens, void* out, int B, int H, int Hkv, int D, int bs,
    int num_blocks, int nblk, int dtype, float scale, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!specialised(H, Hkv, D)) {
    if (dtype == 0)
      return launch_any<float, float, false, true>(
          q, kc, vc, nullptr, nullptr, bt, nullptr, lens, out, B, H, Hkv, D,
          bs, num_blocks, B, nblk, scale, s);
    if (dtype == 1)
      return launch_any<__nv_bfloat16, __nv_bfloat16, false, true>(
          q, kc, vc, nullptr, nullptr, bt, nullptr, lens, out, B, H, Hkv, D,
          bs, num_blocks, B, nblk, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0 && D == 64)
    return launch<float, 64, true>(q, kc, vc, bt, nullptr, lens, out, B, H,
                                   Hkv, bs, num_blocks, B, nblk, scale, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128, true>(q, kc, vc, bt, nullptr, lens, out, B, H,
                                    Hkv, bs, num_blocks, B, nblk, scale, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64, true>(q, kc, vc, bt, nullptr, lens, out,
                                           B, H, Hkv, bs, num_blocks, B, nblk,
                                           scale, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128, true>(q, kc, vc, bt, nullptr, lens,
                                            out, B, H, Hkv, bs, num_blocks, B,
                                            nblk, scale, s);
  return (int)cudaErrorInvalidValue;
}
