// Ragged paged-KV attention for Hopper (sm_90a), written by hand: the float
// walk, its int8-page variant and the paged decode, one kernel template
// (paged_walk_kernel), plus paged_attention_any_kernel for the head dims and
// query groups the template does not take.
//
// Replaces three TPU kernels of paddle_tpu/ops/pallas/paged_attention.py:
//  - _ragged_kernel (launched by _ragged_launch): each flat query token t
//    and kv head h, the query group q[t, h*G:(h+1)*G, :] ([G, D], G = H /
//    H_kv) attends causally (key position <= rel[t]) over the pages
//    bt[seg[t], 0 .. rel[t] / bs] of the caches [num_blocks, H_kv, bs, D],
//    online softmax with m, l and acc in f32.  Rounding points: q * scale
//    rounded to the storage type, scores and PV accumulated in f32, p rounded
//    to V's type before PV, l summing the unrounded p, output acc / l.
//  - _ragged_quant_kernel (_ragged_quant_launch): the same walk over int8
//    pages with f32 scales [num_blocks, H_kv] looked up through the table.
//    Its rounding points: q * scale stays f32, p is not rounded, only the
//    output is cast.  The page scales are applied after the products, in
//    f32: ksc times each key's score, vsc folded into p before PV.
//  - _decode_kernel (_paged_decode_launch), block_multihead_attention's
//    decode: one query token a row, row b of the table, lengths[b] keys
//    (the ragged mask with seg = b, rel = lengths[b] - 1), the float
//    kernel's rounding points.
//
// What bounds them: memory bandwidth.  A decode row reads each live key's K
// and V once per kv head and does 4 G D flops a key against 4 D bytes
// (bf16), far below the card's ~295 flop/byte ridge; a prefill chunk's
// tokens share their row's pages, so a tile of them reads each page once.
//
// Design:
//  - Work is (query tile, kv head, key split).  A query tile is the (token,
//    g) rows of up to TT consecutive tokens of one table row, cut from the
//    row's first token on (TT = 64 / G for bf16 q, 8 / G for f32, 1 for the
//    decode entry).  A tile of at most 8 rows (a decode token's group, an
//    f32 tile) has its keys cut into splits of `split` keys (about 512), so
//    a 2,000-key row runs on several SMs; each split leaves its (m, l, acc)
//    in f32 in the wrapper's scratch, and the last split to finish (an
//    atomic counter, which that split resets to 0) merges them in split
//    order.  So one launch, no memset, and the output repeats bit for bit.
//  - The work list is found on the card from seg / rel alone (the wrapper
//    adds no device op): every block scans seg (a run of equal seg is a row;
//    the tiles start at the run's first token and every TT tokens on) and
//    prefix-sums the tiles' splits.  A persistent grid (as many blocks as
//    the SMs hold) takes the items (tile, kv head, split) from a queue in
//    list order, one atomic a take, made while the block walks its item;
//    the last block done sets the queue back to 0.  seg must be
//    non-decreasing, as ragged_segments gives it (the engine's pad tokens
//    name its null row last): the wrapper's tile bound holds only then,
//    so a launch whose seg falls anywhere writes NaN over its whole output
//    rather than drop the tiles past the bound.
//  - Pages come by TMA into a ring of kStages stages with mbarrier
//    completion: one box per page piece (bh rows of 128 bytes, bh the
//    largest power of two up to the stage's keys that divides bs), the row
//    (blk * H_kv + h) * bs + offset of the cache seen as [num_blocks * H_kv
//    * bs, D], in the 128-byte swizzle (64-byte for int8 at D 64).  A stage
//    is KT keys of K and of V, 32 KB at D 128 whatever the type (KT 64
//    bf16, 128 int8, 32 f32).  Thread 0 fills an item's first stages; the
//    ring is refilled as soon as the stage's last reader lets it go.  Over
//    float pages a block keeps two stages and at most 128 registers a
//    thread, so two blocks share an SM and one's item set-up and merge
//    overlap the other's stream (the ring's depth, 2 to 4 stages, moved
//    nothing; the second block did); int8 pages keep three or four.
//  - Tiles of at most 8 rows run on the CUDA cores: warp w takes KT / 8
//    keys of each stage for every row, lane (key, part of D), the parts'
//    dot products added by shuffles (the swizzle puts the 8 keys a 16-byte
//    load phase reads on distinct banks), with its own online softmax; the
//    last warp to release a stage refills it (a shared counter elects it;
//    no block barrier in the walk), and the warps' (m, l, acc) are merged
//    in warp order at the end.
//  - bf16 tiles of more than 8 rows (prefill chunks) run on wgmma:
//    warpgroup 0 holds the 64-row Q tile, S = Q K^T with K K-major from its
//    box, the online softmax in f32 registers, P V with V read N-major
//    (attention_common.cuh's steps, as the flash forward).  Over int8 pages
//    every thread first turns the stage's codes into bf16 (exact) in cbuf,
//    q * scale and p * vscale go in as two bf16 terms each (hi + lo, the
//    dequant matmul's device for f32 x), and the page scales multiply in
//    f32: ksc each key's score column, vsc folded into p.
// ---------------------------------------------------------------------------

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kWalkThreads = 256;
constexpr int kMaxG = 8;              // rows of a CUDA-core tile

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

// ---------------------------------------------------------------------------
// the walk's shapes, per (q type, page type, D)
// ---------------------------------------------------------------------------

template <typename T, typename KV, int D, bool kDecode>
struct Walk {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  // bf16 tiles of more than 8 rows go to the tensor cores
  static constexpr bool kWgmma = std::is_same<T, bf16>::value && !kDecode;
  static constexpr int kES = sizeof(KV);
  static constexpr int kW = (kES == 1 && D == 64) ? 64 : 128;  // swizzle row
  static constexpr int kCBE = kW / kES;       // elements of a box row
  static constexpr int kNCB = D / kCBE;       // boxes across D
  static constexpr int kKT = kES == 1 ? 128 : (kES == 4 ? 32 : 64);
  static constexpr int kV16 = 16 / kES;       // elements of 16 bytes
  static constexpr int kKPW = kKT / 8;        // PV keys a warp
  static constexpr int kCPT = D / 32;         // PV columns a thread
  static constexpr int kHalf = kKT * D * kES;  // K (or V) of a stage
  static constexpr int kStage = 2 * kHalf;
  // two blocks share an SM (two stages each, at most 128 registers a
  // thread) except over int8 pages, whose wgmma path needs more of both
  static constexpr int kBlocks = kQuant ? 1 : 2;
  static constexpr int kStages = kBlocks == 2 ? 2 : D == 128 ? 3 : 4;
  static constexpr int kRing = kStages * kStage;
  // the wgmma Q tile (int8 pages: its hi and lo bf16 terms)
  static constexpr int kQt = kWgmma ? (kQuant ? 2 : 1) * 64 * D * 2 : 0;
  // int8 pages on wgmma: a stage's K and V as bf16 (the codes, exact),
  // two 64-key tiles each, and each key's scales
  static constexpr int kCbuf = kWgmma && kQuant ? 2 * kKT * D * 2 : 0;
};

// shared memory past the ring (byte offsets from the 1024-aligned base);
// the host sizes the launch with the same function
struct WalkLayout {
  int qt, cbuf, kscl, qs, p, ml, lim_tok, lim_row, misc, bars, pg, ksc, vsc,
      tstart, tpre, tkeys, trow, bytes;
};

template <class L, int D>
__host__ __device__ inline WalkLayout walk_layout(int ntiles_max,
                                                  int maxpages) {
  WalkLayout o;
  int at = L::kRing;
  o.qt = at;       at += L::kQt;
  o.cbuf = at;     at += L::kCbuf;
  o.kscl = at;     at += L::kCbuf ? 2 * L::kKT * 4 : 0;
  o.qs = at;       at += kMaxG * D * 4;
  o.p = at;        at += kMaxG * L::kKT * 4;      // p a warp, row, key
  o.ml = at;       at += 2 * kMaxG * 8 * 4;   // (m, l) a warp and row
  o.lim_tok = at;  at += 64 * 4;
  o.lim_row = at;  at += 64 * 4;
  // misc: the scans' scratch [0, 8), then the last-split flag [0], the
  // queue's next item [1], the stages' release counts [16, 16 + kStages)
  o.misc = at;     at += 64 * 4;
  o.bars = at;     at += 8 * L::kStages;
  o.pg = at;       at += 4 * maxpages;
  o.ksc = at;      at += L::kQuant ? 4 * maxpages : 0;
  o.vsc = at;      at += L::kQuant ? 4 * maxpages : 0;
  o.tstart = at;   at += 4 * (ntiles_max + 1);
  o.tpre = at;     at += 4 * (ntiles_max + 1);
  o.tkeys = at;    at += 4 * (ntiles_max + 1);
  o.trow = at;     at += 4 * (ntiles_max + 1);
  o.bytes = at;
  return o;
}

struct WalkArgs {
  const void* q;
  void* out;
  const int* bt;
  const int* seg;         // ragged: seg; decode: unused
  const int* rel;         // ragged: rel; decode: lengths
  const float* ks;        // int8 page scales
  const float* vs;
  float* part;            // split partials [ntiles_max, H_kv, nsplit, 8, D+2]
  int* cnt;               // split counters [ntiles_max, H_kv] and the item
                          // queue's two, zero between calls
  int Tq, H, Hkv, G, bs, num_blocks, R, nblk;
  int TT, split, nsplit, ntiles_max, maxpages, bh;
  float scale;
};

// 16 bytes of page elements as f32
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
// int8 x: the bytes of x + 128 under the exponent of 2^23, minus 2^23 + 128
// (exact, and on the full-rate pipes, unlike I2F)
__device__ __forceinline__ float s8_at(uint32_t biased, int b) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 | b)) -
         8388736.f;
}
__device__ __forceinline__ void unpack(const uint4& r, float (&f)[16]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int b = 0; b < 4; ++b) f[4 * i + b] = s8_at(u, b);
  }
}

// kCPT consecutive page elements at p (one 16-byte chunk holds them) as f32
template <typename KV, int N>
__device__ __forceinline__ void load_cols(const unsigned char* p,
                                          float (&f)[N]) {
  if constexpr (std::is_same<KV, float>::value) {
    if constexpr (N == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      f[0] = v.x; f[1] = v.y;
    }
  } else if constexpr (std::is_same<KV, bf16>::value) {
    if constexpr (N == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      f[0] = __uint_as_float(v.x << 16);
      f[1] = __uint_as_float(v.x & 0xffff0000u);
      f[2] = __uint_as_float(v.y << 16);
      f[3] = __uint_as_float(v.y & 0xffff0000u);
    } else {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
      f[0] = __uint_as_float(v << 16);
      f[1] = __uint_as_float(v & 0xffff0000u);
    }
  } else {
    uint32_t v;
    if constexpr (N == 4)
      v = *reinterpret_cast<const uint32_t*>(p);
    else
      v = *reinterpret_cast<const uint16_t*>(p);
    v ^= 0x80808080u;
#pragma unroll
    for (int b = 0; b < N; ++b) f[b] = s8_at(v, b);
  }
}

// byte offset, in a stage's K or V part, of 16-byte chunk c of key row j
template <class L>
__device__ __forceinline__ uint32_t chunk_off(int j, int c) {
  constexpr int kCh = L::kW / 16;             // chunks of a box row
  const int cb = c / kCh, cc = c % kCh;
  const int sw = ((j * L::kW) >> 7) & (kCh - 1);
  return cb * (L::kKT * L::kW) + j * L::kW + ((cc ^ sw) << 4);
}

// exclusive scan of v over the block's threads in order (sum, or max with
// identity `id`); *total gets the whole.  Called by every thread.
template <bool kMaxOp>
__device__ __forceinline__ int block_scan(int v, int id, int* scratch,
                                          int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = kMaxOp ? max(x, y) : x + y;
  }
  int ex = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) ex = id;
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWalkThreads / 32 ? scratch[lane] : id;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = kMaxOp ? max(w, y) : w + y;
    }
    if (lane < kWalkThreads / 32) scratch[lane] = w;
  }
  __syncthreads();
  const int before = warp ? scratch[warp - 1] : id;
  *total = scratch[kWalkThreads / 32 - 1];
  __syncthreads();
  return kMaxOp ? max(before, ex) : before + ex;
}

// the walk's state for one item, the same in every thread
struct Item {
  int k, h, z, st, ntok, M, row, ns, nkeys, k0, k1, nst, pg0, run;
};

// Stage s of the item (ring slot (it.run + s) % kStages): its pages' boxes
// by TMA, counted in on the slot's barrier.  One thread.
template <class L>
__device__ __forceinline__ void issue(const WalkArgs& a, const Item& it,
                                      int s, unsigned char* ring,
                                      uint64_t* bars, const int* pg,
                                      const CUtensorMap* tk,
                                      const CUtensorMap* tv) {
  const int slot = (it.run + s) % L::kStages;
  const int kb = it.k0 + s * L::kKT;
  const int nk = min(L::kKT, it.k1 - kb);
  const int nbox = (nk + a.bh - 1) / a.bh;
  uint64_t* bar = bars + slot;
  unsigned char* kd = ring + slot * L::kStage;
  unsigned char* vd = kd + L::kHalf;
  mbar_expect(bar, 2 * nbox * L::kNCB * a.bh * L::kW);
  for (int j = 0; j < nbox; ++j) {
    const int pos = kb + j * a.bh;
    const int blk = pg[pos / a.bs - it.pg0];
    const int row = (blk * a.Hkv + it.h) * a.bs + pos % a.bs;
#pragma unroll
    for (int cb = 0; cb < L::kNCB; ++cb) {
      const int off = cb * (L::kKT * L::kW) + j * a.bh * L::kW;
      tma_2d(kd + off, tk, cb * L::kCBE, row, bar);
      tma_2d(vd + off, tv, cb * L::kCBE, row, bar);
    }
  }
}

template <bool kDecode>
__device__ __forceinline__ int key_limit(const WalkArgs& a, int t) {
  const int cap = a.nblk * a.bs;
  const int n = kDecode ? a.rel[t] : a.rel[t] + 1;
  return min(max(n, 1), cap);
}

// One kernel for the three entries.  kDecode: the decode entry (tile b is
// row b's one token, `rel` holds lengths).
template <typename T, typename KV, int D, bool kDecode>
__global__ void __launch_bounds__(kWalkThreads,
                                  Walk<T, KV, D, kDecode>::kBlocks)
paged_walk_kernel(const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const WalkArgs a) {
  using L = Walk<T, KV, D, kDecode>;
  constexpr bool kMma = L::kWgmma;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const WalkLayout lay = walk_layout<L, D>(a.ntiles_max, a.maxpages);
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + lay.qs);
  float* p_s = reinterpret_cast<float*>(smem + lay.p);
  float* ml_s = reinterpret_cast<float*>(smem + lay.ml);
  int* lim_tok = reinterpret_cast<int*>(smem + lay.lim_tok);
  int* lim_row = reinterpret_cast<int*>(smem + lay.lim_row);
  int* misc = reinterpret_cast<int*>(smem + lay.misc);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  int* pg = reinterpret_cast<int*>(smem + lay.pg);
  float* ksc_s = reinterpret_cast<float*>(smem + lay.ksc);
  float* vsc_s = reinterpret_cast<float*>(smem + lay.vsc);
  int* tstart = reinterpret_cast<int*>(smem + lay.tstart);
  int* tpre = reinterpret_cast<int*>(smem + lay.tpre);
  int* tkeys = reinterpret_cast<int*>(smem + lay.tkeys);
  int* trow = reinterpret_cast<int*>(smem + lay.trow);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G, H = a.H, Hkv = a.Hkv;
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);

  // ---- the ring's barriers; the ring zeroed (a tile's keys past its last
  // box never read anything but zeros or earlier pages)
  if (tid < L::kStages) misc[16 + tid] = 0;       // stage release counts
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < (L::kRing + L::kQt + L::kCbuf) / 16;
       i += kWalkThreads)
    reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_async_smem();

  // ---- the work list: tiles (first token, keys) and their splits' prefix
  int ntiles;
  if constexpr (kDecode) {
    ntiles = a.Tq;
    for (int k = tid; k < ntiles; k += kWalkThreads) tstart[k] = k;
    if (tid == 0) tstart[ntiles] = ntiles;
  } else {
    const int per = (a.Tq + kWalkThreads - 1) / kWalkThreads;
    const int t0 = min(tid * per, a.Tq), t1 = min(t0 + per, a.Tq);
    auto row_start = [&](int t) { return t == 0 || a.seg[t] != a.seg[t - 1]; };
    int lastf = -1, falls = 0;
    for (int t = t0; t < t1; ++t) {
      if (row_start(t)) lastf = t;
      falls |= t > 0 && a.seg[t] < a.seg[t - 1];
    }
    int dummy;
    const int carry = block_scan<true>(lastf, -1, misc, &dummy);
    int rs = carry, cnt = 0;
    for (int t = t0; t < t1; ++t) {
      if (row_start(t)) rs = t;
      cnt += (t - rs) % a.TT == 0;
    }
    int base = block_scan<false>(cnt, 0, misc, &ntiles);
    rs = carry;
    for (int t = t0; t < t1; ++t) {
      if (row_start(t)) rs = t;
      if ((t - rs) % a.TT == 0) {
        if (base < a.ntiles_max) tstart[base] = t;
        ++base;
      }
    }
    // seg that falls somewhere (or more tiles than the plan's bound, which
    // only such a seg or one past R gives) makes every block write NaN
    // over the whole output: a loud result, not a truncated work list
    if (__syncthreads_or(falls || ntiles > a.ntiles_max)) {
      const size_t n = (size_t)a.Tq * H * D;
      for (size_t i = (size_t)blockIdx.x * kWalkThreads + tid; i < n;
           i += (size_t)gridDim.x * kWalkThreads)
        out[i] = from_f<T>(__int_as_float(0x7fc00000));
      return;
    }
    if (tid == 0) tstart[ntiles] = a.Tq;
  }
  __syncthreads();
  {
    const int per = (ntiles + kWalkThreads - 1) / kWalkThreads;
    const int k0 = min(tid * per, ntiles), k1 = min(k0 + per, ntiles);
    int sum = 0;
    for (int k = k0; k < k1; ++k) {
      const int t0 = tstart[k], t1 = min(tstart[k + 1], t0 + a.TT);
      int nk = 1;
      for (int t = t0; t < t1; ++t) nk = max(nk, key_limit<kDecode>(a, t));
      const int ns = (t1 - t0) * G <= kMaxG ? (nk + a.split - 1) / a.split : 1;
      tkeys[k] = nk;
      trow[k] = kDecode ? k : min(max(a.seg[t0], 0), a.R - 1);
      tpre[k] = ns;
      sum += ns;
    }
    int total;
    int run = block_scan<false>(sum, 0, misc, &total);
    for (int k = k0; k < k1; ++k) {
      const int ns = tpre[k];
      tpre[k] = run;
      run += ns;
    }
    if (tid == 0) tpre[ntiles] = total;
  }
  // ---- the items (tile, kv head, split), taken from a queue in order by
  // a persistent grid: a block takes its next item while it walks one
  // (queue[0], the next item; queue[1], the blocks done; the last block
  // done sets both back to 0 for the next launch)
  int* queue = a.cnt + (size_t)a.ntiles_max * Hkv;
  if (tid == 0) misc[1] = atomicAdd(queue, 1);
  __syncthreads();
  const int n_items = tpre[ntiles] * Hkv;
  int run = 0;                          // stages this block has consumed
  for (int j = misc[1]; j < n_items; j = misc[1]) {
    Item it;
    const int u = j / Hkv;
    it.h = j - u * Hkv;
    int lo = 0, hi = ntiles;            // largest k with tpre[k] <= u
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (tpre[mid] <= u) lo = mid; else hi = mid;
    }
    it.k = lo;
    it.z = u - tpre[lo];
    it.st = tstart[lo];
    it.ntok = min(tstart[lo + 1] - it.st, a.TT);
    it.M = it.ntok * G;
    it.ns = tpre[lo + 1] - tpre[lo];
    it.nkeys = tkeys[lo];
    it.k0 = it.z * a.split;
    it.k1 = it.ns == 1 ? it.nkeys : min(it.k0 + a.split, it.nkeys);
    it.nst = (it.k1 - it.k0 + L::kKT - 1) / L::kKT;
    it.pg0 = it.k0 / a.bs;
    it.row = trow[lo];
    it.run = run;
    const int np = (it.k1 - 1) / a.bs - it.pg0 + 1;
    const bool wg = kMma && it.M > kMaxG;

    // ---- set-up: the item's pages (and scales), limits, query rows
    const int* bt_row = a.bt + (size_t)it.row * a.nblk;
    for (int i = tid; i < np; i += kWalkThreads) {
      const int blk = min(max(bt_row[it.pg0 + i], 0), a.num_blocks - 1);
      pg[i] = blk;
      if constexpr (L::kQuant) {
        ksc_s[i] = a.ks[(size_t)blk * Hkv + it.h] * kLog2e;
        vsc_s[i] = a.vs[(size_t)blk * Hkv + it.h];
      }
    }
    if (tid < it.ntok) lim_tok[tid] = key_limit<kDecode>(a, it.st + tid);
    if constexpr (kMma) {
      if (wg) {
        // the 64-row Q tile, bf16(q * scale), K-major in the 128-byte
        // swizzle; rows past M zero.  int8 pages: q * scale stays f32,
        // as two bf16 terms hi + lo (two tiles)
        unsigned char* qt = smem + lay.qt;
        for (int ci = tid; ci < 64 * D / 8; ci += kWalkThreads) {
          const int r = ci / (D / 8), c = ci % (D / 8);
          uint4 hi = make_uint4(0u, 0u, 0u, 0u), lo = hi;
          if (r < it.M) {
            const int tok = it.st + r / G, head = it.h * G + r % G;
            hi = *reinterpret_cast<const uint4*>(
                q + ((size_t)tok * H + head) * D + 8 * c);
            bf16* e = reinterpret_cast<bf16*>(&hi);
            bf16* f = reinterpret_cast<bf16*>(&lo);
#pragma unroll
            for (int x = 0; x < 8; ++x) {
              const float v = __bfloat162float(e[x]) * a.scale;
              e[x] = __float2bfloat16_rn(v);
              f[x] = __float2bfloat16_rn(v - __bfloat162float(e[x]));
            }
          }
          const int off = (c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
          *reinterpret_cast<uint4*>(qt + off) = hi;
          if constexpr (L::kQuant)
            *reinterpret_cast<uint4*>(qt + 64 * D * 2 + off) = lo;
        }
        if (tid < 64)
          lim_row[tid] = tid < it.M ? key_limit<kDecode>(a, it.st + tid / G)
                                    : it.nkeys;
        fence_async_smem();
      }
    }
    if (!wg) {
      for (int e = tid; e < it.M * D; e += kWalkThreads) {
        const int m = e / D, d = e - m * D;
        const int tok = it.st + m / G, head = it.h * G + m % G;
        const float x = to_f(q[((size_t)tok * H + head) * D + d]) * a.scale;
        q_s[m * D + d] = L::kQuant ? x : round_to<T>(x);
      }
    }
    __syncthreads();
    if (tid == 0)
      for (int s = 0; s < min(L::kStages, it.nst); ++s)
        issue<L>(a, it, s, ring, bars, pg, &tk, &tv);
    if (tid == kWalkThreads - 32) misc[1] = atomicAdd(queue, 1);

    if (!wg) {
      // ---- CUDA cores: warp w takes keys w * kKPW .. of every stage for
      // all M rows, with its own online softmax (m, l, acc per row); lane
      // = (key l % kKPW, part l / kKPW of D), the parts' dot products
      // added by shuffles.  No block barrier inside the walk: the last
      // warp to release a stage refills it (a shared counter elects it).
      constexpr int kKPW = L::kKPW, kParts = 32 / kKPW;
      constexpr int kCPL = D / L::kV16 / kParts;    // K chunks a lane
      const int kl = lane % kKPW, part = lane / kKPW;
      const int jw = warp * kKPW + kl;              // this lane's key
      int* rel_cnt = misc + 16;
      float* pw = p_s + warp * kMaxG * kKPW;        // this warp's p
      const int d0 = lane * L::kCPT;
      const uint32_t col_off = (d0 % L::kV16) * L::kES;
      const int col_chunk = d0 / L::kV16;
      // the rows' count rounded up to 1, 2, 4 or 8 at compile time: every
      // row's chain is straight-line code the compiler can interleave (rows
      // past M see no key and are not stored)
      auto walk_rows = [&](auto mr) {
        constexpr int MR = decltype(mr)::value;
        float mw[MR], lw[MR], acc[MR][L::kCPT];
        int lim[MR];
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          mw[r] = -INFINITY;
          lw[r] = 0.f;
          lim[r] = r < it.M ? lim_tok[r / G] : 0;
#pragma unroll
          for (int c = 0; c < L::kCPT; ++c) acc[r][c] = 0.f;
        }
        for (int s = 0; s < it.nst; ++s) {
          const int slot = (run + s) % L::kStages;
          mbar_wait(bars + slot, ((run + s) / L::kStages) & 1);
          const unsigned char* kst = ring + slot * L::kStage;
          const unsigned char* vst = kst + L::kHalf;
          const int kb = it.k0 + s * L::kKT;
          const int nk = min(L::kKT, it.k1 - kb);
          const bool live = jw < nk;
          float kf[kCPL][L::kV16];
#pragma unroll
          for (int i = 0; i < kCPL; ++i) {
            const uint4 raw = *reinterpret_cast<const uint4*>(
                kst + chunk_off<L>(jw, part * kCPL + i));
            unpack(raw, kf[i]);
          }
          float mul = kLog2e, vmul = 1.f;
          if constexpr (L::kQuant) {
            const int pi = live ? (kb + jw) / a.bs - it.pg0 : 0;
            mul = ksc_s[pi];
            vmul = live ? vsc_s[pi] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            {
              const float* qrow = q_s + r * D + part * kCPL * L::kV16;
              float d = 0.f;
#pragma unroll
              for (int i = 0; i < kCPL; ++i)
#pragma unroll
                for (int x = 0; x < L::kV16 / 4; ++x) {
                  const float4 qv = *reinterpret_cast<const float4*>(
                      qrow + i * L::kV16 + 4 * x);
                  d = fmaf(qv.x, kf[i][4 * x], d);
                  d = fmaf(qv.y, kf[i][4 * x + 1], d);
                  d = fmaf(qv.z, kf[i][4 * x + 2], d);
                  d = fmaf(qv.w, kf[i][4 * x + 3], d);
                }
#pragma unroll
              for (int o = kKPW; o < 32; o <<= 1)
                d += __shfl_xor_sync(0xffffffffu, d, o);
              const float sc = live && kb + jw < lim[r] ? d * mul : -INFINITY;
              float mx = sc;
#pragma unroll
              for (int o = 1; o < kKPW; o <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
              const float m_new = fmaxf(mw[r], mx);
              const float mu = m_new == -INFINITY ? 0.f : m_new;
              const float alpha = ex2(mw[r] - mu);
              const float p = ex2(sc - mu);
              float sum = p;
#pragma unroll
              for (int o = 1; o < kKPW; o <<= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, o);
              lw[r] = alpha * lw[r] + sum;
              mw[r] = m_new;
#pragma unroll
              for (int c = 0; c < L::kCPT; ++c) acc[r][c] *= alpha;
              // p rounded to V's type (float pages) or times the page's
              // value scale (int8 pages)
              if (part == 0)
                pw[r * kKPW + kl] = L::kQuant ? p * vmul : round_to<T>(p);
            }
          }
          __syncwarp();
          const int jn = min(kKPW, nk - warp * kKPW);
          for (int x = 0; x < jn; ++x) {
            float vf[L::kCPT];
            load_cols<KV, L::kCPT>(
                vst + chunk_off<L>(warp * kKPW + x, col_chunk) + col_off, vf);
#pragma unroll
            for (int r = 0; r < MR; ++r) {
              {
                const float pr = pw[r * kKPW + x];
#pragma unroll
                for (int c = 0; c < L::kCPT; ++c)
                  acc[r][c] = fmaf(pr, vf[c], acc[r][c]);
              }
            }
          }
          // this warp is done with the stage; the eighth to say so refills
          // it with the stage kStages on
          __syncwarp();
          if (lane == 0) {
            __threadfence_block();
            if (atomicAdd(rel_cnt + slot, 1) % 8 == 7 &&
                s + L::kStages < it.nst)
              issue<L>(a, it, s + L::kStages, ring, bars, pg, &tk, &tv);
          }
        }
        // ---- the warps' (m, l, acc) merged in warp order; out, or the
        // split's partial and the merge by the last split
        if (lane == 0)
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            ml_s[(warp * kMaxG + r) * 2] = mw[r];
            ml_s[(warp * kMaxG + r) * 2 + 1] = lw[r];
          }
        __syncthreads();                  // the ring is free: it holds the sums
        float* red = reinterpret_cast<float*>(ring);
#pragma unroll
        for (int r = 0; r < MR; ++r)
          if (r < it.M)
#pragma unroll
            for (int c = 0; c < L::kCPT; ++c)
              red[(warp * kMaxG + r) * D + d0 + c] = acc[r][c];
      };
      if (it.M <= 1)
        walk_rows(std::integral_constant<int, 1>());
      else if (it.M <= 2)
        walk_rows(std::integral_constant<int, 2>());
      else if (it.M <= 4)
        walk_rows(std::integral_constant<int, 4>());
      else
        walk_rows(std::integral_constant<int, 8>());
      float* red = reinterpret_cast<float*>(ring);
      __syncthreads();
      // row r's (m, l) and column d's sum over the warps
      auto merged = [&](int r, int d, float* mo, float* lo) {
        float mx = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWalkThreads / 32; ++w)
          mx = fmaxf(mx, ml_s[(w * kMaxG + r) * 2]);
        float sum = 0.f, l = 0.f;
        if (mx != -INFINITY) {
#pragma unroll
          for (int w = 0; w < kWalkThreads / 32; ++w) {
            const float f = ex2(ml_s[(w * kMaxG + r) * 2] - mx);
            sum += red[(w * kMaxG + r) * D + d] * f;
            l += ml_s[(w * kMaxG + r) * 2 + 1] * f;
          }
        }
        *mo = mx;
        *lo = l;
        return sum;
      };
      if (it.ns == 1) {
        for (int e = tid; e < it.M * D; e += kWalkThreads) {
          const int r = e / D, d = e - r * D;
          float mx, l;
          const float sum = merged(r, d, &mx, &l);
          const int tok = it.st + r / G, head = it.h * G + r % G;
          out[((size_t)tok * H + head) * D + d] = from_f<T>(sum / l);
        }
      } else {
        const size_t stride = (size_t)kMaxG * (D + 2);
        float* base = a.part + ((size_t)it.k * Hkv + it.h) * a.nsplit * stride;
        float* mine = base + it.z * stride;
        for (int e = tid; e < it.M * D; e += kWalkThreads) {
          const int r = e / D, d = e - r * D;
          float mx, l;
          mine[r * (D + 2) + d] = merged(r, d, &mx, &l);
          if (d == 0) {
            mine[r * (D + 2) + D] = mx;
            mine[r * (D + 2) + D + 1] = l;
          }
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) {
          int* c = a.cnt + (size_t)it.k * Hkv + it.h;
          const int last = atomicAdd(c, 1) == it.ns - 1;
          if (last) atomicExch(c, 0);         // ready for the next launch
          misc[0] = last;
        }
        __syncthreads();
        if (misc[0]) {
          __threadfence();
          for (int e = tid; e < it.M * D; e += kWalkThreads) {
            const int r = e / D, d = e - r * D;
            float mx = -INFINITY;
            for (int z = 0; z < it.ns; ++z)
              mx = fmaxf(mx, __ldcg(base + z * stride + r * (D + 2) + D));
            float sum = 0.f, l = 0.f;
            for (int z = 0; z < it.ns; ++z) {
              const float* pz = base + z * stride + r * (D + 2);
              const float mz = __ldcg(pz + D);
              if (mz == -INFINITY) continue;      // the row saw no key here
              const float f = ex2(mz - mx);
              sum += __ldcg(pz + d) * f;
              l += __ldcg(pz + D + 1) * f;
            }
            const int tok = it.st + r / G, head = it.h * G + r % G;
            out[((size_t)tok * H + head) * D + d] = from_f<T>(sum / l);
          }
        }
      }
      __syncthreads();
      // the sums leave the ring as zeros: a wgmma tile's last stage may
      // multiply stale rows past its keys by p = 0
      for (int i = tid; i < kWalkThreads / 32 * kMaxG * D / 4; i += kWalkThreads)
        reinterpret_cast<float4*>(red)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      fence_async_smem();                 // the ring's next TMA writes
    } else if constexpr (kMma && !L::kQuant) {
      // ---- tensor cores: warpgroup 0 walks the 64-row tile
      if (uniform(warp) < 4) {
        const int r0 = 16 * warp + (lane >> 2), t = lane & 3;
        const int lim[2] = {lim_row[r0], lim_row[r0 + 8]};
        const uint64_t q_desc = sw128_desc(smem + lay.qt);
        const int nst = uniform(it.nst);
        float o[D / 2], mr[2] = {-INFINITY, -INFINITY}, lr[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
        for (int s = 0; s < nst; ++s) {
          const int slot = (run + s) % L::kStages;
          mbar_wait(bars + slot, ((run + s) / L::kStages) & 1);
          const unsigned char* st = ring + slot * L::kStage;
          float sc[32], alpha[2], sum[2];
          uint32_t pa[4][4];
          fwd_scores<D>(sc, q_desc, st);
          wgmma_wait<0>();
          keep(sc);
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int kp = s * 64 + 8 * (e >> 2) + 2 * t + (e & 1);
            if (kp >= lim[(e >> 1) & 1]) sc[e] = -INFINITY;
          }
          fwd_softmax(sc, mr, alpha, sum, kLog2e);
          fwd_fold<D>(o, lr, pa, sc, alpha, sum);
          wgmma_fence();
          fwd_pv<D>(o, pa, st + L::kHalf);
          wgmma_wait<0>();
          keep(o);
          keep_frags(pa);
          named_sync(1, 128);
          if (tid == 0 && s + L::kStages < nst)
            issue<L>(a, it, s + L::kStages, ring, bars, pg, &tk, &tv);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float lt = quad_sum(lr[i]);
          const int r = r0 + 8 * i;
          if (r < it.M) {
            const float inv = 1.f / lt;
            const int tok = it.st + r / G, head = it.h * G + r % G;
            bf16* p = reinterpret_cast<bf16*>(out) +
                      ((size_t)tok * H + head) * D + 2 * t;
#pragma unroll
            for (int jx = 0; jx < D / 8; ++jx)
              *reinterpret_cast<uint32_t*>(p + 8 * jx) =
                  pack_bf16(o[4 * jx + 2 * i] * inv,
                            o[4 * jx + 2 * i + 1] * inv);
          }
        }
      }
    } else if constexpr (kMma) {
      // ---- tensor cores, int8 pages: every thread turns the landed codes
      // into bf16 (exact) in cbuf with each key's scales beside them, the
      // ring stage goes back to the TMA at once, and warpgroup 0 runs two
      // 64-key tiles: S = (Q_hi + Q_lo) K^T, times the key's scale (log2
      // domain), the online softmax, then O += (P_hi + P_lo) V with p times
      // the key's value scale split into two bf16 terms.
      unsigned char* cb = smem + lay.cbuf;
      float* kscl = reinterpret_cast<float*>(smem + lay.kscl);
      float* vscl = kscl + L::kKT;
      constexpr int kSub = 64 * D * 2;               // a 64-key bf16 tile
      constexpr int kChunks = D / L::kV16;           // int8 chunks a key
      const bool wg0 = uniform(warp) < 4;
      const int r0 = 16 * (warp & 3) + (lane >> 2), t = lane & 3;
      const int lim[2] = {lim_row[r0], lim_row[r0 + 8]};
      const uint64_t qh_desc = sw128_desc(smem + lay.qt);
      const uint64_t ql_desc = sw128_desc(smem + lay.qt + 64 * D * 2);
      const int nst = uniform(it.nst);
      float o[D / 2], mr[2] = {-INFINITY, -INFINITY}, lr[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      for (int s = 0; s < nst; ++s) {
        const int slot = (run + s) % L::kStages;
        mbar_wait(bars + slot, ((run + s) / L::kStages) & 1);
        const unsigned char* st = ring + slot * L::kStage;
        const int kb = s * L::kKT;
        const int nk = min(L::kKT, it.k1 - kb);
        for (int i = tid; i < 2 * L::kKT * kChunks; i += kWalkThreads) {
          const int half = i / (L::kKT * kChunks);   // K, then V
          const int j = (i / kChunks) % L::kKT, c = i % kChunks;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              st + half * L::kHalf + chunk_off<L>(j, c));
          float f[16];
          unpack(raw, f);
          uint32_t w[8];
#pragma unroll
          for (int x = 0; x < 8; ++x)      // the codes are exact in bf16
            w[x] = (__float_as_uint(f[2 * x]) >> 16) |
                   (__float_as_uint(f[2 * x + 1]) & 0xffff0000u);
          const int r = j & 63, e0 = 16 * c;
          unsigned char* dst = cb + half * 2 * kSub + (j >> 6) * kSub +
                               (e0 >> 6) * 8192 + r * 128;
          const int cc = (e0 & 63) >> 3;
          *reinterpret_cast<uint4*>(dst + ((cc ^ (r & 7)) << 4)) =
              make_uint4(w[0], w[1], w[2], w[3]);
          *reinterpret_cast<uint4*>(dst + (((cc + 1) ^ (r & 7)) << 4)) =
              make_uint4(w[4], w[5], w[6], w[7]);
        }
        if (tid < L::kKT) {
          const bool live = tid < nk;
          const int pi = live ? (kb + tid) / a.bs - it.pg0 : 0;
          kscl[tid] = live ? ksc_s[pi] : 0.f;
          vscl[tid] = live ? vsc_s[pi] : 0.f;
        }
        fence_async_smem();
        __syncthreads();
        // the ring stage is converted: it takes the stage kStages on
        if (tid == 0 && s + L::kStages < nst)
          issue<L>(a, it, s + L::kStages, ring, bars, pg, &tk, &tv);
        if (wg0) {
          for (int sub = 0; sub < 2; ++sub) {
            if (uniform(sub * 64 < nk ? 1 : 0) == 0) break;
            const unsigned char* kt = cb + sub * kSub;
            const unsigned char* vt = cb + 2 * kSub + sub * kSub;
            float sc[32], alpha[2], sum[2];
            uint32_t ph[4][4], pl[4][4];
            const uint64_t k_desc = sw128_desc(kt);
            wgmma_fence();
            wgmma_ss_n64_first(sc, qh_desc, k_desc);
#pragma unroll
            for (int kk = 1; kk < D / 16; ++kk)
              wgmma_ss_n64(sc, qh_desc + (kmajor_step(kk) >> 4),
                           k_desc + (kmajor_step(kk) >> 4), 1);
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
              wgmma_ss_n64(sc, ql_desc + (kmajor_step(kk) >> 4),
                           k_desc + (kmajor_step(kk) >> 4), 1);
            wgmma_commit();
            wgmma_wait<0>();
            keep(sc);
#pragma unroll
            for (int e = 0; e < 32; ++e) {
              const int col = 8 * (e >> 2) + 2 * t + (e & 1);
              const int kp = kb + sub * 64 + col;
              sc[e] = kp < lim[(e >> 1) & 1] ? sc[e] * kscl[sub * 64 + col]
                                             : -INFINITY;
            }
            fwd_softmax(sc, mr, alpha, sum, 1.f);
#pragma unroll
            for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
#pragma unroll
            for (int r = 0; r < 2; ++r) lr[r] = alpha[r] * lr[r] + sum[r];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const int e = 8 * kk + 2 * x;
                const int col = 8 * (e >> 2) + 2 * t;
                const float p0 = sc[e] * vscl[sub * 64 + col];
                const float p1 = sc[e + 1] * vscl[sub * 64 + col + 1];
                const uint32_t h = pack_bf16(p0, p1);
                ph[kk][x] = h;
                pl[kk][x] = pack_bf16(p0 - __uint_as_float(h << 16),
                                      p1 - __uint_as_float(h & 0xffff0000u));
              }
            const uint64_t v_mn = sw128_desc_mn(vt, 8192);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs_nd<D>(o, ph[kk], v_mn + (nmajor_step(kk) >> 4));
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_rs_nd<D>(o, pl[kk], v_mn + (nmajor_step(kk) >> 4));
            wgmma_commit();
            wgmma_wait<0>();
            keep(o);
            keep_frags(ph);
            keep_frags(pl);
          }
        }
        __syncthreads();                  // cbuf is free for the next stage
      }
      if (wg0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float lt = quad_sum(lr[i]);
          const int r = r0 + 8 * i;
          if (r < it.M) {
            const float inv = 1.f / lt;
            const int tok = it.st + r / G, head = it.h * G + r % G;
            bf16* p = reinterpret_cast<bf16*>(out) +
                      ((size_t)tok * H + head) * D + 2 * t;
#pragma unroll
            for (int jx = 0; jx < D / 8; ++jx)
              *reinterpret_cast<uint32_t*>(p + 8 * jx) =
                  pack_bf16(o[4 * jx + 2 * i] * inv,
                            o[4 * jx + 2 * i + 1] * inv);
          }
        }
      }
    }
    run += it.nst;
    __syncthreads();
  }
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(queue + 1, 1) == (int)gridDim.x - 1) {
      atomicExch(queue, 0);
      atomicExch(queue + 1, 0);
    }
  }
}

// ---------------------------------------------------------------------------
// host side of the walk
// ---------------------------------------------------------------------------

template <typename KV>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<KV, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<KV, bf16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// rows of a TMA box: the largest power of two up to the stage's keys that
// divides bs (bs is a multiple of 8)
inline int box_rows(int bs, int kt) {
  int bh = kt;
  while (bs % bh) bh >>= 1;
  return bh;
}

// The caches' tensor maps, kept per host thread: a layer's caches never
// move, so a serving step finds each of its maps here and encodes none.
// The key is every argument of the encode, so a hit is the map an encode
// would give; a miss encodes into one of the 4 slots its pointer hashes to.
struct MapSlot {
  CUtensorMap map;
  const void* p;
  uint64_t rows;
  int dt, D, box_in, bh, sw;
};
constexpr int kMapSlots = 256;

bool cached_map(CUtensorMap* m, CUtensorMapDataType dt, const void* p, int D,
                uint64_t rows, int esz, int box_in, int bh,
                CUtensorMapSwizzle sw) {
  static thread_local MapSlot slots[kMapSlots];
  static thread_local unsigned victim = 0;
  const int h = (int)(((uintptr_t)p * 0x9E3779B97F4A7C15ull) >> 56) & ~3;
  for (int i = h; i < h + 4; ++i) {
    const MapSlot& e = slots[i];
    if (e.p == p && e.rows == rows && e.dt == (int)dt && e.D == D &&
        e.box_in == box_in && e.bh == bh && e.sw == (int)sw) {
      *m = e.map;
      return true;
    }
  }
  MapSlot& e = slots[h + (victim++ & 3)];
  e.p = nullptr;
  if (!tensor_map(&e.map, dt, p, D, rows, (uint64_t)D * esz, box_in, bh,
                  sw))
    return false;
  e.p = p;
  e.rows = rows;
  e.dt = (int)dt;
  e.D = D;
  e.box_in = box_in;
  e.bh = bh;
  e.sw = (int)sw;
  *m = e.map;
  return true;
}

template <typename T, typename KV, int D, bool kDecode>
int launch_walk(const void* kc, const void* vc, WalkArgs a,
                cudaStream_t stream) {
  using L = Walk<T, KV, D, kDecode>;
  if (a.TT < 1 || a.split < 1 || a.split % L::kKT || a.nsplit < 1 ||
      a.ntiles_max < 1)
    return (int)cudaErrorInvalidValue;
  a.G = a.H / a.Hkv;
  a.bh = box_rows(a.bs, L::kKT);
  a.maxpages = a.nblk + 1;
  // the two tensor maps: the cache as [num_blocks * H_kv * bs, D] rows
  CUtensorMap maps[2];
  const uint64_t rows = (uint64_t)a.num_blocks * a.Hkv * a.bs;
  const CUtensorMapSwizzle sw = L::kW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_64B;
  const void* caches[2] = {kc, vc};
  for (int i = 0; i < 2; ++i)
    if (!cached_map(&maps[i], tma_type<KV>(), caches[i], D, rows,
                    (int)sizeof(KV), L::kCBE, a.bh, sw))
      return (int)cudaErrorInvalidValue;
  const WalkLayout lay = walk_layout<L, D>(a.ntiles_max, a.maxpages);
  const size_t smem = (size_t)lay.bytes + 1024;
  auto kern = paged_walk_kernel<T, KV, D, kDecode>;
  static size_t smem_set = 0;           // per instantiation
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  // a persistent grid: as many blocks as the SMs hold at once
  static int sms = 0;
  static size_t occ_smem = 0;
  static int occ = 1;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (smem != occ_smem) {
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kWalkThreads,
                                                      smem) != cudaSuccess ||
        occ < 1)
      occ = 1;
    occ_smem = smem;
  }
  const long items = (long)a.ntiles_max * a.nsplit * a.Hkv;
  const long slots = (long)sms * occ;
  const int grid = (int)(items < slots ? items : slots);
  kern<<<grid, kWalkThreads, smem, stream>>>(maps[0], maps[1], a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Every other head dim and query group
//
// The walk keeps a tile's rows on one warp each (at most kMaxG = 8 rows a
// tile on the CUDA cores) and spreads D over 32 lanes, which holds for D in
// {64, 128} and G <= 8 only.  This kernel takes the rest of what the JAX
// rules (paged_attention.py supports / ragged_supports) take: D 64 or any
// multiple of 128, any G = H / H_kv.  Grid (Tq, H_kv, n_gc * n_dc): the
// query group is split into chunks of at most kMaxG heads and the output
// columns into chunks of kAnyThreads, one column a thread; every block walks
// its row's keys for its own pair of chunks.  It scores its query heads
// against the whole head dim, reading q and each key row straight from
// device memory (lane i takes elements i, i + 32, ...), keeps an online
// softmax, and accumulates its columns of p @ v.  So shared memory does not
// grow with D, and a block re-reads its pages once for each chunk pair:
// simple and right, not fast.  The rounding points are those of the kernel
// it stands in for: kQuant the int8-page kernel's (q * scale in f32, p
// unrounded), otherwise the float kernel's (q * scale and p rounded to T).
// kDecode as above.
// ---------------------------------------------------------------------------

constexpr int kAnyThreads = 128;
constexpr int kAnyWarps = kAnyThreads / 32;
constexpr int kTileKeys = 64;

__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T, typename KV, bool kQuant, bool kDecode>
__global__ void __launch_bounds__(kAnyThreads)
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
  const int col = (blockIdx.z - gc * n_dc) * kAnyThreads + threadIdx.x;
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
    for (int j = warp; j < nk; j += kAnyWarps) {
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
    for (int g = warp; g < Gc; g += kAnyWarps) {
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
  const int n_dc = (D + kAnyThreads - 1) / kAnyThreads;
  dim3 grid(Tq, Hkv, n_gc * n_dc);
  paged_attention_any_kernel<T, KV, kQuant, kDecode>
      <<<grid, kAnyThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(kc),
          static_cast<const KV*>(vc), static_cast<const float*>(ks),
          static_cast<const float*>(vs), static_cast<const int*>(bt),
          static_cast<const int*>(seg), static_cast<const int*>(rel),
          static_cast<T*>(out), H, Hkv, D, bs, num_blocks, R, nblk, n_dc,
          scale);
  return (int)cudaGetLastError();
}

// the walk where it applies, paged_attention_any_kernel elsewhere
bool specialised(int H, int Hkv, int D) {
  return (D == 64 || D == 128) && H / Hkv <= kMaxG;
}

// the walk at q type T, page type KV, over D
template <typename T, typename KV, bool kDecode>
int walk(int D, const void* kc, const void* vc, const WalkArgs& a,
         cudaStream_t s) {
  if (D == 64) return launch_walk<T, KV, 64, kDecode>(kc, vc, a, s);
  return launch_walk<T, KV, 128, kDecode>(kc, vc, a, s);
}

WalkArgs walk_args(const void* q, void* out, const void* bt, const void* seg,
                   const void* rel, const void* ks, const void* vs,
                   void* part, void* cnt, int Tq, int H, int Hkv, int bs,
                   int num_blocks, int R, int nblk, int TT, int split,
                   int nsplit, int ntiles_max, float scale) {
  WalkArgs a{};
  a.q = q;
  a.out = out;
  a.bt = static_cast<const int*>(bt);
  a.seg = static_cast<const int*>(seg);
  a.rel = static_cast<const int*>(rel);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.part = static_cast<float*>(part);
  a.cnt = static_cast<int*>(cnt);
  a.Tq = Tq;
  a.H = H;
  a.Hkv = Hkv;
  a.bs = bs;
  a.num_blocks = num_blocks;
  a.R = R;
  a.nblk = nblk;
  a.TT = TT;
  a.split = split;
  a.nsplit = nsplit;
  a.ntiles_max = ntiles_max;
  a.scale = scale;
  return a;
}

}  // namespace

// The three C entries, bound with ctypes.  dtype: 0 = float32, 1 =
// bfloat16 (q's and out's type).  Each returns cudaGetLastError() after its
// one launch (0 on success, or the error of encoding a tensor map or of
// raising the shared-memory limit); the caller checks it.  The wrapper
// (paddle_tpu_torch/ops/paged_attention.py) has checked shapes, types and
// contiguity (D 64 or a multiple of 128, H % Hkv == 0, bs % 8 == 0) and
// computed the walk's plan (_walk_plan): tokens a tile TT, keys a split,
// splits at most nsplit, tiles at most ntiles_max, with part the f32 split
// scratch [ntiles_max, H_kv, nsplit, 8, D + 2] (unused when nsplit is 1)
// and cnt [ntiles_max * H_kv + 2] int32 counters that are zero between
// calls (each launch leaves them so), both the stream's own: two launches
// running at once must not share them.  D in {64, 128} with H / Hkv
// <= 8 takes the walk, every other shape paged_attention_any_kernel (which
// ignores the plan).

// Float pages: ragged_paged_attention_segrel_packed.  seg must be
// non-decreasing (the walk writes NaN everywhere where it falls).
extern "C" int paddle_ragged_paged_attention(
    const void* q, const void* kc, const void* vc, const void* bt,
    const void* seg, const void* rel, void* out, void* part, void* cnt,
    int Tq, int H, int Hkv, int D, int bs, int num_blocks, int R, int nblk,
    int TT, int split, int nsplit, int ntiles_max, int dtype, float scale,
    void* stream) {
  if (Tq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!specialised(H, Hkv, D)) {
    if (dtype == 0)
      return launch_any<float, float, false, false>(
          q, kc, vc, nullptr, nullptr, bt, seg, rel, out, Tq, H, Hkv, D, bs,
          num_blocks, R, nblk, scale, s);
    if (dtype == 1)
      return launch_any<bf16, bf16, false, false>(
          q, kc, vc, nullptr, nullptr, bt, seg, rel, out, Tq, H, Hkv, D, bs,
          num_blocks, R, nblk, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  const WalkArgs a = walk_args(q, out, bt, seg, rel, nullptr, nullptr, part,
                               cnt, Tq, H, Hkv, bs, num_blocks, R, nblk, TT,
                               split, nsplit, ntiles_max, scale);
  if (dtype == 0) return walk<float, float, false>(D, kc, vc, a, s);
  if (dtype == 1) return walk<bf16, bf16, false>(D, kc, vc, a, s);
  return (int)cudaErrorInvalidValue;
}

// int8 pages: ragged_paged_attention_quant_segrel_packed.  As the float
// entry, plus the f32 scale pools ks/vs [num_blocks, H_kv]; kc/vc are int8.
extern "C" int paddle_ragged_paged_attention_q8(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* bt, const void* seg, const void* rel,
    void* out, void* part, void* cnt, int Tq, int H, int Hkv, int D, int bs,
    int num_blocks, int R, int nblk, int TT, int split, int nsplit,
    int ntiles_max, int dtype, float scale, void* stream) {
  if (Tq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!specialised(H, Hkv, D)) {
    if (dtype == 0)
      return launch_any<float, int8_t, true, false>(
          q, kc, vc, ks, vs, bt, seg, rel, out, Tq, H, Hkv, D, bs,
          num_blocks, R, nblk, scale, s);
    if (dtype == 1)
      return launch_any<bf16, int8_t, true, false>(
          q, kc, vc, ks, vs, bt, seg, rel, out, Tq, H, Hkv, D, bs,
          num_blocks, R, nblk, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  const WalkArgs a = walk_args(q, out, bt, seg, rel, ks, vs, part, cnt, Tq,
                               H, Hkv, bs, num_blocks, R, nblk, TT, split,
                               nsplit, ntiles_max, scale);
  if (dtype == 0) return walk<float, int8_t, false>(D, kc, vc, a, s);
  if (dtype == 1) return walk<bf16, int8_t, false>(D, kc, vc, a, s);
  return (int)cudaErrorInvalidValue;
}

// Paged decode: paged_decode_attention_packed.  q and out are [B, H, D]; bt
// is [B, nblk] int32 (entries clamped into range in the kernel); lens is
// [B] int32, the valid positions of each row (>= 1).  The plan has TT 1 and
// ntiles_max B.
extern "C" int paddle_paged_decode_attention(
    const void* q, const void* kc, const void* vc, const void* bt,
    const void* lens, void* out, void* part, void* cnt, int B, int H,
    int Hkv, int D, int bs, int num_blocks, int nblk, int split, int nsplit,
    int dtype, float scale, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!specialised(H, Hkv, D)) {
    if (dtype == 0)
      return launch_any<float, float, false, true>(
          q, kc, vc, nullptr, nullptr, bt, nullptr, lens, out, B, H, Hkv, D,
          bs, num_blocks, B, nblk, scale, s);
    if (dtype == 1)
      return launch_any<bf16, bf16, false, true>(
          q, kc, vc, nullptr, nullptr, bt, nullptr, lens, out, B, H, Hkv, D,
          bs, num_blocks, B, nblk, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  const WalkArgs a = walk_args(q, out, bt, nullptr, lens, nullptr, nullptr,
                               part, cnt, B, H, Hkv, bs, num_blocks, B, nblk,
                               1, split, nsplit, B, scale);
  if (dtype == 0) return walk<float, float, true>(D, kc, vc, a, s);
  if (dtype == 1) return walk<bf16, bf16, true>(D, kc, vc, a, s);
  return (int)cudaErrorInvalidValue;
}
