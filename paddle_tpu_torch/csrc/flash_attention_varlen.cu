// Varlen (unpadded) flash attention for Hopper (sm_90a), written by hand:
// the forward kernel and the two backward kernels (dK/dV, dQ) over packed
// sequences.
//
// Replaces paddle_tpu/ops/pallas/flash_attention_varlen.py :: _vfwd_kernel,
// _vbwd_dkdv_kernel and _vbwd_dq_kernel (launched by _varlen_fwd and
// _varlen_bwd).  Sequences are concatenated along the token axis: q, dout,
// out and dq are [Tq, H, D]; k, v, dk and dv [Tk, H, D], row-major, read in
// place (a tile of rows of one head is strided runs of D elements).  Every
// token carries (segment, position in segment): seg_q/rel_q [pad_q] and
// seg_k/rel_k [pad_k] int32, padded past T with sentinel segments that
// match nothing.  Query i sees key j when seg_q[i] == seg_k[j] (and, under
// causal, rel_q[i] >= rel_k[j]); a tile may straddle several sequences, and
// cu_q != cu_k (cross attention, Tq != Tk) needs nothing else.  lse and
// delta are [H, Tq] float32.
//
// What keeps the work O(sum s_i^2) and not O(T^2): per-block tile ranges
// [lo, hi), computed by the wrapper from the offsets (the TPU kernels'
// scalar-prefetched bounds).  The forward and dQ own query rows (64 a
// block on the CUDA cores, 128 in the wgmma kernels) and walk the key
// tiles lo..hi of their block; dK/dV owns keys (64, 128 in the wgmma
// kernel) and walks query tiles.  Rows past T are read as zeros and never
// written.
//
// Rounding points, as in the varlen TPU kernels (not the fixed-length
// ones): the scale multiplies the f32 score (q is not pre-scaled); p is
// rounded to the input type before the PV product while the row sum l
// takes the unrounded p; dS = p * (dP - delta) * scale is rounded to it
// for dK and dQ (after the scale, k unscaled); p is rounded for dV.  A
// query row with no key gets output 0 and lse = -inf, and the backward
// reads such an lse as 0 (its masked p is 0 anyway).  No atomics in any
// sum: dK/dV sums its query tiles in a fixed order, so reruns are
// bit-identical.
//
// Two families of kernels.  float inputs (every D) and bfloat16 at D =
// 256 take CUDA-core kernels: operands widened to f32 in shared memory,
// IEEE f32 FMAs (never TF32), walked tiles of 64 rows (32 at D = 256,
// where four 64-row f32 tiles would not fit the 227 KB of shared memory).
// bfloat16 at D in {64, 128} takes wgmma fed by TMA, warp-specialised: the
// forward attention_common.cuh's walk (shared with the fixed-length
// forward), dK/dV and dQ the walks below; p and dS pass from the score
// accumulators to the next product's register A operands (the rounding
// points are exactly the wgmma operand type).
//
// What bounds them: operations.  LLaMA-7B's attention over 8 packed causal
// sequences (8,192 tokens, H 32, D 128) does 2 * 2 * D * H * sum s(s+1)/2
// = 87.5 GFLOP forward on 67 MB, twice that in dK/dV (four products) and
// 1.5 times in dQ (three).  The bf16 kernels keep the next tiles' copies
// in flight behind their products, overlap one tile's exponentials with
// another's products and mask only the tiles that need it; PERF.md has
// their rates.

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

// may query (seg_q, rel_q) see key (seg_k, rel_k)?
__device__ __forceinline__ bool visible(int sq, int rq, int sk, int rk,
                                        int causal) {
  return sq == sk && (!causal || rq >= rk);
}

// ---------------------------------------------------------------------------
// CUDA-core kernels (float, and bfloat16 at D = 256)
//
// attention_common.cuh's f32 layout: operands widened to f32 in shared
// memory (row stride D + 1), 4 x N/16 micro-tiles a thread.
// ---------------------------------------------------------------------------

// Segment ids and positions of n rows from `first` into shared memory.
__device__ __forceinline__ void load_meta(int* __restrict__ seg_s,
                                          int* __restrict__ rel_s,
                                          const int* __restrict__ seg,
                                          const int* __restrict__ rel,
                                          int first, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    seg_s[i] = seg[first + i];
    rel_s[i] = rel[first + i];
  }
}

// Forward.  One block per (64-query tile, head); the query tile stays in
// shared memory while the block walks key tiles lo[qt] .. hi[qt] (NB keys
// each) with an online softmax whose running max m, sum l and accumulator
// stay in f32 registers.
template <typename T, int D, int NB>
__global__ void __launch_bounds__(kThreads)
varlen_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ seg_q,
                  const int* __restrict__ rel_q,
                  const int* __restrict__ seg_k,
                  const int* __restrict__ rel_k, const int* __restrict__ lo,
                  const int* __restrict__ hi, T* __restrict__ out,
                  float* __restrict__ lse, int Tq, int Tk, int H, int causal,
                  float scale) {
  constexpr int kS = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [64, D]
  float* k_s = q_s + kTile * kS;      // [NB, D]
  float* v_s = k_s + NB * kS;         // [NB, D]
  float* p_s = v_s + NB * kS;         // [64, NB]
  int* sk_s = reinterpret_cast<int*>(p_s + kTile * (NB + 1));  // [NB]
  int* rk_s = sk_s + NB;                                       // [NB]

  const int qt = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;
  const int q_rows = min(kTile, Tq - q0);
  const size_t ld = (size_t)H * D;
  load_tile<T, D, kTile>(q_s, q + (size_t)q0 * ld + (size_t)h * D, ld,
                         q_rows);
  int sq[4], rq[4];
  float acc[4][D / 16], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sq[i] = seg_q[q0 + ty + 16 * i];
    rq[i] = rel_q[q0 + ty + 16 * i];
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  for (int kt = lo[qt]; kt < hi[qt]; ++kt) {
    const int k0 = kt * NB;
    __syncthreads();                  // the previous tile's PV is done
    load_tile<T, D, NB>(k_s, k + (size_t)k0 * ld + (size_t)h * D, ld,
                        Tk - k0);
    load_tile<T, D, NB>(v_s, v + (size_t)k0 * ld + (size_t)h * D, ld,
                        Tk - k0);
    load_meta(sk_s, rk_s, seg_k, rel_k, k0, NB);
    __syncthreads();

    float s[4][NB / 16];
    mm_abt<D, NB>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) {
        const int kc = tx + 16 * j;
        s[i][j] = visible(sq[i], rq[i], sk_s[kc], rk_s[kc], causal)
                      ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) {
        const float p = expf(s[i][j] - m_safe);
        sum += p;
        p_s[(ty + 16 * i) * (NB + 1) + tx + 16 * j] = round_to<T>(p);
      }
      const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mm_ab<D, NB>(acc, p_s, v_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < q_rows) {
      const bool has = l[i] > 0.f;
      T* dst = out + (size_t)(q0 + r) * ld + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        dst[tx + 16 * j] = from_f<T>(has ? acc[i][j] / l[i] : 0.f);
      if (tx == 0)
        lse[(size_t)h * Tq + q0 + r] = has ? m[i] + logf(l[i]) : -INFINITY;
    }
  }
}

// dK / dV.  One block per (64-key tile, head); the key and value tiles
// stay in shared memory while the block walks query tiles lo[kt] ..
// hi[kt] (NQ queries each), accumulating dK and dV in f32 registers.
template <typename T, int D, int NQ>
__global__ void __launch_bounds__(kThreads)
varlen_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ seg_q,
                       const int* __restrict__ rel_q,
                       const int* __restrict__ seg_k,
                       const int* __restrict__ rel_k,
                       const int* __restrict__ lo, const int* __restrict__ hi,
                       T* __restrict__ dk, T* __restrict__ dv, int Tq, int Tk,
                       int H, int causal, float scale) {
  constexpr int kS = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                      // [64 keys, D]
  float* v_s = k_s + kTile * kS;          // [64 keys, D]
  float* q_s = v_s + kTile * kS;          // [NQ queries, D]
  float* do_s = q_s + NQ * kS;            // [NQ queries, D]
  float* pt_s = do_s + NQ * kS;           // [64 keys, NQ queries]: p
  float* dst_s = pt_s + kTile * (NQ + 1); // dS
  float* lse_s = dst_s + kTile * (NQ + 1);  // [NQ]
  float* delta_s = lse_s + NQ;              // [NQ]
  int* sq_s = reinterpret_cast<int*>(delta_s + NQ);  // [NQ]
  int* rq_s = sq_s + NQ;                             // [NQ]

  const int kt = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kTile;
  const int k_rows = min(kTile, Tk - k0);
  const size_t ld = (size_t)H * D;
  load_tile<T, D, kTile>(k_s, k + (size_t)k0 * ld + (size_t)h * D, ld,
                         k_rows);
  load_tile<T, D, kTile>(v_s, v + (size_t)k0 * ld + (size_t)h * D, ld,
                         k_rows);
  int sk[4], rk[4];
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sk[i] = seg_k[k0 + ty + 16 * i];
    rk[i] = rel_k[k0 + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  for (int qt = lo[kt]; qt < hi[kt]; ++qt) {
    const int q0 = qt * NQ;
    const int q_rows = Tq - q0;
    __syncthreads();                  // the previous tile's products are done
    const size_t off = (size_t)q0 * ld + (size_t)h * D;
    load_tile<T, D, NQ>(q_s, q + off, ld, q_rows);
    load_tile<T, D, NQ>(do_s, dout + off, ld, q_rows);
    if (tid < NQ) {
      const bool ok = tid < q_rows;   // rows past Tq: p = exp(s - inf) = 0
      const float x = ok ? lse[(size_t)h * Tq + q0 + tid] : INFINITY;
      lse_s[tid] = ok && !isfinite(x) ? 0.f : x;
      delta_s[tid] = ok ? delta[(size_t)h * Tq + q0 + tid] : 0.f;
      sq_s[tid] = seg_q[q0 + tid];
      rq_s[tid] = rel_q[q0 + tid];
    }
    __syncthreads();

    float st[4][NQ / 16], dpt[4][NQ / 16];
    mm_abt<D, NQ>(st, k_s, q_s, ty, tx);    // [keys, queries]
    mm_abt<D, NQ>(dpt, v_s, do_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NQ / 16; ++j) {
        const int qc = tx + 16 * j;
        const float s = visible(sq_s[qc], rq_s[qc], sk[i], rk[i], causal)
                            ? st[i][j] * scale : -INFINITY;
        const float p = expf(s - lse_s[qc]);
        const float ds = p * (dpt[i][j] - delta_s[qc]) * scale;
        pt_s[(ty + 16 * i) * (NQ + 1) + qc] = round_to<T>(p);
        dst_s[(ty + 16 * i) * (NQ + 1) + qc] = round_to<T>(ds);
      }
    __syncthreads();
    mm_ab<D, NQ>(dv_acc, pt_s, do_s, ty, tx);
    mm_ab<D, NQ>(dk_acc, dst_s, q_s, ty, tx);
  }

  const size_t off = (size_t)k0 * ld + (size_t)h * D;
  store_tile<T, D>(dk + off, ld, k_rows, dk_acc, ty, tx);
  store_tile<T, D>(dv + off, ld, k_rows, dv_acc, ty, tx);
}

// dQ.  One block per (64-query tile, head); the query and dout tiles stay
// in shared memory while the block walks key tiles lo[qt] .. hi[qt].
template <typename T, int D, int NK>
__global__ void __launch_bounds__(kThreads)
varlen_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ seg_q,
                     const int* __restrict__ rel_q,
                     const int* __restrict__ seg_k,
                     const int* __restrict__ rel_k,
                     const int* __restrict__ lo, const int* __restrict__ hi,
                     T* __restrict__ dq, int Tq, int Tk, int H, int causal,
                     float scale) {
  constexpr int kS = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // [64 queries, D]
  float* do_s = q_s + kTile * kS;     // [64 queries, D]
  float* k_s = do_s + kTile * kS;     // [NK keys, D]
  float* v_s = k_s + NK * kS;         // [NK keys, D]
  float* ds_s = v_s + NK * kS;        // [64 queries, NK keys]: dS
  int* sk_s = reinterpret_cast<int*>(ds_s + kTile * (NK + 1));  // [NK]
  int* rk_s = sk_s + NK;                                        // [NK]

  const int qt = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;
  const int q_rows = min(kTile, Tq - q0);
  const size_t ld = (size_t)H * D;
  const size_t q_off = (size_t)q0 * ld + (size_t)h * D;
  load_tile<T, D, kTile>(q_s, q + q_off, ld, q_rows);
  load_tile<T, D, kTile>(do_s, dout + q_off, ld, q_rows);
  int sq[4], rq[4];
  float lse_r[4], delta_r[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;        // rows past Tq: finite, never written
    sq[i] = seg_q[q0 + r];
    rq[i] = rel_q[q0 + r];
    const float x = r < q_rows ? lse[(size_t)h * Tq + q0 + r] : 0.f;
    lse_r[i] = isfinite(x) ? x : 0.f;
    delta_r[i] = r < q_rows ? delta[(size_t)h * Tq + q0 + r] : 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  for (int kt = lo[qt]; kt < hi[qt]; ++kt) {
    const int k0 = kt * NK;
    __syncthreads();                  // the previous tile's dQ product is done
    load_tile<T, D, NK>(k_s, k + (size_t)k0 * ld + (size_t)h * D, ld,
                        Tk - k0);
    load_tile<T, D, NK>(v_s, v + (size_t)k0 * ld + (size_t)h * D, ld,
                        Tk - k0);
    load_meta(sk_s, rk_s, seg_k, rel_k, k0, NK);
    __syncthreads();

    float s[4][NK / 16], dp[4][NK / 16];
    mm_abt<D, NK>(s, q_s, k_s, ty, tx);     // [queries, keys]
    mm_abt<D, NK>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NK / 16; ++j) {
        const int kc = tx + 16 * j;
        const float sv = visible(sq[i], rq[i], sk_s[kc], rk_s[kc], causal)
                             ? s[i][j] * scale : -INFINITY;
        const float p = expf(sv - lse_r[i]);
        ds_s[(ty + 16 * i) * (NK + 1) + kc] =
            round_to<T>(p * (dp[i][j] - delta_r[i]) * scale);
      }
    __syncthreads();
    mm_ab<D, NK>(acc, ds_s, k_s, ty, tx);
  }

  store_tile<T, D>(dq + q_off, ld, q_rows, acc, ty, tx);
}

// ---------------------------------------------------------------------------
// bfloat16 forward on Hopper (D in {64, 128})
// ---------------------------------------------------------------------------

// Forward.  attention_common.cuh's fwd_walk: one block per (head, 128
// queries), launched in the order the wrapper gives (the blocks with the
// most key tiles first).  Warpgroup w walks the key tiles lo[2 qb + w] ..
// hi[2 qb + w] of its 64 rows, the producer the union of the two ranges;
// with each key tile it copies the keys' segment ids and positions into
// the stage.  A tile whose keys and rows all lie in one segment (and,
// causal, whose first row comes at or after its last key) takes every
// score; the others are masked element by element.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
varlen_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const int* __restrict__ seg_q,
                        const int* __restrict__ rel_q,
                        const int* __restrict__ seg_k,
                        const int* __restrict__ rel_k,
                        const int* __restrict__ lo,
                        const int* __restrict__ hi, bf16* __restrict__ out,
                        float* __restrict__ lse, int Tq, int H, int causal,
                        float scale) {
  using L = FwdSmem<D, 1024>;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  unsigned char* ring = smem + L::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBytes);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;

  const int h = blockIdx.x;
  const int qb = uniform(lo[2 * gridDim.y + blockIdx.y]);   // launch order
  const int q0 = qb * 128;
  const int wg = uniform(threadIdx.x >> 7);
  // the warpgroups' ranges (an empty one adds nothing to the block's)
  const int l0 = uniform(lo[2 * qb]), h0 = uniform(hi[2 * qb]);
  const int l1 = uniform(lo[2 * qb + 1]), h1 = uniform(hi[2 * qb + 1]);
  const bool n0 = h0 > l0, n1 = h1 > l1;
  const int t0 = n0 ? (n1 ? min(l0, l1) : l0) : (n1 ? l1 : 0);
  const int t1 = n0 ? (n1 ? max(h0, h1) : h0) : (n1 ? h1 : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);            // both consumers
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    mbar_expect(q_full, 2 * L::kTile);
    tma_tile<D>(smem, &tq, h * D, q0, 0, q_full);
    tma_tile<D>(smem + L::kTile, &tq, h * D, q0 + 64, 0, q_full);
    for (int kt = t0; kt < t1; ++kt) {
      const int i = kt - t0, s = i % L::kStages;
      mbar_wait(empty + s, ((i / L::kStages) & 1) ^ 1);
      unsigned char* st = ring + s * L::kStage;
      mbar_expect(full + s, 2 * L::kTile + 512);
      tma_tile<D>(st, &tk, h * D, kt * 64, 0, full + s);
      tma_tile<D>(st + L::kTile, &tv, h * D, kt * 64, 0, full + s);
      bulk_copy(st + 2 * L::kTile, seg_k + kt * 64, 256, full + s);
      bulk_copy(st + 2 * L::kTile + 256, rel_k + kt * 64, 256, full + s);
    }
    return;
  }

  // ---- consumers ----
  regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, t = lane & 3;
  const int qw = q0 + 64 * wg;                  // this warpgroup's rows
  const int r0 = qw + 16 * (tid >> 5) + (lane >> 2);   // and r0 + 8
  // this thread's rows' (segment, position), and the warpgroup's first and
  // last row's (the metadata is padded past Tq to whole 128-row blocks)
  int sq[2], rq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sq[i] = seg_q[r0 + 8 * i];
    rq[i] = rel_q[r0 + 8 * i];
  }
  const int s_first = uniform(seg_q[qw]), s_last = uniform(seg_q[qw + 63]);
  const int r_first = uniform(rel_q[qw]);
  mbar_wait(q_full, 0);
  auto masked = [&](int, const unsigned char* st) {
    const int* mk = reinterpret_cast<const int*>(st + 2 * L::kTile);
    const int k_first = uniform(mk[0]), k_last = uniform(mk[63]);
    const bool one = k_first == k_last && s_first == s_last &&
                     k_first == s_first;
    return !(one && (!causal || r_first >= uniform(mk[127])));
  };
  auto sees = [&](int, const unsigned char* st, int col, int i) {
    const int* mk = reinterpret_cast<const int*>(st + 2 * L::kTile);
    return visible(sq[i], rq[i], mk[col], mk[64 + col], causal);
  };
  float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  fwd_walk<D, L>(ring, full, empty, t0, t1, wg ? l1 : l0, wg ? h1 : h0,
                 sw128_desc(smem + wg * L::kTile), scale * kLog2e, t, masked,
                 sees, o, m, l);
  fwd_store<D>(out + (size_t)h * D, (size_t)H * D, lse + (size_t)h * Tq, r0,
               Tq, o, m, l, t);
}

// ---------------------------------------------------------------------------
// bfloat16 backward on Hopper (D in {64, 128})
//
// Both kernels own 128 rows of one head a block (queries in dQ, keys in
// dK/dV) and are two warpgroups, warpgroup w owning the 64 rows r0 + 64 w
// .. and walking its own range of 64-row tiles of the other side, fed by
// an mbarrier ring of the union of the two ranges: TMA boxes (rows past T
// read zeros) and, beside each, the other side's segment metadata (bulk
// copies).  There is no producer warp: a ninth warp would cap every thread
// at 168 registers (each of the SM's four register quadrants holds 16K, so
// three warps share one), and the dK and dV accumulators alone take 128 at
// D 128; with eight warps ptxas may give each thread 255.  Thread 0 fills
// the first stages, and the last of the block's eight warps to release a
// stage refills it at once with the tile kStages on (a counter in shared
// memory, added to by each warp's lane 0, elects it: the kernels' one
// atomic, which orders no sum).  Blocks launch in the wrapper's order (lo
// after the tile ranges: the blocks with the most tiles first).
//
// Per tile: the two score products on wgmma from shared memory (K-major),
// p = 2^(s scale log2 e - lse log2 e) and dS = p (dP - delta) scale in f32,
// both rounded to bf16 into register A operands, then the gradient
// products with the other operand read N-major from its box (no transposed
// copy).  The next tile's score products are issued before this tile's
// gradient products and waited for first, so the exponentials run while
// the gradient products are in flight.  A tile whose rows and columns all
// lie in one segment (and, causal, on the visible side of the diagonal)
// takes every score; only the others test segment and position per
// element.  The walks are peeled so that every wgmma sits on a straight
// path under warp-uniform bounds (uniform()); a warpgroup waits for and
// releases every stage of the block's range, computing only its own tiles,
// and holds at most the stage before the one it waits for.
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;          // two consumer warpgroups

// A warp is done with ring tile i of n (slot i % stages): its lane 0
// counts it in, and the block's eighth warp to do so refills the slot with
// tile i + stages through `fill` (each use of a slot adds 8)
template <class Fill>
__device__ __forceinline__ void ring_release(int* cnt, int i, int n,
                                             int stages, Fill fill) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    __threadfence_block();                  // this warp's reads are done
    if (atomicAdd(cnt + i % stages, 1) % 8 == 7 && i + stages < n)
      fill(i + stages);
  }
  __syncwarp();
}

// dQ (replaces _vbwd_dq_kernel).  One block per (head, 128 queries),
// whose Q and dO tiles land once; a ring stage is one 64-key tile of K and
// V and its keys' segment ids and positions.  S = Q K^T and dP = dO V^T
// (K-major), dQ += dS K with K read N-major.
template <int D>
struct VdqSmem {
  static constexpr int kStages = D == 64 ? 6 : 4;
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kStage = 2 * kTile + 1024;   // K, V, seg/rel of keys
  static constexpr int kRing = 4 * kTile;           // Q, dO x 2
  static constexpr int kBytes = kRing + kStages * kStage;
  static constexpr size_t kDynamic = kBytes + 8 * (2 * kStages + 1) + 1024;
};

// What a dQ warpgroup's steps read besides its registers: the ring and
// what fills it, its rows' lse (times log2 e; 0 where not finite) and
// delta, segment ids and positions, and its first and last row's.
struct VdqCtx {
  unsigned char* ring;
  uint64_t* full;
  int* cnt;
  const CUtensorMap *tk, *tv;
  const int *seg_k, *rel_k;
  uint64_t q_desc, do_desc;
  float s_mul, scale, lse2[2], dl[2];
  int sq[2], rq[2], s_first, s_last, r_first, causal, t, t0, n, h;
};

// ring tile i (key tile t0 + i) into its stage
template <int D>
__device__ __forceinline__ void vdq_fill(const VdqCtx& c, int i) {
  using L = VdqSmem<D>;
  const int s = i % L::kStages, kt = c.t0 + i;
  unsigned char* st = c.ring + s * L::kStage;
  mbar_expect(c.full + s, 2 * L::kTile + 512);
  tma_tile<D>(st, c.tk, c.h * D, kt * 64, 0, c.full + s);
  tma_tile<D>(st + L::kTile, c.tv, c.h * D, kt * 64, 0, c.full + s);
  bulk_copy(st + 2 * L::kTile, c.seg_k + kt * 64, 256, c.full + s);
  bulk_copy(st + 2 * L::kTile + 256, c.rel_k + kt * 64, 256, c.full + s);
}

// S = Q K^T and dP = dO V^T over the landed key tile `st`, committed
template <int D>
__device__ __forceinline__ void vdq_scores(const VdqCtx& c,
                                           const unsigned char* st,
                                           float (&sa)[32], float (&dpa)[32]) {
  const uint64_t k_desc = sw128_desc(st);
  const uint64_t v_desc = sw128_desc(st + VdqSmem<D>::kTile);
  wgmma_fence();
  wgmma_ss_n64_first(sa, c.q_desc, k_desc);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss_n64(sa, c.q_desc + (kmajor_step(kk) >> 4),
                 k_desc + (kmajor_step(kk) >> 4), 1);
  wgmma_ss_n64_first(dpa, c.do_desc, v_desc);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss_n64(dpa, c.do_desc + (kmajor_step(kk) >> 4),
                 v_desc + (kmajor_step(kk) >> 4), 1);
  wgmma_commit();
}

// dS of the landed tile into dpa (f32), from the scores in sa; column
// 8 j + 2 t + (e & 1) of element 4 j + e is the tile's key, e >> 1 the
// thread's row r or r + 8
template <int D>
__device__ __forceinline__ void vdq_ds(const VdqCtx& c,
                                       const unsigned char* st,
                                       float (&sa)[32], float (&dpa)[32]) {
  const int* mk = reinterpret_cast<const int*>(st + 2 * VdqSmem<D>::kTile);
  const int k_first = uniform(mk[0]), k_last = uniform(mk[63]);
  const bool one = k_first == k_last && c.s_first == c.s_last &&
                   k_first == c.s_first &&
                   (!c.causal || c.r_first >= uniform(mk[127]));
  if (!one) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = 8 * (e >> 2) + 2 * c.t + (e & 1), i = (e >> 1) & 1;
      if (!visible(c.sq[i], c.rq[i], mk[col], mk[64 + col], c.causal))
        sa[e] = -INFINITY;
    }
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int i = (e >> 1) & 1;
    const float p = ex2(fmaf(sa[e], c.s_mul, -c.lse2[i]));
    dpa[e] = p * (dpa[e] - c.dl[i]) * c.scale;
  }
}

// dQ += dS K over the key tile `st` (K N-major), committed
template <int D>
__device__ __forceinline__ void vdq_product(float (&acc)[D / 2],
                                            const uint32_t (&da)[4][4],
                                            const unsigned char* st) {
  const uint64_t k_mn = sw128_desc_mn(st, 8192);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_nd<D>(acc, da[kk], k_mn + (nmajor_step(kk) >> 4));
  wgmma_commit();
}

// One warpgroup's walk over the ring tiles [c.t0, c.t0 + c.n), computing
// the key tiles [a0, a1) (a1 <= a0: none); bounds warp-uniform
template <int D>
__device__ __forceinline__ void vdq_walk(const VdqCtx& c, int a0, int a1,
                                         float (&acc)[D / 2]) {
  using L = VdqSmem<D>;
  const int t1 = c.t0 + c.n;
  if (a1 <= a0) a0 = a1 = t1;
  auto landed = [&](int kt) {
    const int i = kt - c.t0;
    mbar_wait(c.full + i % L::kStages, (i / L::kStages) & 1);
    return c.ring + (i % L::kStages) * L::kStage;
  };
  auto release = [&](int kt) {
    ring_release(c.cnt, kt - c.t0, c.n, L::kStages,
                 [&](int i) { vdq_fill<D>(c, i); });
  };
  for (int kt = c.t0; kt < a0; ++kt) {
    landed(kt);
    release(kt);
  }
  if (a0 < a1) {
    float sa[32], dpa[32];
    uint32_t da[4][4];
    const unsigned char* st = landed(a0);
    vdq_scores<D>(c, st, sa, dpa);
    wgmma_wait<0>();
    keep(sa);
    keep(dpa);
    vdq_ds<D>(c, st, sa, dpa);
    acc_to_a(da, dpa);                       // dS rounded to bf16
    const unsigned char* prev = st;
    for (int kt = a0 + 1; kt < a1; ++kt) {
      st = landed(kt);
      vdq_scores<D>(c, st, sa, dpa);
      vdq_product<D>(acc, da, prev);
      wgmma_wait<1>();
      keep(sa);
      keep(dpa);
      vdq_ds<D>(c, st, sa, dpa);
      wgmma_wait<0>();
      keep(acc);
      keep_frags(da);
      release(kt - 1);
      acc_to_a(da, dpa);
      prev = st;
    }
    wgmma_fence();
    vdq_product<D>(acc, da, prev);
    wgmma_wait<0>();
    keep(acc);
    keep_frags(da);
    release(a1 - 1);
  }
  for (int kt = a1; kt < t1; ++kt) {
    landed(kt);
    release(kt);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
varlen_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ seg_q,
                           const int* __restrict__ rel_q,
                           const int* __restrict__ seg_k,
                           const int* __restrict__ rel_k,
                           const int* __restrict__ lo,
                           const int* __restrict__ hi, bf16* __restrict__ dq,
                           int Tq, int H, int causal, float scale) {
  using L = VdqSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBytes);
  uint64_t* qdo_full = full + L::kStages;
  int* cnt = reinterpret_cast<int*>(qdo_full + 1);

  const int h = blockIdx.x;
  const int qb = uniform(lo[2 * gridDim.y + blockIdx.y]);   // launch order
  const int q0 = qb * 128;
  const int wg = uniform(threadIdx.x >> 7);
  // the warpgroups' ranges (an empty one adds nothing to the block's)
  const int l0 = uniform(lo[2 * qb]), h0 = uniform(hi[2 * qb]);
  const int l1 = uniform(lo[2 * qb + 1]), h1 = uniform(hi[2 * qb + 1]);
  const bool n0 = h0 > l0, n1 = h1 > l1;
  const int t0 = n0 ? (n1 ? min(l0, l1) : l0) : (n1 ? l1 : 0);
  const int t1 = n0 ? (n1 ? max(h0, h1) : h0) : (n1 ? h1 : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      cnt[s] = 0;
    }
    mbar_init(qdo_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, t = lane & 3;
  const int qw = q0 + 64 * wg;                  // this warpgroup's rows
  const int r0 = qw + 16 * (tid >> 5) + (lane >> 2);   // and r0 + 8
  VdqCtx c{smem + L::kRing, full, cnt, &tk, &tv, seg_k, rel_k,
           sw128_desc(smem + 2 * wg * L::kTile),
           sw128_desc(smem + (2 * wg + 1) * L::kTile), scale * kLog2e,
           scale};
  c.causal = causal;
  c.t = t;
  c.t0 = t0;
  c.n = t1 - t0;
  c.h = h;
  if (threadIdx.x == 0) {
    mbar_expect(qdo_full, 4 * L::kTile);
    for (int w = 0; w < 2; ++w) {
      tma_tile<D>(smem + 2 * w * L::kTile, &tq, h * D, q0 + 64 * w, 0,
                  qdo_full);
      tma_tile<D>(smem + (2 * w + 1) * L::kTile, &tdo, h * D, q0 + 64 * w,
                  0, qdo_full);
    }
    for (int i = 0; i < min(L::kStages, c.n); ++i) vdq_fill<D>(c, i);
  }
  // rows past Tq: finite lse and delta, never written (metadata is padded
  // past Tq to whole 128-row blocks)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const float x = r < Tq ? lse[(size_t)h * Tq + r] : 0.f;
    c.lse2[i] = isfinite(x) ? x * kLog2e : 0.f;
    c.dl[i] = r < Tq ? delta[(size_t)h * Tq + r] : 0.f;
    c.sq[i] = seg_q[r];
    c.rq[i] = rel_q[r];
  }
  c.s_first = uniform(seg_q[qw]);
  c.s_last = uniform(seg_q[qw + 63]);
  c.r_first = uniform(rel_q[qw]);
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  mbar_wait(qdo_full, 0);
  vdq_walk<D>(c, wg ? l1 : l0, wg ? h1 : h0, acc);
  store_rows<D>(dq + (size_t)h * D, (size_t)H * D, r0, Tq, acc, 1.f, t);
}

// dK/dV (replaces _vbwd_dkdv_kernel).  One block per (head, 128 keys), whose K
// and V tiles land once; warpgroup w owns keys k0 + 64 w .. + 63 and holds
// their dK and dV in f32.  A ring stage is one 64-query tile of Q and dO and
// the queries' lse and delta (from the wrapper's [H, pad_q] copies: lse times
// log2 e, 0 where not finite, +inf past Tq, so padded queries get p = 0;
// delta 0 past Tq), segment ids and positions.  A tile is walked in steps of
// kNq queries (32 at D 128, where the dK and dV accumulators take 128
// registers a thread): S^T = K Q^T and dP^T = V dO^T (K-major), then dV +=
// P^T dO and dK += dS^T Q with dO and Q read N-major.  Each warpgroup sums
// its query tiles in order, so reruns are bit for bit.
template <int D>
struct VdkdvSmem {
  static constexpr int kStages = D == 64 ? 6 : 4;
  static constexpr int kNq = D == 64 ? 64 : 32;     // queries a step
  static constexpr int kSteps = 64 / kNq;
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kStage = 2 * kTile + 1024;   // Q, dO, query metadata
  static constexpr int kRing = 4 * kTile;           // K, V x 2
  static constexpr int kBytes = kRing + kStages * kStage;
  static constexpr size_t kDynamic = kBytes + 8 * (2 * kStages + 1) + 1024;
};

// What a dK/dV warpgroup's steps read besides its registers: the ring and
// what fills it, its keys' segment ids and positions, and its first and
// last key's.
struct VdkdvCtx {
  unsigned char* ring;
  uint64_t* full;
  int* cnt;
  const CUtensorMap *tq, *tdo;
  const float *lse2, *delta;
  const int *seg_q, *rel_q;
  uint64_t k_desc, v_desc;
  float s_mul, scale;
  int sk[2], rk[2], s_first, s_last, r_last, causal, t, t0, n, h, pad_q;
};

// ring tile i (query tile t0 + i) into its stage
template <int D>
__device__ __forceinline__ void vdkdv_fill(const VdkdvCtx& c, int i) {
  using L = VdkdvSmem<D>;
  const int s = i % L::kStages, q0 = (c.t0 + i) * 64;
  unsigned char* st = c.ring + s * L::kStage;
  const size_t row = (size_t)c.h * c.pad_q + q0;
  mbar_expect(c.full + s, 2 * L::kTile + 1024);
  tma_tile<D>(st, c.tq, c.h * D, q0, 0, c.full + s);
  tma_tile<D>(st + L::kTile, c.tdo, c.h * D, q0, 0, c.full + s);
  bulk_copy(st + 2 * L::kTile, c.lse2 + row, 256, c.full + s);
  bulk_copy(st + 2 * L::kTile + 256, c.delta + row, 256, c.full + s);
  bulk_copy(st + 2 * L::kTile + 512, c.seg_q + q0, 256, c.full + s);
  bulk_copy(st + 2 * L::kTile + 768, c.rel_q + q0, 256, c.full + s);
}

// Step h of the landed query tile `st`: S^T = K Q^T and dP^T = V dO^T over
// its queries kNq h .. kNq h + kNq - 1, committed
template <int D>
__device__ __forceinline__ void vdkdv_scores(
    const VdkdvCtx& c, const unsigned char* st, int h,
    float (&sa)[VdkdvSmem<D>::kNq / 2], float (&dpa)[VdkdvSmem<D>::kNq / 2]) {
  using L = VdkdvSmem<D>;
  const uint64_t q_desc = sw128_desc(st + L::kNq * h * 128);
  const uint64_t do_desc = sw128_desc(st + L::kTile + L::kNq * h * 128);
  wgmma_fence();
  wgmma_ss_first<L::kNq>(sa, c.k_desc, q_desc);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss<L::kNq>(sa, c.k_desc + (kmajor_step(kk) >> 4),
                     q_desc + (kmajor_step(kk) >> 4), 1);
  wgmma_ss_first<L::kNq>(dpa, c.v_desc, do_desc);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    wgmma_ss<L::kNq>(dpa, c.v_desc + (kmajor_step(kk) >> 4),
                     do_desc + (kmajor_step(kk) >> 4), 1);
  wgmma_commit();
}

// p into sa and dS into dpa (f32) of step h from its landed scores; column
// kNq h + 8 j + 2 t + (e & 1) of element 4 j + e is the tile's query, e >> 1
// the thread's key r or r + 8
template <int D>
__device__ __forceinline__ void vdkdv_probs(
    const VdkdvCtx& c, const unsigned char* st, int h,
    float (&sa)[VdkdvSmem<D>::kNq / 2], float (&dpa)[VdkdvSmem<D>::kNq / 2]) {
  using L = VdkdvSmem<D>;
  constexpr int kNq = L::kNq;
  const float* stats = reinterpret_cast<const float*>(st + 2 * L::kTile);
  const int* mq = reinterpret_cast<const int*>(stats + 128);
  const int q_first = uniform(mq[0]), q_last = uniform(mq[63]);
  const bool one = q_first == q_last && c.s_first == c.s_last &&
                   q_first == c.s_first &&
                   (!c.causal || uniform(mq[64]) >= c.r_last);
  if (!one) {
#pragma unroll
    for (int e = 0; e < kNq / 2; ++e) {
      const int col = kNq * h + 8 * (e >> 2) + 2 * c.t + (e & 1);
      const int i = (e >> 1) & 1;
      if (!visible(mq[col], mq[64 + col], c.sk[i], c.rk[i], c.causal))
        sa[e] = -INFINITY;
    }
  }
#pragma unroll
  for (int j = 0; j < kNq / 8; ++j) {
    const float2 l2 =
        *reinterpret_cast<const float2*>(stats + kNq * h + 8 * j + 2 * c.t);
    const float2 dl = *reinterpret_cast<const float2*>(
        stats + 64 + kNq * h + 8 * j + 2 * c.t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          ex2(fmaf(sa[4 * j + e], c.s_mul, -((e & 1) ? l2.y : l2.x)));
      sa[4 * j + e] = p;
      dpa[4 * j + e] = p * (dpa[4 * j + e] - ((e & 1) ? dl.y : dl.x)) *
                       c.scale;
    }
  }
}

// dV += P^T dO and dK += dS^T Q over step h of the query tile `st` (dO and
// Q N-major), committed
template <int D>
__device__ __forceinline__ void vdkdv_products(
    const unsigned char* st, int h,
    const uint32_t (&pa)[VdkdvSmem<D>::kNq / 16][4],
    const uint32_t (&da)[VdkdvSmem<D>::kNq / 16][4], float (&dk)[D / 2],
    float (&dv)[D / 2]) {
  using L = VdkdvSmem<D>;
  const uint64_t q_mn = sw128_desc_mn(st + L::kNq * h * 128, 8192);
  const uint64_t do_mn = sw128_desc_mn(st + L::kTile + L::kNq * h * 128,
                                       8192);
#pragma unroll
  for (int kk = 0; kk < L::kNq / 16; ++kk) {
    wgmma_rs_nd<D>(dv, pa[kk], do_mn + (nmajor_step(kk) >> 4));
    wgmma_rs_nd<D>(dk, da[kk], q_mn + (nmajor_step(kk) >> 4));
  }
  wgmma_commit();
}

// One step after the first: step h of `st`'s scores in flight with the
// previous step's (`pst`, ph) gradient products, then p and dS; `done`
// (the previous query tile, or -1) is released once its last products are
// done
template <int D, class Release>
__device__ __forceinline__ void vdkdv_step(
    const VdkdvCtx& c, const unsigned char* st, int h,
    const unsigned char* pst, int ph, int done, Release release,
    float (&sa)[VdkdvSmem<D>::kNq / 2], float (&dpa)[VdkdvSmem<D>::kNq / 2],
    uint32_t (&pa)[VdkdvSmem<D>::kNq / 16][4],
    uint32_t (&da)[VdkdvSmem<D>::kNq / 16][4], float (&dk)[D / 2],
    float (&dv)[D / 2]) {
  vdkdv_scores<D>(c, st, h, sa, dpa);
  vdkdv_products<D>(pst, ph, pa, da, dk, dv);
  wgmma_wait<1>();
  keep(sa);
  keep(dpa);
  vdkdv_probs<D>(c, st, h, sa, dpa);
  wgmma_wait<0>();
  keep(dk);
  keep(dv);
  keep_frags(pa);
  keep_frags(da);
  if (done >= 0) release(done);
  acc_to_a(pa, sa);                          // p rounded to bf16 for dV
  acc_to_a(da, dpa);                         // dS rounded to bf16 for dK
}

// One warpgroup's walk over the ring tiles [c.t0, c.t0 + c.n), computing
// the query tiles [a0, a1) (a1 <= a0: none); bounds warp-uniform
template <int D>
__device__ __forceinline__ void vdkdv_walk(const VdkdvCtx& c, int a0, int a1,
                                           float (&dk)[D / 2],
                                           float (&dv)[D / 2]) {
  using L = VdkdvSmem<D>;
  constexpr int kNq = L::kNq, kSteps = L::kSteps;
  const int t1 = c.t0 + c.n;
  if (a1 <= a0) a0 = a1 = t1;
  auto landed = [&](int qt) {
    const int i = qt - c.t0;
    mbar_wait(c.full + i % L::kStages, (i / L::kStages) & 1);
    return c.ring + (i % L::kStages) * L::kStage;
  };
  auto release = [&](int qt) {
    ring_release(c.cnt, qt - c.t0, c.n, L::kStages,
                 [&](int i) { vdkdv_fill<D>(c, i); });
  };
  for (int qt = c.t0; qt < a0; ++qt) {
    landed(qt);
    release(qt);
  }
  if (a0 < a1) {
    float sa[kNq / 2], dpa[kNq / 2];
    uint32_t pa[kNq / 16][4], da[kNq / 16][4];
    const unsigned char* st = landed(a0);
    vdkdv_scores<D>(c, st, 0, sa, dpa);
    wgmma_wait<0>();
    keep(sa);
    keep(dpa);
    vdkdv_probs<D>(c, st, 0, sa, dpa);
    acc_to_a(pa, sa);
    acc_to_a(da, dpa);
#pragma unroll
    for (int h = 1; h < kSteps; ++h)
      vdkdv_step<D>(c, st, h, st, h - 1, -1, release, sa, dpa, pa, da, dk,
                    dv);
    const unsigned char* pst = st;
    for (int qt = a0 + 1; qt < a1; ++qt) {
      st = landed(qt);
      vdkdv_step<D>(c, st, 0, pst, kSteps - 1, qt - 1, release, sa, dpa, pa,
                    da, dk, dv);
#pragma unroll
      for (int h = 1; h < kSteps; ++h)
        vdkdv_step<D>(c, st, h, st, h - 1, -1, release, sa, dpa, pa, da, dk,
                      dv);
      pst = st;
    }
    wgmma_fence();
    vdkdv_products<D>(pst, kSteps - 1, pa, da, dk, dv);
    wgmma_wait<0>();
    keep(dk);
    keep(dv);
    keep_frags(pa);
    keep_frags(da);
    release(a1 - 1);
  }
  for (int qt = a1; qt < t1; ++qt) {
    landed(qt);
    release(qt);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
varlen_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse2,
                             const float* __restrict__ delta,
                             const int* __restrict__ seg_q,
                             const int* __restrict__ rel_q,
                             const int* __restrict__ seg_k,
                             const int* __restrict__ rel_k,
                             const int* __restrict__ lo,
                             const int* __restrict__ hi,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int Tq, int Tk, int H, int causal, float scale) {
  using L = VdkdvSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBytes);
  uint64_t* kv_full = full + L::kStages;
  int* cnt = reinterpret_cast<int*>(kv_full + 1);

  const int h = blockIdx.x;
  const int kb = uniform(lo[2 * gridDim.y + blockIdx.y]);   // launch order
  const int k0 = kb * 128;
  const int wg = uniform(threadIdx.x >> 7);
  const int l0 = uniform(lo[2 * kb]), h0 = uniform(hi[2 * kb]);
  const int l1 = uniform(lo[2 * kb + 1]), h1 = uniform(hi[2 * kb + 1]);
  const bool n0 = h0 > l0, n1 = h1 > l1;
  const int t0 = n0 ? (n1 ? min(l0, l1) : l0) : (n1 ? l1 : 0);
  const int t1 = n0 ? (n1 ? max(h0, h1) : h0) : (n1 ? h1 : 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      cnt[s] = 0;
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, t = lane & 3;
  const int kw = k0 + 64 * wg;                  // this warpgroup's keys
  const int kr = kw + 16 * (tid >> 5) + (lane >> 2);   // and kr + 8
  VdkdvCtx c{smem + L::kRing, full, cnt, &tq, &tdo, lse2, delta, seg_q,
             rel_q, sw128_desc(smem + 2 * wg * L::kTile),
             sw128_desc(smem + (2 * wg + 1) * L::kTile), scale * kLog2e,
             scale};
  c.causal = causal;
  c.t = t;
  c.t0 = t0;
  c.n = t1 - t0;
  c.h = h;
  c.pad_q = (Tq + 127) / 128 * 128;
  if (threadIdx.x == 0) {
    mbar_expect(kv_full, 4 * L::kTile);
    for (int w = 0; w < 2; ++w) {
      tma_tile<D>(smem + 2 * w * L::kTile, &tk, h * D, k0 + 64 * w, 0,
                  kv_full);
      tma_tile<D>(smem + (2 * w + 1) * L::kTile, &tv, h * D, k0 + 64 * w, 0,
                  kv_full);
    }
    for (int i = 0; i < min(L::kStages, c.n); ++i) vdkdv_fill<D>(c, i);
  }
  // (the metadata is padded past Tk to whole 128-key blocks)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    c.sk[i] = seg_k[kr + 8 * i];
    c.rk[i] = rel_k[kr + 8 * i];
  }
  c.s_first = uniform(seg_k[kw]);
  c.s_last = uniform(seg_k[kw + 63]);
  c.r_last = uniform(rel_k[kw + 63]);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;
  mbar_wait(kv_full, 0);
  vdkdv_walk<D>(c, wg ? l1 : l0, wg ? h1 : h0, dk_acc, dv_acc);
  const size_t off = (size_t)h * D, ld = (size_t)H * D;
  store_rows<D>(dk + off, ld, kr, Tk, dk_acc, 1.f, t);
  store_rows<D>(dv + off, ld, kr, Tk, dv_acc, 1.f, t);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D, int NB>
constexpr size_t fwd_smem() {
  return ((size_t)(kTile + 2 * NB) * (D + 1) + (size_t)kTile * (NB + 1)) *
             sizeof(float) + 2 * NB * sizeof(int);
}
template <int D, int NQ>
constexpr size_t dkdv_smem() {
  return ((size_t)(2 * kTile + 2 * NQ) * (D + 1) +
          2 * (size_t)kTile * (NQ + 1) + 2 * NQ) * sizeof(float) +
         2 * NQ * sizeof(int);
}
template <int D, int NK>
constexpr size_t dq_smem() {
  return ((size_t)(2 * kTile + 2 * NK) * (D + 1) +
          (size_t)kTile * (NK + 1)) * sizeof(float) + 2 * NK * sizeof(int);
}
struct Meta {
  const int *seg_q, *rel_q, *seg_k, *rel_k, *lo, *hi;
};

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, Meta mt,
               void* out, void* lse, int Tq, int Tk, int H, int causal,
               float scale, cudaStream_t stream) {
  if constexpr (kMma<T, D>) {
    CUtensorMap m[3];
    if (!head_map(&m[0], q, 1, Tq, H, D) || !head_map(&m[1], k, 1, Tk, H, D)
        || !head_map(&m[2], v, 1, Tk, H, D))
      return (int)cudaErrorInvalidValue;
    // every head of the first block of the launch order first
    return launch(varlen_fwd_wgmma_kernel<D>, dim3(H, (Tq + 127) / 128),
                  kWgThreads, FwdSmem<D, 1024>::kDynamic, stream, m[0], m[1],
                  m[2], mt.seg_q, mt.rel_q, mt.seg_k, mt.rel_k, mt.lo, mt.hi,
                  static_cast<bf16*>(out), static_cast<float*>(lse), Tq, H,
                  causal, scale);
  } else {
    return launch(varlen_fwd_kernel<T, D, walk<D>()>,
                  dim3((Tq + kTile - 1) / kTile, H), kThreads,
                  fwd_smem<D, walk<D>()>(), stream, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  mt.seg_q, mt.rel_q, mt.seg_k, mt.rel_k, mt.lo, mt.hi,
                  static_cast<T*>(out), static_cast<float*>(lse), Tq, Tk, H,
                  causal, scale);
  }
}

// q, k, v and dout as TMA maps (3D [1, T, H * D], rows past T read zeros)
inline bool bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                     const void* v, const void* dout, int Tq, int Tk, int H,
                     int D) {
  return head_map(&m[0], q, 1, Tq, H, D) && head_map(&m[1], k, 1, Tk, H, D) &&
         head_map(&m[2], v, 1, Tk, H, D) &&
         head_map(&m[3], dout, 1, Tq, H, D);
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta, Meta mt,
                void* dk, void* dv, int Tq, int Tk, int H, int causal,
                float scale, cudaStream_t stream) {
  if constexpr (kMma<T, D>) {
    CUtensorMap m[4];
    if (!bwd_maps(m, q, k, v, dout, Tq, Tk, H, D))
      return (int)cudaErrorInvalidValue;
    return launch(varlen_bwd_dkdv_wgmma_kernel<D>, dim3(H, (Tk + 127) / 128),
                  kBwdThreads, VdkdvSmem<D>::kDynamic, stream, m[0], m[1],
                  m[2], m[3], static_cast<const float*>(lse),
                  static_cast<const float*>(delta), mt.seg_q, mt.rel_q,
                  mt.seg_k, mt.rel_k, mt.lo, mt.hi, static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv), Tq, Tk, H, causal, scale);
  } else {
    return launch(varlen_bwd_dkdv_kernel<T, D, walk<D>()>,
                  dim3((Tk + kTile - 1) / kTile, H), kThreads,
                  dkdv_smem<D, walk<D>()>(), stream, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), mt.seg_q, mt.rel_q,
                  mt.seg_k, mt.rel_k, mt.lo, mt.hi, static_cast<T*>(dk),
                  static_cast<T*>(dv), Tq, Tk, H, causal, scale);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, Meta mt, void* dq, int Tq,
              int Tk, int H, int causal, float scale, cudaStream_t stream) {
  if constexpr (kMma<T, D>) {
    CUtensorMap m[4];
    if (!bwd_maps(m, q, k, v, dout, Tq, Tk, H, D))
      return (int)cudaErrorInvalidValue;
    return launch(varlen_bwd_dq_wgmma_kernel<D>, dim3(H, (Tq + 127) / 128),
                  kBwdThreads, VdqSmem<D>::kDynamic, stream, m[0], m[1], m[2],
                  m[3], static_cast<const float*>(lse),
                  static_cast<const float*>(delta), mt.seg_q, mt.rel_q,
                  mt.seg_k, mt.rel_k, mt.lo, mt.hi, static_cast<bf16*>(dq),
                  Tq, H, causal, scale);
  } else {
    return launch(varlen_bwd_dq_kernel<T, D, walk<D>()>,
                  dim3((Tq + kTile - 1) / kTile, H), kThreads,
                  dq_smem<D, walk<D>()>(), stream, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), mt.seg_q, mt.rel_q,
                  mt.seg_k, mt.rel_k, mt.lo, mt.hi, static_cast<T*>(dq), Tq,
                  Tk, H, causal, scale);
  }
}

}  // namespace

// C entries, bound with ctypes by paddle_tpu_torch/ops/flash_attention_
// varlen.py, which has already checked shapes, types, contiguity and
// alignment (D in {64, 128, 256}, Tq, Tk >= 1) and computed the segment
// metadata (seg/rel padded to multiples of 64 rows) and the tile ranges
// lo/hi of each 64-row tile (walked tiles of 32 at D = 256).  At bf16 D 64
// and 128 every kernel owns 128 rows a block: the forward's query metadata
// is padded to whole 128-row blocks, the backward's on both sides, and
// after the 2 * nb ranges of the block's own 64-row tiles (nb = ceil(Tq /
// 128) blocks in the forward and dQ, ceil(Tk / 128) in dK/dV) lo holds the
// blocks' launch order (nb ints); the bf16 dK/dV at D 64 and 128 takes lse
// and delta as [H, pad_q] copies, lse times log2 e (0 where not finite,
// +inf past Tq) and delta 0 past Tq.
// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after
// its launch (0 on success).

#define PADDLE_VARLEN_DISPATCH(LAUNCH, ...)                                 \
  do {                                                                      \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                     \
    const Meta mt{static_cast<const int*>(seg_q),                           \
                  static_cast<const int*>(rel_q),                           \
                  static_cast<const int*>(seg_k),                           \
                  static_cast<const int*>(rel_k),                           \
                  static_cast<const int*>(lo), static_cast<const int*>(hi)}; \
    if (dtype == 0 && D == 64) return LAUNCH<float, 64>(__VA_ARGS__, s);    \
    if (dtype == 0 && D == 128) return LAUNCH<float, 128>(__VA_ARGS__, s);  \
    if (dtype == 0 && D == 256) return LAUNCH<float, 256>(__VA_ARGS__, s);  \
    if (dtype == 1 && D == 64) return LAUNCH<bf16, 64>(__VA_ARGS__, s);     \
    if (dtype == 1 && D == 128) return LAUNCH<bf16, 128>(__VA_ARGS__, s);   \
    if (dtype == 1 && D == 256) return LAUNCH<bf16, 256>(__VA_ARGS__, s);   \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

extern "C" int paddle_varlen_attention_fwd(
    const void* q, const void* k, const void* v, const void* seg_q,
    const void* rel_q, const void* seg_k, const void* rel_k, const void* lo,
    const void* hi, void* out, void* lse, int Tq, int Tk, int H, int D,
    int causal, int dtype, float scale, void* stream) {
  PADDLE_VARLEN_DISPATCH(launch_fwd, q, k, v, mt, out, lse, Tq, Tk, H,
                         causal, scale);
}

extern "C" int paddle_varlen_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* rel_q,
    const void* seg_k, const void* rel_k, const void* lo, const void* hi,
    void* dk, void* dv, int Tq, int Tk, int H, int D, int causal, int dtype,
    float scale, void* stream) {
  PADDLE_VARLEN_DISPATCH(launch_dkdv, q, k, v, dout, lse, delta, mt, dk, dv,
                         Tq, Tk, H, causal, scale);
}

extern "C" int paddle_varlen_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seg_q, const void* rel_q,
    const void* seg_k, const void* rel_k, const void* lo, const void* hi,
    void* dq, int Tq, int Tk, int H, int D, int causal, int dtype,
    float scale, void* stream) {
  PADDLE_VARLEN_DISPATCH(launch_dq, q, k, v, dout, lse, delta, mt, dq, Tq, Tk,
                         H, causal, scale);
}
