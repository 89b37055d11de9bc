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
// block, 128 in the wgmma forward) and walk the key tiles lo..hi of their
// block; dK/dV owns 64 keys and walks query tiles.  Rows past T are read
// as zeros and never written.
//
// Rounding points, as in the varlen TPU kernels (not the fixed-length
// ones): the scale multiplies the f32 score (q is not pre-scaled); p is
// rounded to the input type before the PV product while the row sum l
// takes the unrounded p; dS = p * (dP - delta) * scale is rounded to it
// for dK and dQ; p is rounded for dV.  A query row with no key gets output
// 0 and lse = -inf, and the backward reads such an lse as 0 (its masked p
// is 0 anyway).  No atomics: dK/dV sums its query tiles in a fixed order,
// so reruns are bit-identical.
//
// Three families of kernels.  float inputs (every D) and bfloat16 at D =
// 256 take CUDA-core kernels: operands widened to f32 in shared memory,
// IEEE f32 FMAs (never TF32), walked tiles of 64 rows (32 at D = 256,
// where four 64-row f32 tiles would not fit the 227 KB of shared memory).
// bfloat16 at D in {64, 128}: the forward runs on wgmma fed by TMA
// (attention_common.cuh's warp-specialised walk, shared with the
// fixed-length forward), dK/dV and dQ on mma.sync m16n8k16 with f32
// accumulators, p and dS passed from the score registers to the next
// product's A fragments (the rounding points are exactly the mma operand
// type).  All are the structure of csrc/flash_attention.cu with segment
// masks and tile ranges in place of the causal triangle.
//
// What bounds them: operations.  LLaMA-7B's attention over 8 packed causal
// sequences (8,192 tokens, H 32, D 128) does 2 * 2 * D * H * sum s(s+1)/2
// = 150 GFLOP forward on 67 MB.  The bf16 forward keeps K/V copies in
// flight behind its products and masks only the tiles that need it; the
// backward kernels are a simple first version (tiles loaded synchronously,
// mma.sync rather than wgmma).

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
// bfloat16 backward on the tensor cores (D in {64, 128})
//
// attention_common.cuh's mma.sync layout: warp w owns 16 rows (queries in
// dQ, keys in dK/dV) of the block's 64; p and dS pass from the score
// registers to the next product's A fragments.
// ---------------------------------------------------------------------------

// dK/dV, bf16: varlen_bwd_dkdv_kernel's design, products on the tensor
// cores.  Warp w owns keys k0 + 16 w .. + 15.  A query tile is walked in
// chunks of NQ queries (32 at D = 128, so that the two 16 x D accumulators
// and the chunk's score tiles fit the registers).  Q and dO sit in shared
// memory by rows (B of K Q^T and V dO^T) and transposed (B of P^T dO and
// dS^T Q).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
varlen_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           const int* __restrict__ seg_q,
                           const int* __restrict__ rel_q,
                           const int* __restrict__ seg_k,
                           const int* __restrict__ rel_k,
                           const int* __restrict__ lo,
                           const int* __restrict__ hi, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int Tq, int Tk, int H,
                           int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int NQ = D == 128 ? 32 : 64;   // queries per chunk
  constexpr int NT = NQ / 8, KS = NQ / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // [64 keys][LD]
  bf16* v_s = k_s + kTile * LD;                     // [64 keys][LD]
  bf16* q_s = v_s + kTile * LD;                     // [64 queries][LD]
  bf16* do_s = q_s + kTile * LD;                    // [64 queries][LD]
  bf16* qt_s = do_s + kTile * LD;                   // [D][kLdT]
  bf16* dot_s = qt_s + D * kLdT;                    // [D][kLdT]
  float* lse_s = reinterpret_cast<float*>(dot_s + D * kLdT);  // [64]
  float* delta_s = lse_s + kTile;                             // [64]
  int* sq_s = reinterpret_cast<int*>(delta_s + kTile);        // [64]
  int* rq_s = sq_s + kTile;                                   // [64]

  const int kt = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTile;
  const int kr0 = k0 + 16 * w + g;        // this thread's keys kr0, kr0 + 8
  const size_t ld = (size_t)H * D;

  const size_t kv_off = (size_t)k0 * ld + (size_t)h * D;
  load_bf16<D, false>(k_s, k + kv_off, ld, Tk - k0);
  load_bf16<D, false>(v_s, v + kv_off, ld, Tk - k0);
  int sk[2], rk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sk[i] = seg_k[kr0 + 8 * i];
    rk[i] = rel_k[kr0 + 8 * i];
  }
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int qt = lo[kt]; qt < hi[kt]; ++qt) {
    const int q0 = qt * kTile;
    const int q_rows = Tq - q0;
    const size_t q_off = (size_t)q0 * ld + (size_t)h * D;
    __syncthreads();                 // the previous tile's products are done
    load_bf16<D, false>(q_s, q + q_off, ld, q_rows);
    load_bf16<D, true>(qt_s, q + q_off, ld, q_rows);
    load_bf16<D, false>(do_s, dout + q_off, ld, q_rows);
    load_bf16<D, true>(dot_s, dout + q_off, ld, q_rows);
    if (threadIdx.x < kTile) {
      const int i = threadIdx.x;
      const bool ok = i < q_rows;
      const float x = ok ? lse[(size_t)h * Tq + q0 + i] : INFINITY;
      lse_s[i] = ok && !isfinite(x) ? 0.f : x;
      delta_s[i] = ok ? delta[(size_t)h * Tq + q0 + i] : 0.f;
      sq_s[i] = seg_q[q0 + i];
      rq_s[i] = rel_q[q0 + i];
    }
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += NQ) {
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      mma_abt<D, NT>(st, k_s, LD, 16 * w, q_s, LD, c0, g, t);
      mma_abt<D, NT>(dpt, v_s, LD, 16 * w, do_s, LD, c0, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = c0 + 8 * n + 2 * t + (e & 1);   // query in tile
          const int i = e >> 1;
          const float s = visible(sq_s[qc], rq_s[qc], sk[i], rk[i], causal)
                              ? st[n][e] * scale : -INFINITY;
          const float p = expf(s - lse_s[qc]);
          st[n][e] = p;
          dpt[n][e] = p * (dpt[n][e] - delta_s[qc]) * scale;
        }
      uint32_t pa[KS][4], dsa[KS][4];
      to_a<KS>(pa, st);              // p rounded to bf16 for dV
      to_a<KS>(dsa, dpt);            // dS rounded to bf16 for dK
      mma_pb<KS, D / 8>(dv_acc, pa, dot_s, kLdT, c0, g, t);
      mma_pb<KS, D / 8>(dk_acc, dsa, qt_s, kLdT, c0, g, t);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kr0 + 8 * i;
    if (r < Tk) {
      const size_t off = (size_t)r * ld + (size_t)h * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * n) =
            pack_bf16(dk_acc[n][2 * i], dk_acc[n][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * n) =
            pack_bf16(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
  }
}

// dQ, bf16: varlen_bwd_dq_kernel's design, products on the tensor cores.
// Warp w owns queries q0 + 16 w .. + 15; the K tile sits in shared memory
// by rows (B of Q K^T) and transposed (B of dS K); V by rows (B of dO
// V^T).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
varlen_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ rel_q,
                         const int* __restrict__ seg_k,
                         const int* __restrict__ rel_k,
                         const int* __restrict__ lo,
                         const int* __restrict__ hi, bf16* __restrict__ dq,
                         int Tq, int Tk, int H, int causal, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [64 queries][LD]
  bf16* do_s = q_s + kTile * LD;                    // [64 queries][LD]
  bf16* k_s = do_s + kTile * LD;                    // [64 keys][LD]
  bf16* v_s = k_s + kTile * LD;                     // [64 keys][LD]
  bf16* kt_s = v_s + kTile * LD;                    // [D][kLdT]
  int* sk_s = reinterpret_cast<int*>(kt_s + D * kLdT);  // [64]
  int* rk_s = sk_s + kTile;                             // [64]

  const int qt = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int r0 = q0 + 16 * w + g;         // this thread's rows r0, r0 + 8
  const size_t ld = (size_t)H * D;

  const size_t q_off = (size_t)q0 * ld + (size_t)h * D;
  load_bf16<D, false>(q_s, q + q_off, ld, Tq - q0);
  load_bf16<D, false>(do_s, dout + q_off, ld, Tq - q0);
  int sq[2], rq[2];
  float lse_r[2], delta_r[2];             // rows past Tq: finite, unwritten
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    sq[i] = seg_q[r];
    rq[i] = rel_q[r];
    const float x = r < Tq ? lse[(size_t)h * Tq + r] : 0.f;
    lse_r[i] = isfinite(x) ? x : 0.f;
    delta_r[i] = r < Tq ? delta[(size_t)h * Tq + r] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = lo[qt]; kt < hi[qt]; ++kt) {
    const int k0 = kt * kTile;
    const size_t kv_off = (size_t)k0 * ld + (size_t)h * D;
    __syncthreads();                 // the previous tile's products are done
    load_bf16<D, false>(k_s, k + kv_off, ld, Tk - k0);
    load_bf16<D, true>(kt_s, k + kv_off, ld, Tk - k0);
    load_bf16<D, false>(v_s, v + kv_off, ld, Tk - k0);
    load_meta(sk_s, rk_s, seg_k, rel_k, k0, kTile);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, 8>(s, q_s, LD, 16 * w, k_s, LD, 0, g, t);
    mma_abt<D, 8>(dp, do_s, LD, 16 * w, v_s, LD, 0, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = 8 * n + 2 * t + (e & 1);
        const int i = e >> 1;
        const float sv = visible(sq[i], rq[i], sk_s[kc], rk_s[kc], causal)
                             ? s[n][e] * scale : -INFINITY;
        const float p = expf(sv - lse_r[i]);
        dp[n][e] = p * (dp[n][e] - delta_r[i]) * scale;
      }
    uint32_t dsa[4][4];
    to_a<4>(dsa, dp);                // dS rounded to bf16
    mma_pb<4, D / 8>(acc, dsa, kt_s, kLdT, 0, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r < Tq) {
      bf16* dst = dq + (size_t)r * ld + (size_t)h * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
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
template <int D>
constexpr size_t dkdv_mma_smem() {
  return (4 * (size_t)kTile * (D + 8) + 2 * (size_t)D * kLdT) *
             sizeof(bf16) + 2 * kTile * (sizeof(float) + sizeof(int));
}
template <int D>
constexpr size_t dq_mma_smem() {
  return (4 * (size_t)kTile * (D + 8) + (size_t)D * kLdT) * sizeof(bf16) +
         2 * kTile * sizeof(int);
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

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta, Meta mt,
                void* dk, void* dv, int Tq, int Tk, int H, int causal,
                float scale, cudaStream_t stream) {
  const dim3 grid((Tk + kTile - 1) / kTile, H);
  auto args = [&](auto kern, int threads, size_t smem) {
    return launch(kern, grid, threads, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), mt.seg_q, mt.rel_q,
                  mt.seg_k, mt.rel_k, mt.lo, mt.hi, static_cast<T*>(dk),
                  static_cast<T*>(dv), Tq, Tk, H, causal, scale);
  };
  if constexpr (kMma<T, D>)
    return args(varlen_bwd_dkdv_mma_kernel<D>, kMmaThreads,
                dkdv_mma_smem<D>());
  else
    return args(varlen_bwd_dkdv_kernel<T, D, walk<D>()>, kThreads,
                dkdv_smem<D, walk<D>()>());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, Meta mt, void* dq, int Tq,
              int Tk, int H, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((Tq + kTile - 1) / kTile, H);
  auto args = [&](auto kern, int threads, size_t smem) {
    return launch(kern, grid, threads, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), mt.seg_q, mt.rel_q,
                  mt.seg_k, mt.rel_k, mt.lo, mt.hi, static_cast<T*>(dq), Tq,
                  Tk, H, causal, scale);
  };
  if constexpr (kMma<T, D>)
    return args(varlen_bwd_dq_mma_kernel<D>, kMmaThreads, dq_mma_smem<D>());
  else
    return args(varlen_bwd_dq_kernel<T, D, walk<D>()>, kThreads,
                dq_smem<D, walk<D>()>());
}

}  // namespace

// C entries, bound with ctypes by paddle_tpu_torch/ops/flash_attention_
// varlen.py, which has already checked shapes, types, contiguity and
// alignment (D in {64, 128, 256}, Tq, Tk >= 1) and computed the segment
// metadata (seg/rel padded to multiples of 64 rows, the queries' to 128 for
// the bf16 forward at D 64 and 128) and the tile ranges lo/hi of each
// 64-row tile (walked tiles of 32 at D = 256).  The bf16 forward at D 64
// and 128 owns 128 queries a block: after its 2 * ceil(Tq / 128) ranges,
// its lo holds the blocks' launch order (ceil(Tq / 128) ints).
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
