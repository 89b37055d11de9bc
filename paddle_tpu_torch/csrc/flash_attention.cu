// Flash attention for Hopper (sm_90a), written by hand: the forward kernel
// and the two backward kernels (dK/dV, dQ) of one attention with causal and
// GQA options.
//
// Layout: q, dout, out and dq are [B, Sq, H, D]; k, v, dk and dv are
// [B, Sk, Hk, D], all row-major and read in place (a tile of 64 rows of one
// head is 64 strided runs of D contiguous elements); lse and delta are
// [B, H, Sq] float32.  Query head j reads kv head j / G (G = H / Hk).
// Inputs are float or bfloat16 at D 64 or any multiple of 128; every
// product sums in f32.  float inputs, and bfloat16 at D = 256, take the
// first three kernels, IEEE f32 FMAs on the CUDA cores (never TF32);
// bfloat16 at D in {64, 128} the mma.sync kernels on the tensor cores;
// every D past 256 the chunked CUDA-core kernels.  The device code
// they share with the varlen kernels is in attention_common.cuh.
//
// Rounding points, as in the TPU kernels: q * sm_scale is rounded to the
// input type; the forward rounds p to it before the PV product while the
// row sum l takes the unrounded p, and writes lse = m + log(l) in the
// scaled domain; the dK/dV kernel rounds p to it for dV and dS = p * (dP -
// delta) for dK; the dQ kernel rounds dS and uses k * sm_scale rounded.
//
// Shared design.  One block per (64-row tile, head): the forward and dQ
// walk the K/V tiles of their kv head up to the diagonal under causal; dK/dV
// walks, for its 64 keys, the G query heads of its group and their query
// tiles from the diagonal on, so the GQA group sum happens in registers.
// The CUDA-core kernels walk tiles of 64 rows, 32 at D = 256.  The kernels
// mask the causal diagonal and the ragged sequence edge themselves (S need
// not be a multiple of 64): a padded key gets score -inf; a padded query
// row reads zeros and lse = +inf in the backward (so its p is exactly 0)
// and is never written.  The heaviest blocks of the causal triangle are
// launched first.
//
// What bounds them on this card: operations.  At the trainer's shape
// (B 2, S 2048, H 16, Hk 4, D 64) the causal forward does 17.2 GFLOP on
// 21 MB, ~800 flop/byte, above the H100's ridge; so does each backward.
// The bound is the tensor cores' 989 TFLOP/s for bf16, 67 TFLOP/s of f32
// FMAs for f32.  The f32 kernels do every product with scalar FMAs out of
// shared memory (two shared loads for every four FMAs, which caps them
// near half the f32 FMA rate).  The bf16 kernels feed the tensor cores
// with mma.sync, which reaches a fraction of what wgmma would, from tiles
// loaded synchronously (no load/compute overlap).  What a later version
// should change: wgmma from shared memory, K/V tiles double-buffered with
// cp.async or TMA, and the dK/dV grid (one block per 64 keys and kv head,
// 256 blocks at the trainer's shape, the first walking 32 times the query
// tiles of the last) split further.

#include "attention_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// CUDA cores: float at every D, bfloat16 at D = 256
//
// Operands widened to f32 in shared memory (attention_common.cuh's layout:
// row stride D + 1, 4 x N/16 micro-tiles a thread); the rounding points
// are explicit round_to<T> calls, identities for float.
// ---------------------------------------------------------------------------

// ---------------------------------------------------------------------------
// forward
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py :: _fwd_kernel.  One
// block per (64-row query tile, b * H + h); the query tile (pre-scaled)
// stays in shared memory while the block walks the NB-key K/V tiles of kv
// head h / G, up to the diagonal under causal, with an online
// softmax whose running max m, sum l and accumulator stay in f32 registers.
// ---------------------------------------------------------------------------

template <typename T, int D, int NB>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int Hk,
                 int causal, float scale) {
  constexpr int kS = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [64, D]
  float* k_s = q_s + kTile * kS;     // [NB, D]
  float* v_s = k_s + NB * kS;        // [NB, D]
  float* p_s = v_s + NB * kS;        // [64, NB]

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x;   // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;
  const int q_rows = min(kTile, Sq - q0);

  const T* q_base = q + (((size_t)b * Sq + q0) * H + h) * D;
  const T* k_base = k + ((size_t)b * Sk * Hk + hk) * D;
  const T* v_base = v + ((size_t)b * Sk * Hk + hk) * D;
  load_tile<T, D, kTile, true>(q_s, q_base, (size_t)H * D, q_rows, scale);

  float acc[4][D / 16], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (Sk + NB - 1) / NB;
  const int kt_end = causal ? min((q0 + kTile - 1) / NB + 1, n_kt) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * NB;
    __syncthreads();                 // the previous tile's PV is done
    load_tile<T, D, NB>(k_s, k_base + (size_t)k0 * Hk * D, (size_t)Hk * D,
                        Sk - k0);
    load_tile<T, D, NB>(v_s, v_base + (size_t)k0 * Hk * D, (size_t)Hk * D,
                        Sk - k0);
    __syncthreads();

    float s[4][NB / 16];
    mm_abt<D, NB>(s, q_s, k_s, ty, tx);
    if ((causal && k0 + NB - 1 > q0) || k0 + NB > Sk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NB / 16; ++j) {
          const int qp = q0 + ty + 16 * i, kp = k0 + tx + 16 * j;
          if ((causal && kp > qp) || kp >= Sk) s[i][j] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) {
        const float p = expf(s[i][j] - m_use);
        sum += p;
        p_s[(ty + 16 * i) * (NB + 1) + tx + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_use);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mm_ab<D, NB>(acc, p_s, v_s, ty, tx);
  }

  // out = acc / l, divided as the TPU kernel divides
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < q_rows) {
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        out[(((size_t)b * Sq + q0 + r) * H + h) * D + tx + 16 * j] =
            from_f<T>(acc[i][j] / l[i]);
      if (tx == 0) lse[(size_t)bh * Sq + q0 + r] = m[i] + logf(l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK / dV
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py :: _bwd_dkdv_kernel and
// the XLA group sum after it.  One block per (64-key tile, b * Hk + hk); the
// key and value tiles stay in shared memory while the block loops over the
// group's G query heads and, for each, over the NQ-row query tiles from the
// diagonal on (all of them without causal), accumulating dK and dV for the
// whole group in f32 registers.  So the TPU path's [B*H, S, D] f32 partials
// never exist, no atomics are needed, and the summation order is fixed.
// ---------------------------------------------------------------------------

template <typename T, int D, int NQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int H, int Hk,
                      int causal, float scale) {
  constexpr int kS = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // [64 keys, D]
  float* v_s = k_s + kTile * kS;     // [64 keys, D]
  float* q_s = v_s + kTile * kS;     // [NQ queries, D], scaled
  float* do_s = q_s + NQ * kS;       // [NQ queries, D]
  float* pt_s = do_s + NQ * kS;      // [64 keys, NQ queries]: p
  float* dst_s = pt_s + kTile * (NQ + 1);  // dS
  float* lse_s = dst_s + kTile * (NQ + 1); // [NQ]
  float* delta_s = lse_s + NQ;             // [NQ]

  const int kt = blockIdx.x;         // key tile 0 has the most query tiles
  const int bhk = blockIdx.y;
  const int b = bhk / Hk, hk = bhk - b * Hk;
  const int G = H / Hk;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kTile;
  const int k_rows = min(kTile, Sk - k0);

  load_tile<T, D, kTile>(k_s, k + (((size_t)b * Sk + k0) * Hk + hk) * D,
                         (size_t)Hk * D, k_rows);
  load_tile<T, D, kTile>(v_s, v + (((size_t)b * Sk + k0) * Hk + hk) * D,
                         (size_t)Hk * D, k_rows);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int n_qt = (Sq + NQ - 1) / NQ;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t row = (size_t)b * H + h;   // lse/delta row
    for (int qt = causal ? k0 / NQ : 0; qt < n_qt; ++qt) {
      const int q0 = qt * NQ;
      const int q_rows = min(NQ, Sq - q0);
      __syncthreads();               // the previous tile's products are done
      load_tile<T, D, NQ, true>(q_s, q + (((size_t)b * Sq + q0) * H + h) * D,
                                (size_t)H * D, q_rows, scale);
      load_tile<T, D, NQ>(do_s, dout + (((size_t)b * Sq + q0) * H + h) * D,
                          (size_t)H * D, q_rows);
      if (tid < NQ) {
        const bool ok = tid < q_rows;
        lse_s[tid] = ok ? lse[row * Sq + q0 + tid] : INFINITY;
        delta_s[tid] = ok ? delta[row * Sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      float st[4][NQ / 16], dpt[4][NQ / 16];
      mm_abt<D, NQ>(st, k_s, q_s, ty, tx);    // [keys, queries]
      mm_abt<D, NQ>(dpt, v_s, do_s, ty, tx);
      const bool diag = causal && q0 < k0 + kTile - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NQ / 16; ++j) {
          const int qc = tx + 16 * j;
          float s = st[i][j];
          if (diag && q0 + qc < k0 + ty + 16 * i) s = -INFINITY;
          const float p = expf(s - lse_s[qc]);
          const float ds = p * (dpt[i][j] - delta_s[qc]);
          pt_s[(ty + 16 * i) * (NQ + 1) + qc] = round_to<T>(p);
          dst_s[(ty + 16 * i) * (NQ + 1) + qc] = round_to<T>(ds);
        }
      __syncthreads();
      mm_ab<D, NQ>(dv_acc, pt_s, do_s, ty, tx);
      mm_ab<D, NQ>(dk_acc, dst_s, q_s, ty, tx);
    }
  }

  const size_t off = (((size_t)b * Sk + k0) * Hk + hk) * D;
  store_tile<T, D>(dk + off, (size_t)Hk * D, k_rows, dk_acc, ty, tx);
  store_tile<T, D>(dv + off, (size_t)Hk * D, k_rows, dv_acc, ty, tx);
}

// ---------------------------------------------------------------------------
// dQ
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py :: _bwd_dq_kernel.  One
// block per (64-row query tile, b * H + h); the query, dout, lse and delta
// tiles stay in shared memory while the block walks the NK-key K/V tiles of
// its kv head up to the diagonal.  After the scores and dP of a tile are
// taken, the K tile is rescaled in place to k * sm_scale (rounded) for the
// dQ product.
// ---------------------------------------------------------------------------

template <typename T, int D, int NK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, int H, int Hk, int causal, float scale) {
  constexpr int kS = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [64 queries, D], scaled
  float* do_s = q_s + kTile * kS;    // [64 queries, D]
  float* k_s = do_s + kTile * kS;    // [NK keys, D]
  float* v_s = k_s + NK * kS;        // [NK keys, D]
  float* ds_s = v_s + NK * kS;       // [64 queries, NK keys]: dS
  float* lse_s = ds_s + kTile * (NK + 1);  // [64]
  float* delta_s = lse_s + kTile;          // [64]

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x;   // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;
  const int q_rows = min(kTile, Sq - q0);

  const size_t q_off = (((size_t)b * Sq + q0) * H + h) * D;
  load_tile<T, D, kTile, true>(q_s, q + q_off, (size_t)H * D, q_rows, scale);
  load_tile<T, D, kTile>(do_s, dout + q_off, (size_t)H * D, q_rows);
  if (tid < kTile) {
    const bool ok = tid < q_rows;   // padded rows: finite, never written
    lse_s[tid] = ok ? lse[(size_t)bh * Sq + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[(size_t)bh * Sq + q0 + tid] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  const T* k_base = k + ((size_t)b * Sk * Hk + hk) * D;
  const T* v_base = v + ((size_t)b * Sk * Hk + hk) * D;
  const int n_kt = (Sk + NK - 1) / NK;
  const int kt_end = causal ? min((q0 + kTile - 1) / NK + 1, n_kt) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * NK;
    __syncthreads();                 // the previous tile's dQ product is done
    load_tile<T, D, NK>(k_s, k_base + (size_t)k0 * Hk * D, (size_t)Hk * D,
                        Sk - k0);
    load_tile<T, D, NK>(v_s, v_base + (size_t)k0 * Hk * D, (size_t)Hk * D,
                        Sk - k0);
    __syncthreads();

    float s[4][NK / 16], dp[4][NK / 16];
    mm_abt<D, NK>(s, q_s, k_s, ty, tx);        // [queries, keys]
    mm_abt<D, NK>(dp, do_s, v_s, ty, tx);
    const bool masked = (causal && k0 + NK - 1 > q0) || k0 + NK > Sk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NK / 16; ++j) {
        const int kc = tx + 16 * j;
        float sv = s[i][j];
        if (masked && ((causal && k0 + kc > q0 + qr) || k0 + kc >= Sk))
          sv = -INFINITY;
        const float p = expf(sv - lse_s[qr]);
        ds_s[qr * (NK + 1) + kc] = round_to<T>(p * (dp[i][j] - delta_s[qr]));
      }
    }
    __syncthreads();
    // K tile -> k * sm_scale rounded to T, in place
    for (int i = tid; i < NK * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      k_s[r * kS + c] = round_to<T>(k_s[r * kS + c] * scale);
    }
    __syncthreads();
    mm_ab<D, NK>(acc, ds_s, k_s, ty, tx);
  }

  store_tile<T, D>(dq + q_off, (size_t)H * D, q_rows, acc, ty, tx);
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores (D in {64, 128})
//
// For bf16 inputs every product above runs as mma.sync.m16n8k16 (bf16
// operands, f32 accumulators; attention_common.cuh's fragment layout).  The
// TPU kernels' rounding points are exactly the operands' type here: q *
// sm_scale, p and dS are rounded to bf16 because that is what the tensor
// core takes, and every sum is f32.  Warp w owns 16 rows (queries in the
// forward and dQ, keys in dK/dV) of the block's 64.
// ---------------------------------------------------------------------------

// Forward, bf16: the design of flash_fwd_kernel, products on the tensor
// cores.  Each warp keeps its 16 query rows' running max, sum and 16 x D
// accumulator in registers; the K tile is read as B of Q K^T from its
// rows, the V tile transposed as B of P V.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Sk, int H, int Hk,
                     int causal, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [64][LD]
  bf16* k_s = q_s + kTile * LD;                     // [64][LD]
  bf16* vt_s = k_s + kTile * LD;                    // [D][kLdT]

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x;   // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int r0 = q0 + 16 * w + g;         // this thread's rows r0, r0 + 8

  load_bf16<D, true, false>(q_s, q + (((size_t)b * Sq + q0) * H + h) * D,
                            (size_t)H * D, min(kTile, Sq - q0), scale);
  const bf16* k_base = k + ((size_t)b * Sk * Hk + hk) * D;
  const bf16* v_base = v + ((size_t)b * Sk * Hk + hk) * D;

  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  const int n_kt = (Sk + kTile - 1) / kTile;
  const int kt_end = causal ? min(qt + 1, n_kt) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                 // the previous tile's products are done
    load_bf16<D, false, false>(k_s, k_base + (size_t)k0 * Hk * D,
                               (size_t)Hk * D, min(kTile, Sk - k0), 0.f);
    load_bf16<D, false, true>(vt_s, v_base + (size_t)k0 * Hk * D,
                              (size_t)Hk * D, min(kTile, Sk - k0), 0.f);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_abt<D, 8>(s, q_s, LD, 16 * w, k_s, LD, 0, g, t);
    if ((causal && kt == qt) || k0 + kTile > Sk) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          const int qp = r0 + (e >> 1) * 8;
          if ((causal && kp > qp) || kp >= Sk) s[n][e] = -INFINITY;
        }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      const float m_new = fmaxf(m[i], quad_max(mx));
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = expf(m[i] - m_use[i]);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m_use[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    uint32_t pa[4][4];
    to_a<4>(pa, s);                  // p rounded to bf16 for P V
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + quad_sum(sum[i]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    mma_pb<4, D / 8>(o, pa, vt_s, kLdT, 0, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r < Sq) {
      bf16* dst = out + (((size_t)b * Sq + r) * H + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack_bf16(o[n][2 * i] / l[i], o[n][2 * i + 1] / l[i]);
      if (t == 0) lse[(size_t)bh * Sq + r] = m[i] + logf(l[i]);
    }
  }
}

// dK/dV, bf16: the design of flash_bwd_dkdv_kernel, products on the
// tensor cores.  Warp w owns keys k0 + 16 w .. + 15 and accumulates their
// dK and dV rows over the group's heads and query tiles.  A query tile is
// walked in chunks of NQ queries (32 at D = 128, so that the two 16 x D
// accumulators and the chunk's score tiles fit the registers).  Q and dO
// sit in shared memory twice: by rows (B of K Q^T and V dO^T) and
// transposed (B of P^T dO and dS^T Q).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          int Sq, int Sk, int H, int Hk, int causal,
                          float scale) {
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

  const int kt = blockIdx.x;
  const int bhk = blockIdx.y;
  const int b = bhk / Hk, hk = bhk - b * Hk;
  const int G = H / Hk;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTile;
  const int kr0 = k0 + 16 * w + g;        // this thread's keys kr0, kr0 + 8

  const size_t kv_off = (((size_t)b * Sk + k0) * Hk + hk) * D;
  load_bf16<D, false, false>(k_s, k + kv_off, (size_t)Hk * D,
                             min(kTile, Sk - k0), 0.f);
  load_bf16<D, false, false>(v_s, v + kv_off, (size_t)Hk * D,
                             min(kTile, Sk - k0), 0.f);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_qt = (Sq + kTile - 1) / kTile;
  for (int gi = 0; gi < G; ++gi) {
    const int h = hk * G + gi;
    const size_t row = (size_t)b * H + h;
    for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      const int q_rows = min(kTile, Sq - q0);
      const size_t q_off = (((size_t)b * Sq + q0) * H + h) * D;
      __syncthreads();               // the previous tile's products are done
      load_bf16<D, true, false>(q_s, q + q_off, (size_t)H * D, q_rows, scale);
      load_bf16<D, true, true>(qt_s, q + q_off, (size_t)H * D, q_rows, scale);
      load_bf16<D, false, false>(do_s, dout + q_off, (size_t)H * D, q_rows,
                                 0.f);
      load_bf16<D, false, true>(dot_s, dout + q_off, (size_t)H * D, q_rows,
                                0.f);
      if (threadIdx.x < kTile) {
        const bool ok = threadIdx.x < q_rows;
        lse_s[threadIdx.x] = ok ? lse[row * Sq + q0 + threadIdx.x] : INFINITY;
        delta_s[threadIdx.x] = ok ? delta[row * Sq + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      const bool diag = causal && qt == kt;

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
            float s = st[n][e];
            if (diag && q0 + qc < kr0 + (e >> 1) * 8) s = -INFINITY;
            const float p = expf(s - lse_s[qc]);
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - delta_s[qc]);
          }
        uint32_t pa[KS][4], dsa[KS][4];
        to_a<KS>(pa, st);            // p rounded to bf16 for dV
        to_a<KS>(dsa, dpt);          // dS rounded to bf16 for dK
        mma_pb<KS, D / 8>(dv_acc, pa, dot_s, kLdT, c0, g, t);
        mma_pb<KS, D / 8>(dk_acc, dsa, qt_s, kLdT, c0, g, t);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = kr0 + 8 * i;
    if (r < Sk) {
      const size_t off = (((size_t)b * Sk + r) * Hk + hk) * D + 2 * t;
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

// dQ, bf16: the design of flash_bwd_dq_kernel, products on the tensor
// cores.  Warp w owns queries q0 + 16 w .. + 15; the K tile sits in
// shared memory by rows (B of Q K^T) and, scaled by sm_scale and rounded,
// transposed (B of dS Ks); V by rows (B of dO V^T).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Sq, int Sk, int H, int Hk,
                        int causal, float scale) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [64 queries][LD]
  bf16* do_s = q_s + kTile * LD;                    // [64 queries][LD]
  bf16* k_s = do_s + kTile * LD;                    // [64 keys][LD]
  bf16* v_s = k_s + kTile * LD;                     // [64 keys][LD]
  bf16* kst_s = v_s + kTile * LD;                   // [D][kLdT]

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x;   // longest causal rows first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile;
  const int r0 = q0 + 16 * w + g;         // this thread's rows r0, r0 + 8

  const size_t q_off = (((size_t)b * Sq + q0) * H + h) * D;
  load_bf16<D, true, false>(q_s, q + q_off, (size_t)H * D,
                            min(kTile, Sq - q0), scale);
  load_bf16<D, false, false>(do_s, dout + q_off, (size_t)H * D,
                             min(kTile, Sq - q0), 0.f);
  float lse_r[2], delta_r[2];             // padded rows: finite, unwritten
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    lse_r[i] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
    delta_r[i] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const bf16* k_base = k + ((size_t)b * Sk * Hk + hk) * D;
  const bf16* v_base = v + ((size_t)b * Sk * Hk + hk) * D;
  const int n_kt = (Sk + kTile - 1) / kTile;
  const int kt_end = causal ? min(qt + 1, n_kt) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * kTile;
    const int k_rows = min(kTile, Sk - k0);
    __syncthreads();                 // the previous tile's products are done
    load_bf16<D, false, false>(k_s, k_base + (size_t)k0 * Hk * D,
                               (size_t)Hk * D, k_rows, 0.f);
    load_bf16<D, true, true>(kst_s, k_base + (size_t)k0 * Hk * D,
                             (size_t)Hk * D, k_rows, scale);
    load_bf16<D, false, false>(v_s, v_base + (size_t)k0 * Hk * D,
                               (size_t)Hk * D, k_rows, 0.f);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, 8>(s, q_s, LD, 16 * w, k_s, LD, 0, g, t);
    mma_abt<D, 8>(dp, do_s, LD, 16 * w, v_s, LD, 0, g, t);
    const bool masked = (causal && kt == qt) || k0 + kTile > Sk;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + 8 * n + 2 * t + (e & 1);
        const int i = e >> 1;
        float sv = s[n][e];
        if (masked && ((causal && kp > r0 + 8 * i) || kp >= Sk))
          sv = -INFINITY;
        const float p = expf(sv - lse_r[i]);
        dp[n][e] = p * (dp[n][e] - delta_r[i]);
      }
    uint32_t dsa[4][4];
    to_a<4>(dsa, dp);                // dS rounded to bf16
    mma_pb<4, D / 8>(acc, dsa, kst_s, kLdT, 0, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r < Sq) {
      bf16* dst = dq + (((size_t)b * Sq + r) * H + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + 8 * n) =
            pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA cores at every other head dim (D a multiple of 128 past 256)
//
// The kernels above hold [64, D] f32 tiles and D / 16 accumulator columns
// a thread, which fits the card only up to D = 256.  These three keep their
// designs and rounding points but cut D into kDC-column chunks: every
// product over the head dim (Q K^T, dO V^T, and their transposes) walks
// the chunks, loading one chunk of each operand at a time and summing into
// the same f32 registers in column order; and each block owns one chunk of
// the output columns (grid z), so it recomputes its tile's scores once for
// each of the D / kDC chunks.  Shared memory is that of a D = kDC kernel,
// whatever D is.
// ---------------------------------------------------------------------------

constexpr int kDC = 64;              // head-dim columns of a chunk

// acc[i][j] += A . B^T over one chunk: mm_abt without the zeroing
template <int DC, int NB>
__device__ __forceinline__ void mm_abt_add(float (&acc)[4][NB / 16],
                                           const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           int ty, int tx) {
#pragma unroll 8
  for (int d = 0; d < DC; ++d) {
    float a[4], b[NB / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (DC + 1) + d];
#pragma unroll
    for (int j = 0; j < NB / 16; ++j) b[j] = B[(tx + 16 * j) * (DC + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[4][N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) x[i][j] = 0.f;
}

// Forward: flash_fwd_kernel's walk; block (query tile, b * H + h, chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         float* __restrict__ lse, int Sq, int Sk, int H,
                         int Hk, int D, int causal, float scale) {
  constexpr int NB = kTile, kS = kDC + 1;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [64, kDC] chunk of the query tile
  float* k_s = q_s + kTile * kS;     // [NB, kDC]
  float* v_s = k_s + NB * kS;        // [NB, kDC]: the block's columns
  float* p_s = v_s + NB * kS;        // [64, NB]

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x;   // longest causal rows first
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * kDC;        // the block's output columns
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;
  const int q_rows = min(kTile, Sq - q0);

  const T* q_base = q + (((size_t)b * Sq + q0) * H + h) * D;
  const T* k_base = k + ((size_t)b * Sk * Hk + hk) * D;
  const T* v_base = v + ((size_t)b * Sk * Hk + hk) * D;

  float acc[4][kDC / 16], m[4], l[4];
  zero(acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  const int n_kt = (Sk + NB - 1) / NB;
  const int kt_end = causal ? min((q0 + kTile - 1) / NB + 1, n_kt) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * NB;
    const T* k_tile = k_base + (size_t)k0 * Hk * D;
    float s[4][NB / 16];
    zero(s);
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();               // the previous chunk's products are done
      load_tile<T, kDC, kTile, true>(q_s, q_base + d0, (size_t)H * D, q_rows,
                                     scale);
      load_tile<T, kDC, NB>(k_s, k_tile + d0, (size_t)Hk * D, Sk - k0);
      __syncthreads();
      mm_abt_add<kDC, NB>(s, q_s, k_s, ty, tx);
    }
    load_tile<T, kDC, NB>(v_s, v_base + (size_t)k0 * Hk * D + c0,
                          (size_t)Hk * D, Sk - k0);
    if ((causal && k0 + NB - 1 > q0) || k0 + NB > Sk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NB / 16; ++j) {
          const int qp = q0 + ty + 16 * i, kp = k0 + tx + 16 * j;
          if ((causal && kp > qp) || kp >= Sk) s[i][j] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NB / 16; ++j) {
        const float p = expf(s[i][j] - m_use);
        sum += p;
        p_s[(ty + 16 * i) * (NB + 1) + tx + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_use);
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDC / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    mm_ab<kDC, NB>(acc, p_s, v_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < q_rows) {
#pragma unroll
      for (int j = 0; j < kDC / 16; ++j)
        out[(((size_t)b * Sq + q0 + r) * H + h) * D + c0 + tx + 16 * j] =
            from_f<T>(acc[i][j] / l[i]);
      if (tx == 0 && blockIdx.z == 0)
        lse[(size_t)bh * Sq + q0 + r] = m[i] + logf(l[i]);
    }
  }
}

// dK / dV: flash_bwd_dkdv_kernel's walk; block (key tile, b * Hk + hk,
// chunk of the dK and dV columns).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_chunked_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int Sq,
                              int Sk, int H, int Hk, int D, int causal,
                              float scale) {
  constexpr int NQ = kTile, kS = kDC + 1;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // [64 keys, kDC]
  float* v_s = k_s + kTile * kS;     // [64 keys, kDC]
  float* q_s = v_s + kTile * kS;     // [NQ queries, kDC], scaled
  float* do_s = q_s + NQ * kS;       // [NQ queries, kDC]
  float* pt_s = do_s + NQ * kS;      // [64 keys, NQ queries]: p
  float* dst_s = pt_s + kTile * (NQ + 1);  // dS
  float* lse_s = dst_s + kTile * (NQ + 1); // [NQ]
  float* delta_s = lse_s + NQ;             // [NQ]

  const int kt = blockIdx.x;
  const int bhk = blockIdx.y;
  const int c0 = blockIdx.z * kDC;
  const int b = bhk / Hk, hk = bhk - b * Hk;
  const int G = H / Hk;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kTile;
  const int k_rows = min(kTile, Sk - k0);
  const T* k_base = k + (((size_t)b * Sk + k0) * Hk + hk) * D;
  const T* v_base = v + (((size_t)b * Sk + k0) * Hk + hk) * D;

  float dk_acc[4][kDC / 16], dv_acc[4][kDC / 16];
  zero(dk_acc);
  zero(dv_acc);

  const int n_qt = (Sq + NQ - 1) / NQ;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t row = (size_t)b * H + h;
    for (int qt = causal ? k0 / NQ : 0; qt < n_qt; ++qt) {
      const int q0 = qt * NQ;
      const int q_rows = min(NQ, Sq - q0);
      const T* q_base = q + (((size_t)b * Sq + q0) * H + h) * D;
      const T* do_base = dout + (((size_t)b * Sq + q0) * H + h) * D;
      float st[4][NQ / 16], dpt[4][NQ / 16];
      zero(st);
      zero(dpt);
      for (int d0 = 0; d0 < D; d0 += kDC) {
        __syncthreads();             // the previous products are done
        if (d0 == 0 && tid < NQ) {
          const bool ok = tid < q_rows;
          lse_s[tid] = ok ? lse[row * Sq + q0 + tid] : INFINITY;
          delta_s[tid] = ok ? delta[row * Sq + q0 + tid] : 0.f;
        }
        load_tile<T, kDC, kTile>(k_s, k_base + d0, (size_t)Hk * D, k_rows);
        load_tile<T, kDC, kTile>(v_s, v_base + d0, (size_t)Hk * D, k_rows);
        load_tile<T, kDC, NQ, true>(q_s, q_base + d0, (size_t)H * D, q_rows,
                                    scale);
        load_tile<T, kDC, NQ>(do_s, do_base + d0, (size_t)H * D, q_rows);
        __syncthreads();
        mm_abt_add<kDC, NQ>(st, k_s, q_s, ty, tx);    // [keys, queries]
        mm_abt_add<kDC, NQ>(dpt, v_s, do_s, ty, tx);
      }
      const bool diag = causal && q0 < k0 + kTile - 1;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NQ / 16; ++j) {
          const int qc = tx + 16 * j;
          float s = st[i][j];
          if (diag && q0 + qc < k0 + ty + 16 * i) s = -INFINITY;
          const float p = expf(s - lse_s[qc]);
          const float ds = p * (dpt[i][j] - delta_s[qc]);
          pt_s[(ty + 16 * i) * (NQ + 1) + qc] = round_to<T>(p);
          dst_s[(ty + 16 * i) * (NQ + 1) + qc] = round_to<T>(ds);
        }
      __syncthreads();               // the score products are done
      load_tile<T, kDC, NQ, true>(q_s, q_base + c0, (size_t)H * D, q_rows,
                                  scale);
      load_tile<T, kDC, NQ>(do_s, do_base + c0, (size_t)H * D, q_rows);
      __syncthreads();
      mm_ab<kDC, NQ>(dv_acc, pt_s, do_s, ty, tx);
      mm_ab<kDC, NQ>(dk_acc, dst_s, q_s, ty, tx);
    }
  }

  const size_t off = (((size_t)b * Sk + k0) * Hk + hk) * D + c0;
  store_tile<T, kDC>(dk + off, (size_t)Hk * D, k_rows, dk_acc, ty, tx);
  store_tile<T, kDC>(dv + off, (size_t)Hk * D, k_rows, dv_acc, ty, tx);
}

// dQ: flash_bwd_dq_kernel's walk; block (query tile, b * H + h, chunk of
// the dQ columns).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int Sq, int Sk, int H,
                            int Hk, int D, int causal, float scale) {
  constexpr int NK = kTile, kS = kDC + 1;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [64 queries, kDC], scaled
  float* do_s = q_s + kTile * kS;    // [64 queries, kDC]
  float* k_s = do_s + kTile * kS;    // [NK keys, kDC]
  float* v_s = k_s + NK * kS;        // [NK keys, kDC]
  float* ds_s = v_s + NK * kS;       // [64 queries, NK keys]: dS
  float* lse_s = ds_s + kTile * (NK + 1);  // [64]
  float* delta_s = lse_s + kTile;          // [64]

  const int n_qt = (Sq + kTile - 1) / kTile;
  const int qt = n_qt - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int c0 = blockIdx.z * kDC;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kTile;
  const int q_rows = min(kTile, Sq - q0);

  const size_t q_off = (((size_t)b * Sq + q0) * H + h) * D;
  if (tid < kTile) {
    const bool ok = tid < q_rows;
    lse_s[tid] = ok ? lse[(size_t)bh * Sq + q0 + tid] : 0.f;
    delta_s[tid] = ok ? delta[(size_t)bh * Sq + q0 + tid] : 0.f;
  }

  float acc[4][kDC / 16];
  zero(acc);

  const T* k_base = k + ((size_t)b * Sk * Hk + hk) * D;
  const T* v_base = v + ((size_t)b * Sk * Hk + hk) * D;
  const int n_kt = (Sk + NK - 1) / NK;
  const int kt_end = causal ? min((q0 + kTile - 1) / NK + 1, n_kt) : n_kt;
  for (int kt = 0; kt < kt_end; ++kt) {
    const int k0 = kt * NK;
    const T* k_tile = k_base + (size_t)k0 * Hk * D;
    const T* v_tile = v_base + (size_t)k0 * Hk * D;
    float s[4][NK / 16], dp[4][NK / 16];
    zero(s);
    zero(dp);
    for (int d0 = 0; d0 < D; d0 += kDC) {
      __syncthreads();               // the previous products are done
      load_tile<T, kDC, kTile, true>(q_s, q + q_off + d0, (size_t)H * D,
                                     q_rows, scale);
      load_tile<T, kDC, kTile>(do_s, dout + q_off + d0, (size_t)H * D,
                               q_rows);
      load_tile<T, kDC, NK>(k_s, k_tile + d0, (size_t)Hk * D, Sk - k0);
      load_tile<T, kDC, NK>(v_s, v_tile + d0, (size_t)Hk * D, Sk - k0);
      __syncthreads();
      mm_abt_add<kDC, NK>(s, q_s, k_s, ty, tx);       // [queries, keys]
      mm_abt_add<kDC, NK>(dp, do_s, v_s, ty, tx);
    }
    const bool masked = (causal && k0 + NK - 1 > q0) || k0 + NK > Sk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NK / 16; ++j) {
        const int kc = tx + 16 * j;
        float sv = s[i][j];
        if (masked && ((causal && k0 + kc > q0 + qr) || k0 + kc >= Sk))
          sv = -INFINITY;
        const float p = expf(sv - lse_s[qr]);
        ds_s[qr * (NK + 1) + kc] = round_to<T>(p * (dp[i][j] - delta_s[qr]));
      }
    }
    __syncthreads();                 // the score products are done
    // the block's columns of k * sm_scale, rounded to T
    load_tile<T, kDC, NK, true>(k_s, k_tile + c0, (size_t)Hk * D, Sk - k0,
                                scale);
    __syncthreads();
    mm_ab<kDC, NK>(acc, ds_s, k_s, ty, tx);
  }

  store_tile<T, kDC>(dq + q_off + c0, (size_t)H * D, q_rows, acc, ty, tx);
}

// dynamic shared memory of each kernel, in bytes
template <int D, int NB>
constexpr size_t fwd_smem() {
  return ((size_t)(kTile + 2 * NB) * (D + 1) + (size_t)kTile * (NB + 1)) *
         sizeof(float);
}
template <int D, int NQ>
constexpr size_t dkdv_smem() {
  return ((size_t)(2 * kTile + 2 * NQ) * (D + 1) +
          2 * (size_t)kTile * (NQ + 1) + 2 * NQ) * sizeof(float);
}
template <int D, int NK>
constexpr size_t dq_smem() {
  return ((size_t)(2 * kTile + 2 * NK) * (D + 1) + (size_t)kTile * (NK + 1) +
          2 * kTile) * sizeof(float);
}
template <int D>
constexpr size_t fwd_mma_smem() {
  return (2 * (size_t)kTile * (D + 8) + (size_t)D * kLdT) * sizeof(bf16);
}
template <int D>
constexpr size_t dkdv_mma_smem() {
  return (4 * (size_t)kTile * (D + 8) + 2 * (size_t)D * kLdT) *
             sizeof(bf16) + 2 * kTile * sizeof(float);
}
template <int D>
constexpr size_t dq_mma_smem() {
  return (4 * (size_t)kTile * (D + 8) + (size_t)D * kLdT) * sizeof(bf16);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Sk, int H, int Hk, int causal,
               float scale, cudaStream_t stream) {
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  auto args = [&](auto kern, int threads, size_t smem) {
    return launch(kern, grid, threads, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(out),
                  static_cast<float*>(lse), Sq, Sk, H, Hk, causal, scale);
  };
  if constexpr (kMma<T, D>)
    return args(flash_fwd_mma_kernel<D>, kMmaThreads, fwd_mma_smem<D>());
  else
    return args(flash_fwd_kernel<T, D, walk<D>()>, kThreads,
                fwd_smem<D, walk<D>()>());
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int Sq, int Sk, int H, int Hk,
                int causal, float scale, cudaStream_t stream) {
  const dim3 grid((Sk + kTile - 1) / kTile, B * Hk);
  auto args = [&](auto kern, int threads, size_t smem) {
    return launch(kern, grid, threads, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dk),
                  static_cast<T*>(dv), Sq, Sk, H, Hk, causal, scale);
  };
  if constexpr (kMma<T, D>)
    return args(flash_bwd_dkdv_mma_kernel<D>, kMmaThreads,
                dkdv_mma_smem<D>());
  else
    return args(flash_bwd_dkdv_kernel<T, D, walk<D>()>, kThreads,
                dkdv_smem<D, walk<D>()>());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq,
              int Sk, int H, int Hk, int causal, float scale,
              cudaStream_t stream) {
  const dim3 grid((Sq + kTile - 1) / kTile, B * H);
  auto args = [&](auto kern, int threads, size_t smem) {
    return launch(kern, grid, threads, smem, stream,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dq), Sq,
                  Sk, H, Hk, causal, scale);
  };
  if constexpr (kMma<T, D>)
    return args(flash_bwd_dq_mma_kernel<D>, kMmaThreads, dq_mma_smem<D>());
  else
    return args(flash_bwd_dq_kernel<T, D, walk<D>()>, kThreads,
                dq_smem<D, walk<D>()>());
}

// dynamic shared memory of the chunked kernels, in bytes
constexpr size_t fwd_chunked_smem = fwd_smem<kDC, kTile>();
constexpr size_t dkdv_chunked_smem = dkdv_smem<kDC, kTile>();
constexpr size_t dq_chunked_smem = dq_smem<kDC, kTile>();

template <typename T>
int launch_fwd_chunked(const void* q, const void* k, const void* v,
                       void* out, void* lse, int B, int Sq, int Sk, int H,
                       int Hk, int causal, float scale, int D,
                       cudaStream_t stream) {
  const dim3 grid((Sq + kTile - 1) / kTile, B * H, D / kDC);
  return launch(flash_fwd_chunked_kernel<T>, grid, kThreads,
                fwd_chunked_smem, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk, H,
                Hk, D, causal, scale);
}

template <typename T>
int launch_dkdv_chunked(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int Sq, int Sk, int H,
                        int Hk, int causal, float scale, int D,
                        cudaStream_t stream) {
  const dim3 grid((Sk + kTile - 1) / kTile, B * Hk, D / kDC);
  return launch(flash_bwd_dkdv_chunked_kernel<T>, grid, kThreads,
                dkdv_chunked_smem, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dk),
                static_cast<T*>(dv), Sq, Sk, H, Hk, D, causal, scale);
}

template <typename T>
int launch_dq_chunked(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int Sq, int Sk, int H, int Hk,
                      int causal, float scale, int D, cudaStream_t stream) {
  const dim3 grid((Sq + kTile - 1) / kTile, B * H, D / kDC);
  return launch(flash_bwd_dq_chunked_kernel<T>, grid, kThreads,
                dq_chunked_smem, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<const T*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<T*>(dq), Sq, Sk,
                H, Hk, D, causal, scale);
}

}  // namespace

// C entries, bound with ctypes by paddle_tpu_torch/ops/flash_attention.py,
// which has already checked shapes, types, contiguity and alignment: D 64
// or a multiple of 128, H % Hk == 0, Sq == Sk under causal, Sq, Sk >= 1.
// D in {64, 128, 256} takes the kernels of its own D, every larger D the
// chunked ones.  dtype:
// 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError() after its
// launch (0 on success).

#define PADDLE_FA_DISPATCH(LAUNCH, ...)                                     \
  do {                                                                      \
    if (B * H == 0) return 0;                                               \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                     \
    if (dtype == 0 && D == 64) return LAUNCH<float, 64>(__VA_ARGS__, s);    \
    if (dtype == 0 && D == 128) return LAUNCH<float, 128>(__VA_ARGS__, s);  \
    if (dtype == 0 && D == 256) return LAUNCH<float, 256>(__VA_ARGS__, s);  \
    if (dtype == 1 && D == 64) return LAUNCH<bf16, 64>(__VA_ARGS__, s);     \
    if (dtype == 1 && D == 128) return LAUNCH<bf16, 128>(__VA_ARGS__, s);   \
    if (dtype == 1 && D == 256) return LAUNCH<bf16, 256>(__VA_ARGS__, s);   \
    if (D > 256 && D % 128 == 0) {                                          \
      if (dtype == 0) return LAUNCH##_chunked<float>(__VA_ARGS__, D, s);    \
      if (dtype == 1) return LAUNCH##_chunked<bf16>(__VA_ARGS__, D, s);     \
    }                                                                       \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

extern "C" int paddle_flash_attention_fwd(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* lse, int B, int Sq, int Sk,
                                          int H, int Hk, int D, int causal,
                                          int dtype, float scale,
                                          void* stream) {
  PADDLE_FA_DISPATCH(launch_fwd, q, k, v, out, lse, B, Sq, Sk, H, Hk, causal,
                     scale);
}

extern "C" int paddle_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Sk, int H, int Hk, int D, int causal, int dtype, float scale,
    void* stream) {
  PADDLE_FA_DISPATCH(launch_dkdv, q, k, v, dout, lse, delta, dk, dv, B, Sq,
                     Sk, H, Hk, causal, scale);
}

extern "C" int paddle_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int Sq, int Sk,
    int H, int Hk, int D, int causal, int dtype, float scale, void* stream) {
  PADDLE_FA_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, B, Sq, Sk, H,
                     Hk, causal, scale);
}
