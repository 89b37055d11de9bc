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
// bfloat16 at D in {64, 128} the three *_wgmma_kernel, wgmma fed by TMA
// (warp-specialised); every D past 256 the chunked CUDA-core kernels.  The
// device code they share with the varlen kernels is in
// attention_common.cuh (the wgmma forward's walk among it), the Hopper
// helpers (wgmma, mbarriers, TMA, tensor maps) in hopper.cuh.
//
// Rounding points, as in the TPU kernels: q * sm_scale is rounded to the
// input type; the forward rounds p to it before the PV product while the
// row sum l takes the unrounded p, and writes lse = m + log(l) in the
// scaled domain; the dK/dV kernel rounds p to it for dV and dS = p * (dP -
// delta) for dK; the dQ kernel rounds dS and uses k * sm_scale rounded.
//
// Shared design.  The forward and dQ own query rows (64 a block on the
// CUDA cores, 128 in the wgmma kernels, two warpgroups) and walk the K/V
// tiles of their kv head up to the diagonal under causal; dK/dV walks, for
// its 64 keys, the G query heads of its group and their query tiles from
// the diagonal on, so the GQA group sum happens inside the block.  The
// CUDA-core kernels walk tiles of 64 rows, 32 at D = 256.  The kernels
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
// near half the f32 FMA rate).  The bf16 kernels keep the next tiles'
// copies in flight behind this tile's products (the ring) and overlap one
// tile's exponentials with another's products (the forward: the next
// tile's Q K^T and this one's P V; the backward: the next item's score
// products); PERF.md has their rates.  At D 128 the dK/dV kernel's
// accumulators fill half the registers and ptxas spills.

#include "attention_common.cuh"
#include "hopper.cuh"

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
// bf16 on Hopper (D in {64, 128}): the forward and the backward pair on
// wgmma fed by TMA, warp-specialised (attention_common.cuh's layout: a
// producer warp filling an mbarrier ring of 64-row boxes from 3D tensor
// maps over [B, S, heads * D], two consumer warpgroups)
//
// Rounding points (the plain versions'): q * sm_scale and k * sm_scale
// rounded to bf16, p rounded for P V and dV, dS for dK and dQ, every sum
// f32.  At D 64, sm_scale = 2^-3, so bf16(q * sm_scale) = q * 2^-3 exactly
// (outside bf16's subnormal range) and a sum of products with it is 2^-3
// times the same sum with q, bit for bit in any fixed order: the kernels
// read q and k as they are and scale the f32 scores, dK and dQ instead
// (tests/test_torch_flash_attention.py holds the identity).  At D 128
// (sm_scale 2^-3.5) that is not exact, and the consumers rewrite the
// landed tile to bf16(x * sm_scale) in shared memory before its products.
// ---------------------------------------------------------------------------

// Forward.  Replaces paddle_tpu/ops/pallas/flash_attention.py ::
// _fwd_kernel.  One block per (b * H + h, 128 queries), the heaviest
// causal rows first; attention_common.cuh's fwd_walk over the K/V tiles of
// kv head h / G up to the block's diagonal (all of them without causal).
// A warpgroup masks only its diagonal tile (causal) and the tile across
// Sk, and only waits for the tile past its diagonal.  Rows past Sq read zeros and
// are never written.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ out, float* __restrict__ lse,
                       int Sq, int Sk, int H, int Hk, int causal,
                       float scale) {
  using L = FwdSmem<D, 0>;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  unsigned char* ring = smem + L::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBytes);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;
  const int n_kt = (Sk + 63) / 64;
  const int kt_end = causal ? min(q0 / 64 + 2, n_kt) : n_kt;
  const int wg = uniform(threadIdx.x >> 7);

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
    tma_tile<D>(smem, &tq, h * D, q0, b, q_full);
    tma_tile<D>(smem + L::kTile, &tq, h * D, q0 + 64, b, q_full);
    for (int kt = 0; kt < kt_end; ++kt) {
      const int s = kt % L::kStages;
      mbar_wait(empty + s, ((kt / L::kStages) & 1) ^ 1);
      unsigned char* st = ring + s * L::kStage;
      mbar_expect(full + s, 2 * L::kTile);
      tma_tile<D>(st, &tk, hk * D, kt * 64, b, full + s);
      tma_tile<D>(st + L::kTile, &tv, hk * D, kt * 64, b, full + s);
    }
    return;
  }

  // ---- consumers ----
  regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, t = lane & 3;
  const int qw = q0 + 64 * wg;                  // this warpgroup's rows
  const int r0 = qw + 16 * (tid >> 5) + (lane >> 2);   // and r0 + 8
  unsigned char* q_s = smem + wg * L::kTile;
  mbar_wait(q_full, 0);
  if constexpr (D != 64) {
    scale_tile<D>(q_s, q_s, scale, tid, 128);   // Q -> bf16(q * sm_scale)
    fence_async_smem();
    named_sync(2 + wg, 128);
  }
  // log2-domain scores: raw q . k times 2^-3 log2 e at D 64, the scaled
  // q's times log2 e at D 128
  const float s_mul = D == 64 ? scale * kLog2e : kLog2e;
  // this warpgroup's tiles: up to its diagonal (causal), none past Sq
  const int diag = qw / 64;
  const int a1 = qw < Sq ? (causal ? min(diag + 1, kt_end) : kt_end) : 0;
  auto masked = [&](int kt, const unsigned char*) {
    return (causal && kt == diag) || kt * 64 + 64 > Sk;
  };
  auto visible = [&](int kt, const unsigned char*, int col, int i) {
    const int key = kt * 64 + col;
    return key < Sk && (!causal || key <= r0 + 8 * i);
  };
  float o[D / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  fwd_walk<D, L>(ring, full, empty, 0, kt_end, 0, a1, sw128_desc(q_s),
                 s_mul, t, masked, visible, o, m, l);
  fwd_store<D>(out + ((size_t)b * Sq * H + h) * D, (size_t)H * D,
               lse + (size_t)bh * Sq, r0, Sq, o, m, l, t);
}

// dK/dV.  Replaces paddle_tpu/ops/pallas/flash_attention.py ::
// _bwd_dkdv_kernel and the XLA group sum after it.  One block per (b * Hk +
// hk, 64-key tile); its work is the group's G heads x the query tiles from
// the diagonal on, G (n_qt - kt) items of 64 queries, dealt out in turn to
// the two consumer warpgroups, which each hold dK and dV for all 64 keys
// in f32 and add the two halves in shared memory at the end (the GQA sum
// in the block, no partials, no atomics; per-head partials and a group
// sum, the JAX package's grid, measured slower at the trainer's shape:
// tools/perf/torch_flash_bwd_ab.py).  An item: S^T = K Q^T and dP^T =
// V dO^T (K and V from shared memory, both K-major), p = exp(S^T - lse)
// and dS = p (dP^T - delta) per query column, then dV += P^T dO and dK +=
// dS^T Q with P^T and dS^T as register operands and dO, Q read N-major.
// The ring stage is the item's Q and dO tiles (TMA) and its 64 lse (times
// log2 e; +inf past Sq, so padded queries get p = 0) and delta values,
// which the producer warp's lanes store.  The grid runs key tile 0 of
// every head first: under causal it has the most items.
template <int D>
struct DkdvSmem {
  static constexpr int kStages = D == 64 ? 6 : 4;
  // queries a step: a D 128 step of 64 spills the scores
  static constexpr int kNq = D == 64 ? 64 : 32;
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kStage = 2 * kTile + 1024;      // Q, dO, lse, delta
  static constexpr int kRing = 2 * kTile;              // after K and V
  static constexpr int kBytes = kRing + kStages * kStage;
  static constexpr size_t kDynamic = kBytes + 8 * (2 * kStages + 1) + 1024;
};

// What a dK/dV consumer warpgroup's steps read besides its registers.
struct DkdvCtx {
  unsigned char* ring;
  uint64_t *full, *empty;
  uint64_t k_desc, v_desc;
  float scale, s_mul;
  int nq, qt0, kt, causal, kr, t, tid, wg;
};

// Step h of item i: S^T = K Q^T and dP^T = V dO^T over the item's
// queries kNq h .. kNq h + kNq - 1 into (sa, dpa), committed.  Step 0 waits
// for the item's stage (and at D 128 rescales its Q tile).
template <int D>
__device__ __forceinline__ void dkdv_scores(
    const DkdvCtx& c, int i, int h, float (&sa)[DkdvSmem<D>::kNq / 2],
    float (&dpa)[DkdvSmem<D>::kNq / 2]) {
  using L = DkdvSmem<D>;
  const int s = i % L::kStages;
  unsigned char* st = c.ring + s * L::kStage;
  if (h == 0) {
    mbar_wait(c.full + s, (i / L::kStages) & 1);
    if constexpr (D != 64) {
      scale_tile<D>(st, st, c.scale, c.tid, 128);  // Q -> bf16(q * sm_scale)
      fence_async_smem();
      named_sync(2 + c.wg, 128);
    }
  }
  const uint64_t q_desc = sw128_desc(st + L::kNq * h * 128);
  const uint64_t do_desc = sw128_desc(st + L::kTile + L::kNq * h * 128);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<L::kNq>(sa, c.k_desc + (kmajor_step(kk) >> 4),
                     q_desc + (kmajor_step(kk) >> 4), kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<L::kNq>(dpa, c.v_desc + (kmajor_step(kk) >> 4),
                     do_desc + (kmajor_step(kk) >> 4), kk);
  wgmma_commit();
}

// p and dS of step h of item i from its landed scores, then dV += P^T dO
// and dK += dS^T Q over the step's queries, committed
template <int D>
__device__ __forceinline__ void dkdv_products(
    const DkdvCtx& c, int i, int h, float (&sa)[DkdvSmem<D>::kNq / 2],
    float (&dpa)[DkdvSmem<D>::kNq / 2],
    uint32_t (&pa)[DkdvSmem<D>::kNq / 16][4],
    uint32_t (&da)[DkdvSmem<D>::kNq / 16][4], float (&dk)[D / 2],
    float (&dv)[D / 2]) {
  using L = DkdvSmem<D>;
  constexpr int kNq = L::kNq;
  unsigned char* st = c.ring + (i % L::kStages) * L::kStage;
  const float* stats =
      reinterpret_cast<const float*>(st + 2 * L::kTile) + kNq * h;
  // column j of the step is query q0 + kNq h + j; under causal the
  // diagonal item (q0 == k0) drops the queries before each key
  const bool diag = c.causal && c.qt0 + i % c.nq == c.kt;
#pragma unroll
  for (int j = 0; j < kNq / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(stats + 8 * j + 2 * c.t);
    const float2 dl =
        *reinterpret_cast<const float2*>(stats + 64 + 8 * j + 2 * c.t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = kNq * h + 8 * j + 2 * c.t + (e & 1);
      float p = ex2(sa[4 * j + e] * c.s_mul - ((e & 1) ? l2.y : l2.x));
      if (diag && col < c.kr + 8 * (e >> 1)) p = 0.f;
      sa[4 * j + e] = p;
      dpa[4 * j + e] = p * (dpa[4 * j + e] - ((e & 1) ? dl.y : dl.x));
    }
  }
  acc_to_a(pa, sa);                          // p rounded to bf16 for dV
  acc_to_a(da, dpa);                         // dS rounded to bf16 for dK
  const uint64_t do_mn = sw128_desc_mn(st + L::kTile + kNq * h * 128, 8192);
  const uint64_t q_mn = sw128_desc_mn(st + kNq * h * 128, 8192);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kNq / 16; ++kk) {
    wgmma_rs_nd<D>(dv, pa[kk], do_mn + (nmajor_step(kk) >> 4));
    wgmma_rs_nd<D>(dk, da[kk], q_mn + (nmajor_step(kk) >> 4));
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            int Sq, int Sk, int H, int Hk, int causal,
                            float scale) {
  using L = DkdvSmem<D>;
  constexpr bool kFold = D == 64;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + L::kTile;
  unsigned char* ring = smem + L::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBytes);
  uint64_t* empty = full + L::kStages;
  uint64_t* kv_full = empty + L::kStages;

  const int bhk = blockIdx.x, kt = blockIdx.y;
  const int b = bhk / Hk, hk = bhk - b * Hk;
  const int G = H / Hk;
  const int k0 = kt * 64;
  const int qt0 = causal ? kt : 0;          // causal: Sq == Sk
  const int nq = (Sq + 63) / 64 - qt0;      // query tiles a head
  const int n_items = G * nq;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 32);              // the producer warp's lanes
      mbar_init(empty + s, 128);            // the consuming warpgroup
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    regs_dec<kProducerRegs>();
    if (threadIdx.x >= 288) return;         // its first warp only
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect(kv_full, 2 * L::kTile);
      tma_tile<D>(k_s, &tk, hk * D, k0, b, kv_full);
      tma_tile<D>(v_s, &tv, hk * D, k0, b, kv_full);
    }
    for (int i = 0; i < n_items; ++i) {
      const int s = i % L::kStages;
      mbar_wait(empty + s, ((i / L::kStages) & 1) ^ 1);
      const int gi = i / nq;
      const int h = hk * G + gi, q0 = (qt0 + i - gi * nq) * 64;
      unsigned char* st = ring + s * L::kStage;
      float* stats = reinterpret_cast<float*>(st + 2 * L::kTile);
      const size_t row = ((size_t)b * H + h) * Sq;
      for (int r = lane; r < 64; r += 32) {
        const bool ok = q0 + r < Sq;
        stats[r] = ok ? lse[row + q0 + r] * kLog2e : INFINITY;
        stats[64 + r] = ok ? delta[row + q0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect(full + s, 2 * L::kTile);
        tma_tile<D>(st, &tq, h * D, q0, b, full + s);
        tma_tile<D>(st + L::kTile, &tdo, h * D, q0, b, full + s);
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // ---- consumers ----
  regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, g8 = lane >> 2, t = lane & 3;
  const int kr = 16 * (tid >> 5) + g8;      // this thread's keys kr, kr + 8
  // scores: raw q . k times 2^-3 log2 e at D 64, the scaled q's times
  // log2 e at D 128
  const float s_mul = kFold ? scale * kLog2e : kLog2e;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;
  constexpr int kNq = L::kNq, kSteps = 64 / kNq;
  uint32_t pa[kNq / 16][4] = {}, da[kNq / 16][4] = {};   // P^T, dS^T (bf16)
  const DkdvCtx c{ring, full, empty, sw128_desc(k_s), sw128_desc(v_s),
                  scale, s_mul, nq, qt0, kt, causal, kr, t, tid, wg};
  float sa[kNq / 2] = {}, dpa[kNq / 2] = {};
  mbar_wait(kv_full, 0);
  if constexpr (D == 64) {
    // An item's dV and dK products stay in flight behind the next item's
    // score products; its stage is released at the next wait.
    int pending = -1;
    if (wg < n_items) dkdv_scores<D>(c, wg, 0, sa, dpa);
    for (int i = wg; i < n_items; i += 2) {
      wgmma_wait<0>();
      keep(sa);
      keep(dpa);
      keep_frags(pa);
      keep_frags(da);
      keep(dk_acc);
      keep(dv_acc);
      if (pending >= 0) mbar_arrive(empty + pending);
      dkdv_products<D>(c, i, 0, sa, dpa, pa, da, dk_acc, dv_acc);
      pending = i % L::kStages;
      if (i + 2 < n_items) dkdv_scores<D>(c, i + 2, 0, sa, dpa);
    }
    wgmma_wait<0>();
    keep_frags(pa);
    keep_frags(da);
    keep(dk_acc);
    keep(dv_acc);
    if (pending >= 0) mbar_arrive(empty + pending);
  } else {
    // D 128: one step at a time, nothing in flight across steps (the dK
    // and dV accumulators fill half the registers)
    for (int i = wg; i < n_items; i += 2) {
#pragma unroll 1
      for (int h = 0; h < kSteps; ++h) {
        dkdv_scores<D>(c, i, h, sa, dpa);
        wgmma_wait<0>();
        keep(sa);
        keep(dpa);
        dkdv_products<D>(c, i, h, sa, dpa, pa, da, dk_acc, dv_acc);
        wgmma_wait<0>();
        keep_frags(pa);
        keep_frags(da);
        keep(dk_acc);
        keep(dv_acc);
      }
      mbar_arrive(empty + i % L::kStages);
    }
  }

  // The two halves meet in the (now idle) ring: warpgroup 0 finishes dV,
  // warpgroup 1 dK, each adding the other's partial element by element
  // (thread tid of both holds the same elements).
  named_sync(1, 256);
  float* xch = reinterpret_cast<float*>(ring);
  float* mine = xch + wg * (D / 2) * 128;
  const float* theirs = xch + (1 - wg) * (D / 2) * 128;
  const size_t off = (((size_t)b * Sk + k0) * Hk + hk) * D;
  if (wg == 0) {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) mine[e * 128 + tid] = dk_acc[e];
    named_sync(1, 256);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dv_acc[e] += theirs[e * 128 + tid];
    store_rows<D>(dv + off, (size_t)Hk * D, kr, Sk - k0, dv_acc, 1.f, t);
  } else {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) mine[e * 128 + tid] = dv_acc[e];
    named_sync(1, 256);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk_acc[e] += theirs[e * 128 + tid];
    store_rows<D>(dk + off, (size_t)Hk * D, kr, Sk - k0, dk_acc,
                  kFold ? scale : 1.f, t);
  }
}

// dQ.  Replaces paddle_tpu/ops/pallas/flash_attention.py :: _bwd_dq_kernel.
// One block per (b * H + h, 128 queries), heaviest causal rows first;
// consumer warpgroup w owns queries q0 + 64 w .. + 63, whose Q and dO tiles
// land once, and both walk the K/V tiles of kv head h / G up to their
// diagonal through the ring: S = Q K^T and dP = dO V^T (both K-major), p
// and dS, then dQ += dS Ks with dS a register operand and the key tile read
// N-major.  At D 128 the two warpgroups first write Ks = bf16(k * sm_scale)
// beside K in the stage, half each; at D 64 Ks is K and dQ is scaled at
// the end.
template <int D>
struct DqSmem {
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kTile = 64 * D * 2;
  static constexpr int kStage = (D == 64 ? 2 : 3) * kTile;   // K, V (, Ks)
  static constexpr int kRing = 4 * kTile;                     // Q, dO x 2
  static constexpr int kBytes = kRing + kStages * kStage;
  static constexpr size_t kDynamic = kBytes + 8 * (2 * kStages + 1) + 1024;
};

// What a dQ consumer warpgroup's steps read besides its registers.
struct DqCtx {
  unsigned char* ring;
  uint64_t *full, *empty;
  uint64_t q_desc, do_desc;
  float scale, s_mul, lse2[2], dl[2];
  int causal, Sk, qw, r0, t;
};

template <int D>
__device__ __forceinline__ unsigned char* dq_stage(const DqCtx& c, int kt) {
  return c.ring + (kt % DqSmem<D>::kStages) * DqSmem<D>::kStage;
}
// the key tile dQ reads: Ks = bf16(k * sm_scale), or K itself at D 64
template <int D>
__device__ __forceinline__ unsigned char* dq_ks(const DqCtx& c, int kt) {
  return dq_stage<D>(c, kt) + (D == 64 ? 0 : 2 * DqSmem<D>::kTile);
}
// Wait for tile kt; at D 128 both warpgroups then write its Ks (half
// each).  Every warpgroup takes every tile.
template <int D>
__device__ __forceinline__ unsigned char* dq_tile(const DqCtx& c, int kt) {
  using L = DqSmem<D>;
  mbar_wait(c.full + kt % L::kStages, (kt / L::kStages) & 1);
  unsigned char* st = dq_stage<D>(c, kt);
  if constexpr (D != 64) {
    scale_tile<D>(dq_ks<D>(c, kt), st, c.scale, threadIdx.x, 256);
    fence_async_smem();
    named_sync(1, 256);
  }
  return st;
}

// tile kt, then S = Q K^T and dP = dO V^T into (sa, dpa), committed
template <int D>
__device__ __forceinline__ void dq_scores(const DqCtx& c, int kt,
                                          float (&sa)[32], float (&dpa)[32]) {
  unsigned char* st = dq_tile<D>(c, kt);
  const uint64_t k_desc = sw128_desc(st);
  const uint64_t v_desc = sw128_desc(st + DqSmem<D>::kTile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(sa, c.q_desc + (kmajor_step(kk) >> 4),
                 k_desc + (kmajor_step(kk) >> 4), kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_n64(dpa, c.do_desc + (kmajor_step(kk) >> 4),
                 v_desc + (kmajor_step(kk) >> 4), kk);
  wgmma_commit();
}

// dS of tile kt from its landed scores, then dQ += dS Ks, committed
template <int D>
__device__ __forceinline__ void dq_product(const DqCtx& c, int kt,
                                           float (&sa)[32], float (&dpa)[32],
                                           uint32_t (&da)[4][4],
                                           float (&acc)[D / 2]) {
  // column j is key kt * 64 + j: masked past the diagonal and past Sk
  const int k0 = kt * 64;
  const bool edge = (c.causal && k0 + 63 > c.qw) || k0 + 64 > c.Sk;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * j + 2 * c.t + (e & 1);
      const int i = e >> 1;
      float p = ex2(sa[4 * j + e] * c.s_mul - c.lse2[i]);
      if (edge && ((c.causal && key > c.r0 + 8 * i) || key >= c.Sk)) p = 0.f;
      dpa[4 * j + e] = p * (dpa[4 * j + e] - c.dl[i]);
    }
  acc_to_a(da, dpa);                          // dS rounded to bf16
  const uint64_t ks_mn = sw128_desc_mn(dq_ks<D>(c, kt), 8192);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_nd<D>(acc, da[kk], ks_mn + (nmajor_step(kk) >> 4));
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, int Sq, int Sk, int H,
                          int Hk, int causal, float scale) {
  using L = DqSmem<D>;
  constexpr bool kFold = D == 64;
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  unsigned char* smem = smem_wg + ((1024 - (smem_u32(smem_wg) & 1023)) & 1023);
  unsigned char* ring = smem + L::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBytes);
  uint64_t* empty = full + L::kStages;
  uint64_t* qdo_full = empty + L::kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;
  const int n_kt = (Sk + 63) / 64;
  const int kt_end = causal ? min(q0 / 64 + 2, n_kt) : n_kt;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 256);            // both consumers
    }
    mbar_init(qdo_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    regs_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    mbar_expect(qdo_full, 4 * L::kTile);
    for (int w = 0; w < 2; ++w) {
      tma_tile<D>(smem + 2 * w * L::kTile, &tq, h * D, q0 + 64 * w, b,
                  qdo_full);
      tma_tile<D>(smem + (2 * w + 1) * L::kTile, &tdo, h * D, q0 + 64 * w,
                  b, qdo_full);
    }
    for (int kt = 0; kt < kt_end; ++kt) {
      const int s = kt % L::kStages;
      mbar_wait(empty + s, ((kt / L::kStages) & 1) ^ 1);
      unsigned char* st = ring + s * L::kStage;
      mbar_expect(full + s, 2 * L::kTile);
      tma_tile<D>(st, &tk, hk * D, kt * 64, b, full + s);
      tma_tile<D>(st + L::kTile, &tv, hk * D, kt * 64, b, full + s);
    }
    return;
  }

  // ---- consumers ----
  regs_inc<kConsumerRegs>();
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31, g8 = lane >> 2, t = lane & 3;
  const int qw = q0 + 64 * wg;                  // this warpgroup's rows
  const int r0 = qw + 16 * (tid >> 5) + g8;     // this thread's r0, r0 + 8
  const float s_mul = kFold ? scale * kLog2e : kLog2e;
  float lse2[2], dl[2];                         // padded rows: finite
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    lse2[i] = r < Sq ? lse[(size_t)bh * Sq + r] * kLog2e : 0.f;
    dl[i] = r < Sq ? delta[(size_t)bh * Sq + r] : 0.f;
  }
  // the key tiles this warpgroup needs
  const int my_end = causal ? min(qw / 64 + 1, kt_end) : kt_end;

  unsigned char* q_s = smem + 2 * wg * L::kTile;
  unsigned char* do_s = q_s + L::kTile;
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  uint32_t da[4][4] = {};                       // dS, bf16 A operands
  mbar_wait(qdo_full, 0);
  if constexpr (!kFold) {
    scale_tile<D>(q_s, q_s, scale, tid, 128);   // Q -> bf16(q * sm_scale)
    fence_async_smem();
    named_sync(2 + wg, 128);
  }
  const DqCtx c{ring, full, empty, sw128_desc(q_s), sw128_desc(do_s), scale,
                s_mul, {lse2[0], lse2[1]}, {dl[0], dl[1]}, causal, Sk, qw,
                r0, t};
  // The tiles this warpgroup needs come first (every key past my_end is
  // masked for all its rows; none when its rows start past Sq).  Tile
  // kt's dQ product stays in flight behind tile kt + 1's score products;
  // tile kt's stage is released at the wait for both.  Then the tiles it
  // does not need are only waited for (and at D 128 rescaled) and released.
  const int n_act = qw < Sq ? my_end : 0;
  float sa[32] = {}, dpa[32] = {};
  if (n_act > 0) dq_scores<D>(c, 0, sa, dpa);
  for (int kt = 0; kt < n_act; ++kt) {
    wgmma_wait<0>();
    keep(sa);
    keep(dpa);
    keep_frags(da);
    keep(acc);
    if (kt > 0) mbar_arrive(empty + (kt - 1) % L::kStages);
    dq_product<D>(c, kt, sa, dpa, da, acc);
    if (kt + 1 < n_act) dq_scores<D>(c, kt + 1, sa, dpa);
  }
  wgmma_wait<0>();
  keep_frags(da);
  keep(acc);
  if (n_act > 0) mbar_arrive(empty + (n_act - 1) % L::kStages);
  for (int kt = n_act; kt < kt_end; ++kt) {
    dq_tile<D>(c, kt);
    mbar_arrive(empty + kt % L::kStages);
  }

  store_rows<D>(dq + (((size_t)b * Sq + qw) * H + h) * D, (size_t)H * D,
                r0 - qw, Sq - qw, acc, kFold ? scale : 1.f, t);
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
// the four tensor maps of a wgmma backward kernel, or false
bool bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k,
              const void* v, const void* dout, int B, int Sq, int Sk, int H,
              int Hk, int D) {
  return head_map(&m[0], q, B, Sq, H, D) && head_map(&m[1], k, B, Sk, Hk, D)
         && head_map(&m[2], v, B, Sk, Hk, D) &&
         head_map(&m[3], dout, B, Sq, H, D);
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int Sq, int Sk, int H, int Hk, int causal,
               float scale, cudaStream_t stream) {
  if constexpr (kMma<T, D>) {
    CUtensorMap m[3];
    if (!head_map(&m[0], q, B, Sq, H, D) || !head_map(&m[1], k, B, Sk, Hk, D)
        || !head_map(&m[2], v, B, Sk, Hk, D))
      return (int)cudaErrorInvalidValue;
    // the last (longest causal) 128 queries of every head first
    return launch(flash_fwd_wgmma_kernel<D>, dim3(B * H, (Sq + 127) / 128),
                  kWgThreads, FwdSmem<D, 0>::kDynamic, stream, m[0], m[1],
                  m[2], static_cast<bf16*>(out), static_cast<float*>(lse),
                  Sq, Sk, H, Hk, causal, scale);
  } else {
    return launch(flash_fwd_kernel<T, D, walk<D>()>,
                  dim3((Sq + kTile - 1) / kTile, B * H), kThreads,
                  fwd_smem<D, walk<D>()>(), stream, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<T*>(out), static_cast<float*>(lse), Sq, Sk, H,
                  Hk, causal, scale);
  }
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, int Sq, int Sk, int H, int Hk,
                int causal, float scale, cudaStream_t stream) {
  if constexpr (kMma<T, D>) {
    CUtensorMap m[4];
    if (!bwd_maps(m, q, k, v, dout, B, Sq, Sk, H, Hk, D))
      return (int)cudaErrorInvalidValue;
    // key tile 0 of every kv head first (x fastest)
    return launch(flash_bwd_dkdv_wgmma_kernel<D>,
                  dim3(B * Hk, (Sk + kTile - 1) / kTile), kWgThreads,
                  DkdvSmem<D>::kDynamic, stream, m[0], m[1], m[2], m[3],
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<bf16*>(dk),
                  static_cast<bf16*>(dv), Sq, Sk, H, Hk, causal, scale);
  } else {
    return launch(flash_bwd_dkdv_kernel<T, D, walk<D>()>,
                  dim3((Sk + kTile - 1) / kTile, B * Hk), kThreads,
                  dkdv_smem<D, walk<D>()>(), stream, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dk),
                  static_cast<T*>(dv), Sq, Sk, H, Hk, causal, scale);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq,
              int Sk, int H, int Hk, int causal, float scale,
              cudaStream_t stream) {
  if constexpr (kMma<T, D>) {
    CUtensorMap m[4];
    if (!bwd_maps(m, q, k, v, dout, B, Sq, Sk, H, Hk, D))
      return (int)cudaErrorInvalidValue;
    // the last (longest causal) 128 queries of every head first
    return launch(flash_bwd_dq_wgmma_kernel<D>,
                  dim3(B * H, (Sq + 127) / 128), kWgThreads,
                  DqSmem<D>::kDynamic, stream, m[0], m[1], m[2], m[3],
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<bf16*>(dq),
                  Sq, Sk, H, Hk, causal, scale);
  } else {
    return launch(flash_bwd_dq_kernel<T, D, walk<D>()>,
                  dim3((Sq + kTile - 1) / kTile, B * H), kThreads,
                  dq_smem<D, walk<D>()>(), stream, static_cast<const T*>(q),
                  static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(dout), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dq), Sq,
                  Sk, H, Hk, causal, scale);
  }
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
