// Fused dequant matmul for Hopper (sm_90a), written by hand, on the tensor
// cores.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/quant_matmul.py ::
// _qmm_kernel (launched by matmul).  What it computes, in f32:
//
//   out[m, n] = sum_k x[m, k] * (w[k, n] * scale(k, n))
//
// with x [M, K] f32 or bf16 and w a quantized pool in the JAX package's
// layout: int8 q [K, N] with per-column scales s[N], or int4 q [K/2, N]
// whose packed row r holds K-row 2r in its low nibble and 2r + 1 in its
// high nibble (signed), with per-128-row-group scales s[ceil(K/128), N].
// No dequantized weight ever exists in device memory or shared memory.
//
// Numbers.  A weight code is an integer of at most 8 bits, which bf16
// holds exactly, and the scales are applied after the sums, so the tensor
// cores see the codes themselves: mma.sync.m16n8k16 with bf16 operands and
// f32 accumulators.  bf16 x goes in as it is, so every product x * q is
// exact.  int8: out = s[n] * sum_k x q, the scale applied once in the
// epilogue.  int4: one 128-row scale group is one ring stage; a partial
// accumulator sums the group's eight k16 steps, then acc += s[g, n] *
// partial.  f32 x is split exactly into three bf16 terms, h + m + l = x
// (h the top 8 significant bits by truncation, m the next 8 of x - h, l
// the rest; truncation, not rounding, so +-FLT_MAX does not round to inf;
// exact for |x| >= 2^-110), and three products go into a stage partial,
// which is added to the sum (the tensor cores' f32 accumulation truncates
// a small product against a large sum, so the m and l products are summed
// against 128 K-rows at a time, not K).  The result differs from the plain
// version's x @ (q * s) only by f32 rounding order; TF32 is never used.
//
// Two kernels share the byte tricks, the ring of stages and the split-K
// sum.
//
// Decode, and f32 x (qmm_kernel, mma.sync.m16n8k16).  A block of 4 warps
// owns a [BM, 128] output tile and walks its K range in stages of 128
// K-rows.  Each stage holds the x tile [BM, 128] in x's own type and the
// raw weight bytes [128 or 64 rows, 128 columns] (plus, for int4, the
// group's 128 scales), copied with 16-byte cp.async.cg into a ring of 3 or
// 4 stages, so the loads of the next stages are in flight while the tensor
// cores work on this one.  Warp wn computes BM rows by 32 columns.  Its B
// fragments come straight from the byte tile: n-tile j of the warp takes
// columns 4 g + j (g = lane / 4), so one 32-bit shared load gives a lane
// its column's bytes for four n-tiles, and in the C layout a lane then
// owns 8 consecutive output columns (8 t .. 8 t + 7) of its rows.  int8
// codes become bf16 through the f32 magic 2^23 + u (a byte permute and an
// add), int4 nibble pairs through the bf16 magic 128 + u, already one
// bf16x2 register (a packed byte is the K pair of one column, which is
// what the B fragment wants).  The fragments of the next k16 step are
// loaded before this step's products start.  Row strides are padded
// so that these loads and the ldmatrix loads of x hit 32 distinct banks.
// BM is 16 for M <= 16 (decode, the logit head; 4 stages) and 64 above (3
// stages) for f32 x and for operands TMA cannot take (N % 16, K % 8,
// pointers off 16 bytes; those copies go element by element).
//
// Prefill, bf16 x (qmm_wgmma_kernel, wgmma.mma_async).  The product is
// taken transposed, out^T = W^T x^T, so the weight is the operand that
// wgmma reads from registers: each of two warpgroups converts its 128
// columns of the stage's raw bytes straight into A fragments (the same
// 32-bit words and byte tricks, a word's four columns feeding rows g and g
// + 8 of two m64 tiles) and runs two m64n64k16 products a k16 step
// against the x tile they share in shared memory.  One thread fills each
// ring stage with TMA boxes (x in wgmma's 128-byte-swizzled K-major
// layout, the weight bytes swizzled alike so the lanes' 32-bit loads stay
// free of bank conflicts) and an mbarrier counts the bytes in.  BT is 64
// tokens: each stage's products go to a fresh partial that is added to
// the sum in IEEE f32 (with the group's scales for int4), and the two
// arrays fill the registers; the conversion of step k + 1 overlaps the
// products of step k.
//
// Blocks take M tiles fastest, so the blocks that share a weight tile run
// together and HBM streams the weights once.  When the output tiles alone
// leave the 132 SMs idle, K is split: blockIdx.z takes a range of whole
// stages (so int4 groups never straddle splits), each split writes its
// partial [M, N] product to scratch the caller allocates, and a second
// kernel sums the splits in order 0, 1, ... -- no atomics, so repeats are
// bit for bit.
//
// Edges are masked in both kernels: rows past M and K and columns past
// N load as zeros (TMA fills a box's out-of-range part with zeros) and are
// never stored.
//
// What bounds it on this card.  At decode (M 8) the weight bytes: 2 M
// flops a weight byte, far below the ridge; the ring keeps 32-48 KB of
// weights in flight a block.  At prefill (M 512) the operations; the
// kernel runs at a third of the bf16 peak, and what it waits for is the
// stage copies (a ring filled by cp.async instead of TMA was slower still,
// and so was mma.sync fed the same way).  Clusters that multicast the x
// tile, a producer warp and a persistent grid are the next steps (PERF.md,
// ROADMAP).

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kGroup = 128;      // int4 scale-group length along K
constexpr int kBK = 128;         // K rows a stage holds (one int4 group)
constexpr int kBN = 128;         // output columns a block owns
constexpr int kWarpsN = 4;       // warps along N, 32 columns each
constexpr int kSMs = 132;
constexpr int kMaxSplits = 16;

// ---------------------------------------------------------------------------
// async copies and fragment loads
// ---------------------------------------------------------------------------

// 16 bytes global -> shared, bypassing L1; bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds_u32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the A fragment of a 16 x 16 bf16 tile: lane l gives the address of row
// l % 16, columns 8 (l / 16) .. + 7.  Volatile, with no memory clobber: it
// stays in order with the other volatile asm (the cp.async waits before
// it, the products after it) and free against plain loads.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(s));
}

// ---------------------------------------------------------------------------
// codes to bf16, exactly
// ---------------------------------------------------------------------------

// Byte j of w (bytes biased by 0x80, so u = code + 128) as the f32 value
// of the code: 2^23 + u built in the mantissa, minus 2^23 + 128.  The
// value has at most 8 significant bits, so its top 16 bits are its bf16.
__device__ __forceinline__ uint32_t i8_as_f32(uint32_t w, int j) {
  const uint32_t m = __byte_perm(w, 0x4B000000u, 0x7440u | j);
  return __float_as_uint(__uint_as_float(m) - 8388736.f);
}

// bf16x2 {code of byte j of lo, code of byte j of hi}
__device__ __forceinline__ uint32_t i8_pair(uint32_t lo, uint32_t hi, int j) {
  return __byte_perm(i8_as_f32(lo, j), i8_as_f32(hi, j), 0x7632u);
}

// Byte j of w (nibbles biased by 8, u = code + 8) as bf16x2 {low nibble,
// high nibble}: 128 + u is exact in bf16 (bits 0x4300 | u), minus 136.
__device__ __forceinline__ uint32_t i4_pair(uint32_t w, int j) {
  const uint32_t x = __byte_perm(w, 0u, 0x4040u | (j << 8) | j);
  const uint32_t r =
      (x & 0x0000000Fu) | ((x >> 4) & 0x000F0000u) | 0x43004300u;
  const uint32_t c = 0x43084308u;                  // bf16x2 (136, 136)
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&r),
              *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// x = h + m + l exactly, each a bf16 (16-bit pattern): h the top 16 bits
// of x, m those of x - h (exact), l those of x - h - m (exact, and at most
// 8 significant bits remain, so l loses nothing)
__device__ __forceinline__ void split3(float x, uint32_t& h, uint32_t& m,
                                       uint32_t& l) {
  const uint32_t xb = __float_as_uint(x);
  const float r1 = __fsub_rn(x, __uint_as_float(xb & 0xFFFF0000u));
  const uint32_t rb = __float_as_uint(r1);
  const float r2 = __fsub_rn(r1, __uint_as_float(rb & 0xFFFF0000u));
  h = xb >> 16;
  m = rb >> 16;
  l = __float_as_uint(r2) >> 16;
}

// one A register (two consecutive k of a row) split into its three terms
__device__ __forceinline__ void split_pair(float2 v, uint32_t& h, uint32_t& m,
                                           uint32_t& l) {
  uint32_t h0, m0, l0, h1, m1, l1;
  split3(v.x, h0, m0, l0);
  split3(v.y, h1, m1, l1);
  h = h0 | (h1 << 16);
  m = m0 | (m1 << 16);
  l = l0 | (l1 << 16);
}

// ---------------------------------------------------------------------------
// the tile and its ring stage
// ---------------------------------------------------------------------------

// The mma.sync tile: BM = 16 MT rows of x, row-major with a padded stride.
template <typename XT, bool INT4, int MT>
struct Tile {
  static constexpr int kThreads = 32 * kWarpsN;
  static constexpr int kBM = 16 * MT;
  static constexpr int kXStride = kBK * (int)sizeof(XT) + 16;   // bytes
  static constexpr int kWRows = INT4 ? kBK / 2 : kBK;
  static constexpr int kWStride = kBN + (INT4 ? 32 : 16);       // bytes
  static constexpr int kXBytes = kBM * kXStride;
  static constexpr int kWBytes = kWRows * kWStride;
  static constexpr int kSBytes = INT4 ? kBN * 4 : 0;
  static constexpr int kStage = kXBytes + kWBytes + kSBytes;
};

// Start the copies of one stage: x rows [m0, m0 + BM) by K [k0, k0 + 128),
// the weight rows of those K, and for int4 the group's scales.
template <typename XT, bool INT4, int MT>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const XT* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           const float* __restrict__ s, int M,
                                           int N, int K, int m0, int n0,
                                           int k0, int vec_x, int vec_w) {
  using T = Tile<XT, INT4, MT>;
  const int tid = threadIdx.x;
  constexpr int kXVec = 16 / (int)sizeof(XT);
  constexpr int kXChunks = kBK / kXVec;
  if (vec_x) {
    for (int i = tid; i < T::kBM * kXChunks; i += T::kThreads) {
      const int r = i / kXChunks, c = i - r * kXChunks;
      const int gm = m0 + r, gk = k0 + c * kXVec;
      const bool in = gm < M && gk < K;       // K % kXVec == 0: whole chunk
      cp_async16(st + r * T::kXStride + c * 16,
                 in ? (const void*)(x + (size_t)gm * K + gk) : (const void*)x,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < T::kBM * kBK; i += T::kThreads) {
      const int r = i / kBK, c = i - r * kBK;
      const int gm = m0 + r, gk = k0 + c;
      reinterpret_cast<XT*>(st + r * T::kXStride)[c] =
          (gm < M && gk < K) ? x[(size_t)gm * K + gk] : from_f<XT>(0.f);
    }
  }
  unsigned char* ws = st + T::kXBytes;
  const int rows = INT4 ? K / 2 : K;
  const int r0 = INT4 ? k0 / 2 : k0;
  constexpr int kWChunks = kBN / 16;
  if (vec_w) {
    for (int i = tid; i < T::kWRows * kWChunks; i += T::kThreads) {
      const int r = i / kWChunks, c = i - r * kWChunks;
      const int gr = r0 + r, gn = n0 + c * 16;
      const bool in = gr < rows && gn < N;     // N % 16 == 0: whole chunk
      cp_async16(ws + r * T::kWStride + c * 16,
                 in ? (const void*)(q + (size_t)gr * N + gn) : (const void*)q,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < T::kWRows * kBN; i += T::kThreads) {
      const int r = i / kBN, c = i - r * kBN;
      const int gr = r0 + r, gn = n0 + c;
      ws[r * T::kWStride + c] = (gr < rows && gn < N)
                                    ? (unsigned char)q[(size_t)gr * N + gn]
                                    : (unsigned char)0;
    }
  }
  if (INT4) {
    float* ss = reinterpret_cast<float*>(ws + T::kWBytes);
    const float* srow = s + (size_t)(k0 / kGroup) * N;
    if (vec_w) {
      for (int i = tid; i < kBN / 4; i += T::kThreads) {
        const int gn = n0 + 4 * i;
        cp_async16(ss + 4 * i,
                   gn < N ? (const void*)(srow + gn) : (const void*)s,
                   gn < N ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kBN; i += T::kThreads)
        ss[i] = n0 + i < N ? srow[n0 + i] : 0.f;
    }
  }
}

// The fragments of one k16 step: the raw weight words of the lane's column
// (int8: K rows 2t, 2t+1, 2t+8, 2t+9; int4: packed rows t and t+4), and
// for bf16 x the A fragments of the warp's m16 tiles.
template <typename XT, bool INT4, int MT>
struct Frags {
  static constexpr bool kBf16 = std::is_same<XT, bf16>::value;
  uint32_t w[INT4 ? 2 : 4];
  uint32_t a[kBf16 ? MT : 1][4];
};

template <typename XT, bool INT4, int MT>
__device__ __forceinline__ void load_frags(Frags<XT, INT4, MT>& f,
                                           const unsigned char* xs,
                                           const unsigned char* ws, int kk,
                                           int lane) {
  using T = Tile<XT, INT4, MT>;
  const int t = lane & 3;
  if constexpr (INT4) {
    const unsigned char* p = ws + (8 * kk + t) * T::kWStride;
    f.w[0] = lds_u32(p);
    f.w[1] = lds_u32(p + 4 * T::kWStride);
  } else {
    const unsigned char* p = ws + (16 * kk + 2 * t) * T::kWStride;
    f.w[0] = lds_u32(p);
    f.w[1] = lds_u32(p + T::kWStride);
    f.w[2] = lds_u32(p + 8 * T::kWStride);
    f.w[3] = lds_u32(p + 9 * T::kWStride);
  }
  if constexpr (Frags<XT, INT4, MT>::kBf16) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(f.a[mt], xs + (16 * mt + (lane & 15)) * T::kXStride +
                               (kk * 16 + (lane >> 4) * 8) * 2);
  }
}

// c[mt][j] += the warp's x rows . weight columns over one stage's 128 K.
// The fragments of step kk + 1 are loaded before the products of step kk
// start (two register sets), so shared-memory latency overlaps the
// tensor cores.  n-tile j takes the warp's columns 4 g + j.
template <typename XT, bool INT4, int MT>
__device__ __forceinline__ void mma_stage(float (&c)[MT][4][4],
                                          const unsigned char* st, int wn,
                                          int lane) {
  using T = Tile<XT, INT4, MT>;
  const int g = lane >> 2, t = lane & 3;
  const unsigned char* ws = st + T::kXBytes + wn * 32 + 4 * g;
  Frags<XT, INT4, MT> f[2];
  load_frags<XT, INT4, MT>(f[0], st, ws, 0, lane);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const int cur = kk & 1;
    if (kk + 1 < kBK / 16)
      load_frags<XT, INT4, MT>(f[cur ^ 1], st, ws, kk + 1, lane);
    uint32_t b[4][2];
    if constexpr (INT4) {
      const uint32_t w0 = f[cur].w[0] ^ 0x88888888u;
      const uint32_t w1 = f[cur].w[1] ^ 0x88888888u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = i4_pair(w0, j);
        b[j][1] = i4_pair(w1, j);
      }
    } else {
      const uint32_t w0 = f[cur].w[0] ^ 0x80808080u;
      const uint32_t w1 = f[cur].w[1] ^ 0x80808080u;
      const uint32_t w2 = f[cur].w[2] ^ 0x80808080u;
      const uint32_t w3 = f[cur].w[3] ^ 0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = i8_pair(w0, w1, j);
        b[j][1] = i8_pair(w2, w3, j);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (Frags<XT, INT4, MT>::kBf16) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(c[mt][j], f[cur].a[mt], b[j][0], b[j][1]);
      } else {
        const unsigned char* r =
            st + (16 * mt + g) * T::kXStride + (kk * 16 + 2 * t) * 4;
        uint32_t a[3][4];
        split_pair(*reinterpret_cast<const float2*>(r), a[0][0], a[1][0],
                   a[2][0]);
        split_pair(*reinterpret_cast<const float2*>(r + 8 * T::kXStride),
                   a[0][1], a[1][1], a[2][1]);
        split_pair(*reinterpret_cast<const float2*>(r + 32), a[0][2],
                   a[1][2], a[2][2]);
        split_pair(*reinterpret_cast<const float2*>(r + 8 * T::kXStride + 32),
                   a[0][3], a[1][3], a[2][3]);
        // term by term, so consecutive products go to different sums
#pragma unroll
        for (int term = 0; term < 3; ++term)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(c[mt][j], a[term], b[j][0], b[j][1]);
      }
    }
  }
}

template <typename XT, bool INT4, int MT, int STAGES>
__global__ void __launch_bounds__(32 * kWarpsN)
qmm_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ s, float* __restrict__ out, int M, int N,
           int K, int k_per_split, int vec_x, int vec_w, int vec_out) {
  using T = Tile<XT, INT4, MT>;
  static_assert(STAGES >= 3, "a ring of at least three stages");
  // stage partials: int4's group scales; and f32 x, whose small m and l
  // products the tensor cores would drop against a K-long sum (the mma's
  // f32 accumulation aligns to the largest term and does not round)
  constexpr bool kPart = INT4 || std::is_same<XT, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, wn = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * T::kBM, n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int stages = (kend - kbeg + kBK - 1) / kBK;

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < stages)
      load_stage<XT, INT4, MT>(smem + i * T::kStage, x, q, s, M, N, K, m0,
                               n0, kbeg + i * kBK, vec_x, vec_w);
    cp_async_commit();
  }
  for (int it = 0; it < stages; ++it) {
    cp_async_wait<STAGES - 2>();     // stage it has landed (this thread's)
    __syncthreads();                 // ... everyone's; stage it-1 is free
    const int nx = it + STAGES - 1;
    if (nx < stages)
      load_stage<XT, INT4, MT>(smem + (nx % STAGES) * T::kStage, x, q, s, M,
                               N, K, m0, n0, kbeg + nx * kBK, vec_x, vec_w);
    cp_async_commit();
    const unsigned char* st = smem + (it % STAGES) * T::kStage;
    if constexpr (kPart) {
      float part[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
      mma_stage<XT, INT4, MT>(part, st, wn, lane);
      float sc[8] = {1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f};
      if (INT4) {
        const float* ss = reinterpret_cast<const float*>(
                              st + T::kXBytes + T::kWBytes) +
                          wn * 32 + 8 * t;
        *reinterpret_cast<float4*>(sc) = *reinterpret_cast<const float4*>(ss);
        *reinterpret_cast<float4*>(sc + 4) =
            *reinterpret_cast<const float4*>(ss + 4);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[mt][j][0] += sc[j] * part[mt][j][0];
          acc[mt][j][1] += sc[4 + j] * part[mt][j][1];
          acc[mt][j][2] += sc[j] * part[mt][j][2];
          acc[mt][j][3] += sc[4 + j] * part[mt][j][3];
        }
    } else {
      mma_stage<XT, INT4, MT>(acc, st, wn, lane);
    }
  }
  cp_async_wait<0>();

  // epilogue: a lane owns columns col0 .. col0 + 7 of rows g and g + 8 of
  // each of its m16 tiles (n-tile j gave columns 8t + j and 8t + 4 + j)
  float* o = out + (size_t)blockIdx.z * M * N;
  const int col0 = n0 + wn * 32 + 8 * t;
  float sc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    sc[i] = (!INT4 && col0 + i < N) ? __ldg(s + col0 + i) : 1.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + mt * 16 + g + 8 * h;
      if (row >= M) continue;
      float r[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        r[j] = acc[mt][j][2 * h] * sc[j];
        r[4 + j] = acc[mt][j][2 * h + 1] * sc[4 + j];
      }
      float* dst = o + (size_t)row * N + col0;
      if (vec_out && col0 + 8 <= N) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(r[0], r[1], r[2], r[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(r[4], r[5], r[6], r[7]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (col0 + i < N) dst[i] = r[i];
      }
    }
}

// ---------------------------------------------------------------------------
// the prefill kernel: wgmma with the weights as the register operand
//
// out^T = W^T x^T: warpgroup wg computes a [128 columns, 64 tokens] tile
// as two m64n64k16 products a k16 step.  A is the weight, converted from
// the stage's raw bytes straight into the A fragments in registers (a
// lane's 32-bit word of four columns feeds rows g and g + 8 of both m64
// tiles); B is the x tile in shared memory, K-major in the 128-byte
// swizzle, copied there by TMA and shared by the block's warpgroups.  The
// conversion of step k + 1 overlaps the products of step k (two register
// sets, wgmma.wait_group 1 before a set is rewritten).
// ---------------------------------------------------------------------------

// The wgmma tile, one ring stage: the x tile as two TMA boxes of 64 K by
// BT tokens, 128-byte swizzled (wgmma's K-major SW128 layout: 8-row atoms
// of 1024 bytes), then per warpgroup a box of the raw weight bytes (128
// columns by 128 int8 K-rows or 64 packed int4 rows, 128-byte swizzled
// too), then for int4 the group's scales.  Every part starts on 1024 bytes.
template <bool INT4, int BT, int WG>
struct WTile {
  static constexpr int kThreads = 128 * WG;             // WG warpgroups
  static constexpr int kBN = 128 * WG;
  static constexpr int kXBox = BT * 128;                // 64 K x BT, bytes
  static constexpr int kWRows = INT4 ? kBK / 2 : kBK;
  static constexpr int kWBox = kWRows * 128;            // 128 columns
  static constexpr int kSOff = 2 * kXBox + WG * kWBox;
  static constexpr int kTx = kSOff + (INT4 ? kBN * 4 : 0);
  static constexpr int kStage = (kTx + 1023) / 1024 * 1024;
};

// The A fragments of k16 step kk for both m64 tiles: tile T's rows g and
// g + 8 of warp w' (w % 4) are the warpgroup's columns 32 w' + 4 g + 2 T
// and + 1.  The weight box is 128-byte swizzled: 16-byte chunk c of row r
// sits at chunk c ^ (r % 8), so off[d] is the lane's byte offset in rows
// whose r % 8 is (2t + d) for int8, (t + 4 d) for int4.
template <bool INT4>
__device__ __forceinline__ void weight_frags(uint32_t (&a)[2][4],
                                             const unsigned char* wb, int kk,
                                             int t, const int (&off)[2]) {
  if constexpr (INT4) {
    const unsigned char* p = wb + (8 * kk + t) * 128;
    const uint32_t w0 = lds_u32(p + off[0]) ^ 0x88888888u;
    const uint32_t w1 = lds_u32(p + 4 * 128 + off[1]) ^ 0x88888888u;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      a[m][0] = i4_pair(w0, 2 * m);
      a[m][1] = i4_pair(w0, 2 * m + 1);
      a[m][2] = i4_pair(w1, 2 * m);
      a[m][3] = i4_pair(w1, 2 * m + 1);
    }
  } else {
    const unsigned char* p = wb + (16 * kk + 2 * t) * 128;
    const uint32_t w0 = lds_u32(p + off[0]) ^ 0x80808080u;
    const uint32_t w1 = lds_u32(p + 128 + off[1]) ^ 0x80808080u;
    const uint32_t w2 = lds_u32(p + 8 * 128 + off[0]) ^ 0x80808080u;
    const uint32_t w3 = lds_u32(p + 9 * 128 + off[1]) ^ 0x80808080u;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      a[m][0] = i8_pair(w0, w1, 2 * m);
      a[m][1] = i8_pair(w0, w1, 2 * m + 1);
      a[m][2] = i8_pair(w2, w3, 2 * m);
      a[m][3] = i8_pair(w2, w3, 2 * m + 1);
    }
  }
}

// c[m] = the two m64 tiles' products over one stage's 128 K (the first
// step ignores what c held)
template <bool INT4, int BT, int WG>
__device__ __forceinline__ void wgmma_stage(float (&c)[2][BT / 2],
                                            const unsigned char* st, int w,
                                            int lane) {
  using T = WTile<INT4, BT, WG>;
  static_assert(BT == 64, "the products are m64n64k16");
  const int g = lane >> 2, t = lane & 3;
  const unsigned char* wb = st + 2 * T::kXBox + (w >> 2) * T::kWBox;
  const int chunk = 2 * (w & 3) + (g >> 2), in = 4 * (g & 3);
  const int off[2] = {
      ((chunk ^ (INT4 ? t : 2 * t)) << 4) + in,
      ((chunk ^ (INT4 ? t + 4 : 2 * t + 1)) << 4) + in};
  const uint64_t desc = sw128_desc(st);
  uint32_t a[2][2][4];
  weight_frags<INT4>(a[0], wb, 0, t, off);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const int cur = kk & 1;
    // k16 step kk: box kk / 4, 32 bytes a step inside the swizzle atom
    const uint64_t d =
        desc + (uint64_t)(((kk >> 2) * T::kXBox + (kk & 3) * 32) >> 4);
    const int scale_d = kk == 0 ? 0 : 1;
    wgmma_fence();
    wgmma_rs_n64<0>(c[0], a[cur][0], d, scale_d);
    wgmma_rs_n64<0>(c[1], a[cur][1], d, scale_d);
    wgmma_commit();
    if (kk + 1 < kBK / 16) {
      wgmma_wait<1>();               // step kk - 1 is done with a[cur ^ 1]
      keep(a[cur ^ 1][0]);
      keep(a[cur ^ 1][1]);
      weight_frags<INT4>(a[cur ^ 1], wb, kk + 1, t, off);
    }
  }
  wgmma_wait<0>();
  keep(a[0][0]);
  keep(a[0][1]);
  keep(a[1][0]);
  keep(a[1][1]);
  keep(c[0]);
  keep(c[1]);
}

template <bool INT4, int BT, int WG, int STAGES>
__global__ void __launch_bounds__(128 * WG)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap ts,
                 const float* __restrict__ s, float* __restrict__ out, int M,
                 int N, int K, int k_per_split, int vec_out) {
  using T = WTile<INT4, BT, WG>;
  static_assert(STAGES >= 3, "a ring of at least three stages");
  // the swizzled boxes need 1024-byte alignment; the launch adds 1 KB
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * T::kStage);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * T::kBN;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int stages = (kend - kbeg + kBK - 1) / kBK;

  // thread 0 starts a stage's boxes; they land in slot i % STAGES
  auto fill = [&](int i) {
    unsigned char* st = smem + (i % STAGES) * T::kStage;
    uint64_t* bar = full + i % STAGES;
    const int k0 = kbeg + i * kBK;
    mbar_expect(bar, T::kTx);
    tma_2d(st, &tx, k0, m0, bar);
    tma_2d(st + T::kXBox, &tx, k0 + 64, m0, bar);
#pragma unroll
    for (int wg = 0; wg < WG; ++wg)
      tma_2d(st + 2 * T::kXBox + wg * T::kWBox, &tw, n0 + 128 * wg,
             INT4 ? k0 / 2 : k0, bar);
    if (INT4) tma_2d(st + T::kSOff, &ts, n0, k0 / kGroup, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < STAGES - 1 && i < stages; ++i) fill(i);
  }
  __syncthreads();

  // part holds one stage's products (each stage's first step overwrites
  // it) and is added to acc in IEEE f32, with the group's scales for
  // int4: wgmma's own f32 accumulation truncates small addends against a
  // large sum, which over a K-long chain (11008 for down) came within 2%
  // of the 1e-5 l2 gate
  float acc[2][BT / 2], part[2][BT / 2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) acc[m][e] = part[m][e] = 0.f;

  for (int it = 0; it < stages; ++it) {
    mbar_wait(full + it % STAGES, (it / STAGES) & 1);
    __syncthreads();                 // every warp is done with stage it-1
    if (threadIdx.x == 0 && it + STAGES - 1 < stages)
      fill(it + STAGES - 1);         // ... so its slot takes stage it+S-1
    const unsigned char* st = smem + (it % STAGES) * T::kStage;
    wgmma_stage<INT4, BT, WG>(part, st, w, lane);
    // column 4 g + j of the warp's 32 is tile j / 2, row half j % 2
    float sc[4] = {1.f, 1.f, 1.f, 1.f};
    if (INT4) {
      const float4 s4 = *reinterpret_cast<const float4*>(
          st + T::kSOff + 4 * (32 * w + 4 * g));
      sc[0] = s4.x, sc[1] = s4.y, sc[2] = s4.z, sc[3] = s4.w;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < BT / 2; ++e)
        acc[m][e] += sc[2 * m + ((e >> 1) & 1)] * part[m][e];
  }

  // epilogue: acc[m][4 i + 2 h + e] is column 32 w + 4 g + 2 m + h of
  // token 8 i + 2 t + e; a lane stores its four consecutive columns
  float* o = out + (size_t)blockIdx.z * M * N;
  const int col0 = n0 + 32 * w + 4 * g;
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    sc[j] = (!INT4 && col0 + j < N) ? __ldg(s + col0 + j) : 1.f;
#pragma unroll
  for (int i = 0; i < BT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * i + 2 * t + e;
      if (row >= M) continue;
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = acc[j >> 1][4 * i + 2 * (j & 1) + e] * sc[j];
      float* dst = o + (size_t)row * N + col0;
      if (vec_out && col0 + 4 <= N) {
        *reinterpret_cast<float4*>(dst) = make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col0 + j < N) dst[j] = r[j];
      }
    }
}

// out[i] = part[0][i] + part[1][i] + ... in split order
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t mn,
                                  int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float a = part[i];
    for (int z = 1; z < splits; ++z) a += part[(size_t)z * mn + i];
    out[i] = a;
  }
}

// ---------------------------------------------------------------------------
// geometry and launch
// ---------------------------------------------------------------------------

// Three tiles: M <= 16 (decode, the logit head) mma.sync on one m16 row
// tile, a ring of 4 stages, two blocks an SM; larger M with f32 x, or
// operands TMA cannot take (N % 16, K % 8, pointers off 16 bytes), mma.sync
// on BM 64 (four m16 row tiles), 3 stages; larger M with bf16 x wgmma, kWgWG
// warpgroups of 128 columns on 64 tokens, 3 stages.
constexpr int kWgBT = 64, kWgWG = 2, kWgStages = 3;

template <bool INT4>
constexpr size_t wgmma_smem() {
  using T = WTile<INT4, kWgBT, kWgWG>;
  return (size_t)kWgStages * (T::kStage + 8) + 1024;
}

struct Geom {
  int tile;         // 0, 1, 2 as above
  int bm, bn;
  int splits;
  int k_per_split;  // a multiple of kBK
};

// tile_req: -1 for the rule above, else 0, 1 or 2 (2 only where the rule
// could take it: bf16 x and operands TMA takes; elsewhere the rule's
// tile).  slabs_req: 0 for the rule below, else the 128-row K slabs a
// split sums before the ordered sum of the splits (as many splits as that
// takes, at most kMaxSplits).  A split's partial is one f32 chain over its
// slabs, so bounding the slabs bounds the chain at any K, where a split
// count taken from one K would leave 86-slab chains at K 11,008.  The
// wrapper's plan comes from the tuning cache; with no entry it passes -1
// and 0, the rule.
Geom geometry(int M, int N, int K, int x_dtype, int int4, bool tma,
              int tile_req, int slabs_req) {
  Geom g;
  const int rule = M <= 16 ? 0 : (x_dtype == 0 || !tma) ? 1 : 2;
  g.tile = tile_req == 0 || tile_req == 1 ? tile_req
           : tile_req == 2 && x_dtype == 1 && tma ? 2 : rule;
  g.bm = g.tile == 0 ? 16 : g.tile == 1 ? 64 : kWgBT;
  g.bn = g.tile == 2 ? 128 * kWgWG : kBN;
  const size_t smem = int4 ? wgmma_smem<true>() : wgmma_smem<false>();
  const int per_sm = g.tile == 0 || (g.tile == 1 && x_dtype == 1) ? 2
                     : g.tile == 1 ? 1 : 2 * smem <= 227 * 1024 ? 2 : 1;
  const long long tiles =
      (long long)((M + g.bm - 1) / g.bm) * ((N + g.bn - 1) / g.bn);
  const int slabs = (K + kBK - 1) / kBK;
  long long want = slabs_req > 0 ? (slabs + slabs_req - 1) / slabs_req
                                 : (long long)kSMs * per_sm / tiles;
  if (want > kMaxSplits) want = kMaxSplits;
  if (want > slabs) want = slabs;
  if (want < 1) want = 1;
  g.k_per_split = (int)((slabs + want - 1) / want) * kBK;
  g.splits = (K + g.k_per_split - 1) / g.k_per_split;
  return g;
}

template <typename XT, bool INT4, int MT, int STAGES>
int launch_mma(const Geom& g, const void* x, const void* q, const void* s,
               float* dst, int M, int N, int K, int vec_x, int vec_w,
               int vec_out, cudaStream_t stream) {
  using T = Tile<XT, INT4, MT>;
  // M tiles fastest: the blocks that share a weight tile run together and
  // read it from L2, so HBM streams the weights once
  dim3 grid((M + T::kBM - 1) / T::kBM, (N + kBN - 1) / kBN, g.splits);
  return launch(qmm_kernel<XT, INT4, MT, STAGES>, grid, T::kThreads,
                (size_t)STAGES * T::kStage, stream,
                static_cast<const XT*>(x), static_cast<const int8_t*>(q),
                static_cast<const float*>(s), dst, M, N, K, g.k_per_split,
                vec_x, vec_w, vec_out);
}

template <bool INT4>
int launch_wgmma(const Geom& g, const void* x, const void* q, const void* s,
                 float* dst, int M, int N, int K, int vec_out,
                 cudaStream_t stream) {
  constexpr int kBT = kWgBT;
  using T = WTile<INT4, kBT, kWgWG>;
  CUtensorMap tx, tw, ts;
  bool ok = tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                       (uint64_t)K * 2, 64, kBT, CU_TENSOR_MAP_SWIZZLE_128B) &&
            tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N,
                       INT4 ? K / 2 : K, N, 128, T::kWRows,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  ts = tx;
  if (INT4)
    ok = ok && tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, N,
                          (K + kGroup - 1) / kGroup, (uint64_t)N * 4,
                          T::kBN, 1, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  dim3 grid((M + kBT - 1) / kBT, (N + T::kBN - 1) / T::kBN, g.splits);
  return launch(qmm_wgmma_kernel<INT4, kBT, kWgWG, kWgStages>, grid,
                T::kThreads, wgmma_smem<INT4>(), stream, tx, tw, ts,
                static_cast<const float*>(s), dst, M, N, K, g.k_per_split,
                vec_out);
}

template <typename XT, bool INT4>
int launch_tiles(const Geom& g, const void* x, const void* q, const void* s,
                 float* dst, int M, int N, int K, int vec_x, int vec_w,
                 int vec_out, cudaStream_t st) {
  if (g.tile == 0)
    return launch_mma<XT, INT4, 1, 4>(g, x, q, s, dst, M, N, K, vec_x, vec_w,
                                      vec_out, st);
  if (g.tile == 1 || !std::is_same<XT, bf16>::value)
    return launch_mma<XT, INT4, 4, 3>(g, x, q, s, dst, M, N, K, vec_x, vec_w,
                                      vec_out, st);
  return launch_wgmma<INT4>(g, x, q, s, dst, M, N, K, vec_out, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Scratch (in floats) that paddle_quant_matmul needs for this shape and x
// type and pool type: the split partial products, or 0 when K is not
// split.
extern "C" long long paddle_quant_matmul_scratch(int M, int N, int K,
                                                 int x_dtype, int int4,
                                                 int tile, int slabs) {
  // the pointers decide between tiles 1 and 2: room for either
  long long n = 0;
  for (int tma = 0; tma < 2; ++tma) {
    const Geom g = geometry(M, N, K, x_dtype, int4, tma, tile, slabs);
    if (g.splits > 1 && (long long)g.splits * M * N > n)
      n = (long long)g.splits * M * N;
  }
  return n;
}

// C entry, bound with ctypes.  x_dtype: 0 = float32, 1 = bfloat16; int4: 0
// for int8 pools, 1 for nibble-packed int4; tile and slabs as geometry's
// tile_req and slabs_req (-1 and 0: the rule).  ``scratch`` holds at least
// paddle_quant_matmul_scratch(M, N, K, x_dtype, int4, tile, slabs) floats.
// Returns
// cudaGetLastError() after the launches (0 on success; a refused launch,
// for shared memory, returns its error here); the caller checks it.  The
// wrapper (paddle_tpu_torch/ops/quant_matmul.py) has already checked
// shapes, types and contiguity: M, N, K >= 1, K even for int4.
extern "C" int paddle_quant_matmul(const void* x, const void* q,
                                   const void* s, void* out, void* scratch,
                                   int M, int N, int K, int x_dtype,
                                   int int4, int tile, int slabs,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype != 0 && x_dtype != 1) return (int)cudaErrorInvalidValue;
  const size_t xsize = x_dtype == 0 ? 4 : 2;
  const int vec_x = (size_t)K * xsize % 16 == 0 && aligned16(x);
  const int vec_w = N % 16 == 0 && aligned16(q) && aligned16(s);
  const Geom g = geometry(M, N, K, x_dtype, int4, vec_x && vec_w, tile,
                         slabs);
  float* dst = static_cast<float*>(g.splits > 1 ? scratch : out);
  const int vec_out = N % 4 == 0 && aligned16(dst);
  int err;
  if (x_dtype == 0)
    err = int4 ? launch_tiles<float, true>(g, x, q, s, dst, M, N, K, vec_x,
                                           vec_w, vec_out, st)
               : launch_tiles<float, false>(g, x, q, s, dst, M, N, K, vec_x,
                                            vec_w, vec_out, st);
  else
    err = int4 ? launch_tiles<bf16, true>(g, x, q, s, dst, M, N, K, vec_x,
                                          vec_w, vec_out, st)
               : launch_tiles<bf16, false>(g, x, q, s, dst, M, N, K, vec_x,
                                           vec_w, vec_out, st);
  if (err != 0 || g.splits == 1) return err;
  const size_t mn = (size_t)M * N;
  size_t blocks = (mn + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  sum_splits_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<float*>(out), mn,
      g.splits);
  return (int)cudaGetLastError();
}
