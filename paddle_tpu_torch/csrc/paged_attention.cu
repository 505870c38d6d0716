// Paged attention for Hopper (sm_90a): attention for S slots x R window
// rows x H heads, read THROUGH per-slot block tables [S, MAXB] from a
// KV block pool [NB, Bt, H, Dh].
//
// Replaces the TPU kernel paddle_tpu/parallel/paged_attention.py:79
// (`_pa_kernel`, built by `_paged_attention` and reached by
// paged_decode_attention / paged_verify_attention /
// paged_prefill_attention). Same function: row r of a window based at
// base[s] attends depths <= base[s] + r, online softmax in f32 with the
// NEG_INF exact no-op guards, two scaling families (decode scales the
// scores after QK^T; verify/prefill fold the scale into q first).
//
// The quantized branch (`_pa_kernel` with quant=True,
// paddle_tpu/parallel/paged_attention.py:116-118,158-183): the pools hold
// int8 or float8_e4m3fn codes and per-(physical block, head) f32 scales
// [NB, H] come beside them. Each staged table entry reads its two scales
// once (with the clamped physical block, as the TPU kernel's index map
// clamps); codes convert to f32 exactly (int8 by cast, e4m3 through
// cuda_fp8.h) and are multiplied by the scale in f32 before they meet q
// or P, as the TPU kernel multiplies before its dot. No dequantized pool
// ever exists in device memory.
//
// What bounds it on this card: HBM bytes. Per (slot, head) the kernel
// reads every K/V row it attends exactly once and does 4*Dh flops per
// (row, depth) pair — a few flops per byte, far below the ~295 flop/B
// where an H100 turns compute-bound. At serving shapes the work is small
// (a decode step moves ~10-20 MB), so what the kernel must beat is
// latency: enough CTAs in flight, and loads overlapped with math.
//
// bf16 q (over bf16, int8 or e4m3 pools): the split-context design
// (flash-decoding), `paged_split_kernel` and `paged_merge_kernel`.
//   * the grid is (partition, row tile x head, slot): each CTA takes a
//     contiguous range of about 256 tokens' table entries for up to 16
//     window rows (1 for decode, 4 for a verify window) and writes its
//     partial (m, l, acc[rows, Dh]) in f32 to a workspace; a second small
//     kernel merges the partitions in partition order (weight exactly 0
//     for an empty one) and writes acc / max(l, 1e-30) in bf16. With one
//     partition the first kernel writes the output itself. The partition
//     count comes from the shapes alone (S, R, H, Bt, MAXB; at least two
//     waves of CTAs on 132 SMs where the context allows), never from
//     positions or table contents, so -1 tails and relaunches stay
//     bit-identical. A partition past every row's reach is empty;
//   * inside a CTA, 4 warps take disjoint 32-token groups of the range,
//     one token a lane, each warp with its own online-softmax state (m,
//     l, acc) merged in warp order at the CTA's end: every warp has work
//     at R = 1, and no shared score tile is crossed by CTA barriers;
//   * a group's table entries (and scales) are read once, one lane each,
//     and shuffled to the lanes that copy its rows: K and V rows arrive
//     by 16-byte cp.async in the pool's storage type into the warp's
//     two-stage ring, the next group in flight while this one is
//     computed, one warp barrier per step; rows are padded to an odd
//     number of 16-byte chunks so a lane per row reads without bank
//     conflicts. Conversion and dequantization happen in f32 at use;
//   * scores: a lane dots its token's K row with every q row (q staged
//     once in f32, the verify/prefill scale folded in); P stays f32 and
//     P.V runs token by token, each lane owning 2 or 4 head dims. No
//     tensor cores: the TPU kernel computes in f32 throughout.
//
// f32 q: the single-pass design (`paged_attention_kernel<float, TP>`),
// the f32 parity path the token-identity checks run on:
//   * one CTA per (slot, head, tile of up to 16 window rows); the loop
//     over table entries inside the CTA replaces the TPU's sequential
//     grid axis, and stops at the deepest entry any row of the tile can
//     attend (min(ceil((base+R)/Bt), MAXB)) — decode never touches
//     blocks past a slot's position;
//   * the CTA reads the block table itself and stages G table entries
//     (G*Bt ~ 64 tokens) of K and V per step in shared memory with
//     16-byte loads: each token's [Dh] head slice is a contiguous
//     segment, so a warp's loads coalesce;
//   * scores, the online (m, l, acc) update and the P.V product run
//     from shared memory in f32 on the CUDA cores; acc lives in
//     registers. A -1 (unallocated) entry clamps to block 0 and is
//     excluded by the position mask, contributing exactly 0.
// Left for later work: TMA loads in place of cp.async, and CUDA-graph
// capture of the decode step around the kernels.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;     // window rows per CTA
constexpr int kTileTokens = 64;  // target tokens staged per step
constexpr int kMaxDh = 128;
constexpr int kMaxAcc = kMaxRows * kMaxDh / kThreads;  // accumulators / thread
constexpr float kNegInf = -1e30f;  // parallel/kernel_utils.py NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// one 16-byte chunk -> 16 / sizeof(T) floats
template <typename T>
__device__ void unpack16(const uint4& u, float* dst);

template <>
__device__ __forceinline__ void unpack16<int8_t>(const uint4& u, float* dst) {
  int8_t b[16];
  memcpy(b, &u, sizeof(b));
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<float>(b[i]);
}
template <>
__device__ __forceinline__ void unpack16<__nv_fp8_e4m3>(const uint4& u,
                                                       float* dst) {
  __nv_fp8_storage_t b[16];
  memcpy(b, &u, sizeof(b));
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    // e4m3 -> half is exact (every e4m3 value is a half), half -> float too
    const __half h = __half(__nv_cvt_fp8_to_halfraw(b[i], __NV_E4M3));
    dst[i] = __half2float(h);
  }
}

template <>
__device__ __forceinline__ void unpack16<float>(const uint4& u, float* dst) {
  dst[0] = __uint_as_float(u.x);
  dst[1] = __uint_as_float(u.y);
  dst[2] = __uint_as_float(u.z);
  dst[3] = __uint_as_float(u.w);
}
template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u,
                                                        float* dst) {
  __nv_bfloat162 h[4];
  memcpy(h, &u, sizeof(h));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// TQ: q and out (float or bf16); TP: the pools (TQ, or int8 / e4m3 codes,
// which come with the per-(block, head) scales k_scale / v_scale [NB, H])
template <typename TQ, typename TP>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
                       const TP* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ tables,
                       const int* __restrict__ base_arr, int base_scalar,
                       TQ* __restrict__ out, int R, int H, int Dh, int NB,
                       int Bt, int MAXB, int rt, int G, float scale,
                       int scale_in_q) {
  constexpr bool kQuant = sizeof(TP) == 1;
  extern __shared__ float smem[];
  const int TT = G * Bt;
  float* sQ = smem;                   // [rt, Dh]
  float* sK = sQ + rt * Dh;           // [TT, Dh + 1] (padded: no bank conflicts)
  float* sV = sK + TT * (Dh + 1);     // [TT, Dh]
  float* sP = sV + TT * Dh;           // [rt, TT] scores, then probabilities
  float* sM = sP + rt * TT;           // [rt] running max
  float* sL = sM + rt;                // [rt] running sum
  float* sA = sL + rt;                // [rt] this step's rescale factor
  float* sKS = sA + rt;               // [G] this step's K scales (quant)
  float* sVS = sKS + G;               // [G] this step's V scales (quant)
  int* sPB = reinterpret_cast<int*>(sVS + G);  // [G] physical blocks (quant)

  const int s = blockIdx.z;
  const int h = blockIdx.y;
  const int r0 = blockIdx.x * rt;
  const int nrows = min(rt, R - r0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = base_arr != nullptr ? base_arr[s] : base_scalar;

  // table entries any row of this tile can attend: depth <= base + r
  const long long last = (long long)base + r0 + nrows - 1;
  const long long reach = last < 0 ? 0 : last / Bt + 1;
  const int nb = reach < MAXB ? (int)reach : MAXB;
  const int n_steps = (nb + G - 1) / G;

  for (int i = tid; i < rt * Dh; i += kThreads) {
    const int r = i / Dh;
    const int d = i - r * Dh;
    float x = 0.f;
    if (r < nrows) {
      x = to_f32(q[(((size_t)s * R + r0 + r) * H + h) * Dh + d]);
      if (scale_in_q) x *= scale;  // chunk family: scale folded into q
    }
    sQ[i] = x;
  }
  for (int r = tid; r < rt; r += kThreads) {
    sM[r] = kNegInf;
    sL[r] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) acc[a] = 0.f;

  constexpr int epc = 16 / sizeof(TP);  // elements per 16-byte chunk
  const int cpr = Dh / epc;             // chunks per token row
  const int* trow = tables + (size_t)s * MAXB;
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    const int j0 = step * G;
    // -1 (unallocated) table entries clamp to block 0, masked by position
    // below. A quantized pool reads the step's entries and their two
    // scales once into shared memory; an unquantized pool reads its entry
    // inline while staging and pays no extra barrier
    if constexpr (kQuant) {
      for (int jb = tid; jb < G; jb += kThreads) {
        const int j = j0 + jb;
        const int pb = j < nb ? min(max(trow[j], 0), NB - 1) : 0;
        sPB[jb] = pb;
        sKS[jb] = k_scale[(size_t)pb * H + h];
        sVS[jb] = v_scale[(size_t)pb * H + h];
      }
      __syncthreads();
    }
    // stage G table entries of K and V for head h in shared memory
    for (int c = tid; c < TT * cpr; c += kThreads) {
      const int t = c / cpr;
      const int part = c - t * cpr;
      const int jb = t / Bt;
      float kf[epc];
      float vf[epc];
      if (j0 + jb < nb) {
        const int pb = kQuant ? sPB[jb]
                              : min(max(trow[j0 + jb], 0), NB - 1);
        const size_t off =
            (((size_t)pb * Bt + (t - jb * Bt)) * H + h) * Dh + part * epc;
        const uint4 ku = *reinterpret_cast<const uint4*>(k_pool + off);
        const uint4 vu = *reinterpret_cast<const uint4*>(v_pool + off);
        unpack16<TP>(ku, kf);
        unpack16<TP>(vu, vf);
        if constexpr (kQuant) {  // dequantize in f32, before the dot
          const float ks = sKS[jb];
          const float vs = sVS[jb];
#pragma unroll
          for (int e = 0; e < epc; ++e) {
            kf[e] *= ks;
            vf[e] *= vs;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < epc; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < epc; ++e) {
        sK[t * (Dh + 1) + part * epc + e] = kf[e];
        sV[t * Dh + part * epc + e] = vf[e];
      }
    }
    __syncthreads();

    // scores: row r (global position base + r0 + r) attends depth
    // <= its position; everything deeper contributes exactly 0
    for (int i = tid; i < rt * TT; i += kThreads) {
      const int r = i / TT;
      const int t = i - r * TT;
      const int depth = j0 * Bt + t;
      float sc = kNegInf;
      if (r < nrows && j0 + t / Bt < nb && depth <= (long long)base + r0 + r) {
        const float* qr = sQ + r * Dh;
        const float* kr = sK + t * (Dh + 1);
        float dot = 0.f;
        for (int d = 0; d < Dh; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc = scale_in_q ? dot : dot * scale;  // decode: scale after QK^T
      }
      sP[i] = sc;
    }
    __syncthreads();

    // online softmax, one warp per row; the NEG_INF guards make a
    // fully-masked step an exact no-op on (m, l, acc)
    for (int r = warp; r < rt; r += kWarps) {
      float* pr = sP + r * TT;
      float mc = kNegInf;
      for (int t = lane; t < TT; t += 32) mc = fmaxf(mc, pr[t]);
      mc = warp_max(mc);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mc);
      float sum = 0.f;
      for (int t = lane; t < TT; t += 32) {
        const float x = pr[t];
        const float p = x <= kNegInf ? 0.f : expf(x - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_prev <= kNegInf ? 0.f : expf(m_prev - m_new);
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
        sA[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V, each thread owning fixed (row, d) slots
#pragma unroll
    for (int a = 0; a < kMaxAcc; ++a) {
      const int i = tid + a * kThreads;
      if (i < rt * Dh) {
        const int r = i / Dh;
        const int d = i - r * Dh;
        const float* pr = sP + r * TT;
        float pv = 0.f;
        for (int t = 0; t < TT; ++t) pv = fmaf(pr[t], sV[t * Dh + d], pv);
        acc[a] = acc[a] * sA[r] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < kMaxAcc; ++a) {
    const int i = tid + a * kThreads;
    if (i < rt * Dh) {
      const int r = i / Dh;
      const int d = i - r * Dh;
      if (r < nrows) {
        store(out + (((size_t)s * R + r0 + r) * H + h) * Dh + d,
              acc[a] / fmaxf(sL[r], 1e-30f));
      }
    }
  }
}

template <typename TQ, typename TP>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* base, int base_scalar,
                   void* out, int S, int R, int H, int Dh, int NB, int Bt,
                   int MAXB, float scale, int scale_in_q,
                   cudaStream_t stream) {
  constexpr bool kQuant = sizeof(TP) == 1;
  if (Dh < 1 || Dh > kMaxDh || Dh % (16 / (int)sizeof(TP)) != 0 || Bt < 1 ||
      MAXB < 1 || NB < 1 || (kQuant && (k_scale == nullptr ||
                                        v_scale == nullptr)))
    return cudaErrorInvalidValue;
  const int rt = R < kMaxRows ? R : kMaxRows;
  const int G = Bt >= kTileTokens ? 1 : kTileTokens / Bt;
  const int TT = G * Bt;
  const size_t smem =
      sizeof(float) * ((size_t)rt * Dh + (size_t)TT * (Dh + 1) +
                       (size_t)TT * Dh + (size_t)rt * TT + 3 * (size_t)rt +
                       3 * (size_t)G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<TQ, TP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((R + rt - 1) / rt, H, S);
  paged_attention_kernel<TQ, TP><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), k_scale, v_scale, tables, base,
      base_scalar, static_cast<TQ*>(out), R, H, Dh, NB, Bt, MAXB, rt, G,
      scale, scale_in_q);
  return cudaGetLastError();
}

// pool_type: 0 = the pools hold TQ, 1 = int8 codes, 2 = e4m3 codes
template <typename TQ>
cudaError_t launch_pool(int pool_type, const void* q, const void* k_pool,
                        const void* v_pool, const float* k_scale,
                        const float* v_scale, const int* tables,
                        const int* base, int base_scalar, void* out, int S,
                        int R, int H, int Dh, int NB, int Bt, int MAXB,
                        float scale, int scale_in_q, cudaStream_t stream) {
  switch (pool_type) {
    case 0:
      return launch<TQ, TQ>(q, k_pool, v_pool, nullptr, nullptr, tables, base,
                            base_scalar, out, S, R, H, Dh, NB, Bt, MAXB,
                            scale, scale_in_q, stream);
    case 1:
      return launch<TQ, int8_t>(q, k_pool, v_pool, k_scale, v_scale, tables,
                                base, base_scalar, out, S, R, H, Dh, NB, Bt,
                                MAXB, scale, scale_in_q, stream);
    case 2:
      return launch<TQ, __nv_fp8_e4m3>(q, k_pool, v_pool, k_scale, v_scale,
                                       tables, base, base_scalar, out, S, R,
                                       H, Dh, NB, Bt, MAXB, scale, scale_in_q,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------
// bf16 q: the split-context kernel (flash-decoding) and its merge
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kSplitWarps = 4;
constexpr int kSplitThreads = 32 * kSplitWarps;
constexpr int kGroup = 32;           // tokens a warp stages a step, one a lane
constexpr int kSplitTokens = 256;    // tokens a partition takes
constexpr int kMinSplitTokens = 64;  // fewest, when the grid needs more CTAs
constexpr int kWaveCtas = 2 * 132;   // two waves of an H100's 132 SMs

// rows of q a CTA takes: the decode row, a verify window, a prefill tile
constexpr int split_rows(int R) { return R == 1 ? 1 : R <= 4 ? 4 : 16; }

// pitch (bytes) of a staged K or V row: whole 16-byte chunks, an odd
// number of them, so lanes reading rows t and t + 1 start on different
// banks (the score loop reads one row a lane)
__host__ __device__ constexpr int split_row_bytes(int Dh, int esize) {
  return 16 * ((Dh * esize / 16) | 1);
}

// Shared memory of the split kernel: q [MR][Dh] f32, then per warp a
// two-stage ring of K and V rows [kGroup][rb] in the pool's storage type,
// the stages' per-token K and V scales [2][2][kGroup] f32, and the step's
// probabilities [kGroup][PS] f32 (token-major, padded past 4 rows so the
// float4 stores of 32 lanes do not collide). After its last step a warp
// leaves its (m, l, acc) there for the CTA's merge.
template <int MR>
struct SplitLayout {
  static constexpr int PS = MR <= 4 ? MR : MR + 4;
  int rb, ring, per_warp, q_bytes;
  __host__ __device__ SplitLayout(int Dh, int esize)
      : rb(split_row_bytes(Dh, esize)),
        ring(4 * kGroup * rb),
        per_warp(ring + 4 * kGroup * 4 + kGroup * PS * 4),
        q_bytes(MR * Dh * 4) {}
  __host__ __device__ int bytes() const {
    return q_bytes + kSplitWarps * per_warp;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared without a register round trip; with `in`
// false nothing is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N consecutive elements of a staged row (2, 4 or 8 bytes) as f32
template <int B>
struct Raw;
template <>
struct Raw<2> {
  using T = uint16_t;
};
template <>
struct Raw<4> {
  using T = uint32_t;
};
template <>
struct Raw<8> {
  using T = uint2;
};
__device__ __forceinline__ float code_f32(bf16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float code_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float code_f32(__nv_fp8_e4m3 x) {
  // exact: every e4m3 value is a half, every half a float
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}
template <typename TP, int N>
__device__ __forceinline__ void load_n(const unsigned char* p, float (&f)[N]) {
  using W = typename Raw<N * sizeof(TP)>::T;
  const W w = *reinterpret_cast<const W*>(p);
  TP x[N];
  memcpy(x, &w, sizeof(x));
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = code_f32(x[i]);
}

// TP: the pools (bf16, or int8 / e4m3 codes with scales [NB, H]); MR:
// rows of q a CTA takes (split_rows); NDV: head dims a lane accumulates
// (consecutive, Dh <= 32 * NDV). One CTA per (partition, row tile x
// head, slot); partition p takes table entries [p * epp, (p + 1) * epp).
// With parts == 1 it writes `out`; otherwise its (m, l, acc) go to the
// workspace for paged_merge_kernel.
template <typename TP, int MR, int NDV>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(const bf16* __restrict__ q, const TP* __restrict__ k_pool,
                   const TP* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ tables,
                   const int* __restrict__ base_arr, int base_scalar,
                   bf16* __restrict__ out, float* __restrict__ ws, int R,
                   int H, int Dh, int NB, int Bt, int MAXB, int parts,
                   int epp, float scale, int scale_in_q) {
  constexpr bool kQuant = sizeof(TP) == 1;
  constexpr int PS = SplitLayout<MR>::PS;
  constexpr int EPC = 16 / sizeof(TP);  // elements per 16-byte chunk
  const SplitLayout<MR> lay(Dh, sizeof(TP));
  const int rb = lay.rb;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);  // [MR][Dh]

  const int part = blockIdx.x;
  const int h = blockIdx.y % H;
  const int r0 = (blockIdx.y / H) * MR;
  const int s = blockIdx.z;
  const int nrows = min(MR, R - r0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int base = base_arr != nullptr ? base_arr[s] : base_scalar;
  unsigned char* wmem = smem_raw + lay.q_bytes + warp * lay.per_warp;
  const uint32_t ring = smem_addr(wmem);
  float* sSc = reinterpret_cast<float*>(wmem + lay.ring);  // [2][2][32]
  float* sP = sSc + 4 * kGroup;                            // [32][PS]

  for (int i = threadIdx.x; i < MR * Dh; i += kSplitThreads) {
    const int r = i / Dh;
    float x = 0.f;
    if (r < nrows) {
      x = __bfloat162float(q[(((size_t)s * R + r0 + r) * H + h) * Dh + i -
                             r * Dh]);
      if (scale_in_q) x *= scale;  // chunk family: scale folded into q
    }
    sQ[i] = x;
  }

  // this partition's tokens: its table entries, cut at the deepest depth
  // any row of the tile attends (depth <= base + r). Shapes alone set the
  // partitions; positions only decide which are empty.
  const long long last = (long long)base + r0 + nrows - 1;
  const long long reach = last < 0 ? 0 : last / Bt + 1;
  const int nb = reach < MAXB ? (int)reach : MAXB;
  const int jb = part * epp;
  const int je = min(jb + epp, nb);
  const long long t0 = (long long)jb * Bt;
  const long long t1 = min((long long)je * Bt, last + 1);
  const int ntok = t1 > t0 ? (int)(t1 - t0) : 0;
  const int ngroups = (ntok + kGroup - 1) / kGroup;
  // warp w takes groups w, w + 4, ...: disjoint tokens, its own state
  const int nk = ngroups > warp ? (ngroups - warp + kSplitWarps - 1) /
                                      kSplitWarps
                                : 0;
  const int* trow = tables + (size_t)s * MAXB;
  const int cpr = Dh * (int)sizeof(TP) / 16;  // chunks per row
  const unsigned char* kbytes = reinterpret_cast<const unsigned char*>(k_pool);
  const unsigned char* vbytes = reinterpret_cast<const unsigned char*>(v_pool);

  // queue group (warp + 4kk)'s K and V rows into ring stage st
  auto issue = [&](int kk, int st) {
    const int g = warp + kSplitWarps * kk;
    const int d0 = (int)t0 + kGroup * g;  // depth of lane 0's token
    const int n_in = min(kGroup, ntok - kGroup * g);
    const int j0 = d0 / Bt;
    // each entry the group touches is read once, by one lane: its
    // physical block (-1 clamps to block 0, masked by position) and, for
    // a quantized pool, its two scales
    const int jl = j0 + lane;
    int pb = 0;
    float ks = 0.f, vs = 0.f;
    if (jl <= (d0 + n_in - 1) / Bt) {
      pb = min(max(trow[jl], 0), NB - 1);
      if constexpr (kQuant) {
        ks = k_scale[(size_t)pb * H + h];
        vs = v_scale[(size_t)pb * H + h];
      }
    }
    if constexpr (kQuant) {
      const int e = (d0 + lane) / Bt - j0;
      sSc[st * 2 * kGroup + lane] = __shfl_sync(0xffffffffu, ks, e);
      sSc[st * 2 * kGroup + kGroup + lane] = __shfl_sync(0xffffffffu, vs, e);
    }
    const uint32_t dk = ring + st * 2 * kGroup * rb;
    const uint32_t dv = dk + kGroup * rb;
    for (int c = lane; c < kGroup * cpr; c += 32) {
      const int t = c / cpr;
      const int ch = c - t * cpr;
      const int d = d0 + t;
      const int j = d / Bt;
      const int pbt = __shfl_sync(0xffffffffu, pb, j - j0);
      const bool in = t < n_in;
      const size_t off =
          ((((size_t)pbt * Bt + (d - j * Bt)) * H + h) * Dh) * sizeof(TP) +
          16 * ch;
      cp_async16(dk + t * rb + 16 * ch, in ? kbytes + off : kbytes, in);
      cp_async16(dv + t * rb + 16 * ch, in ? vbytes + off : vbytes, in);
    }
    cp_commit();
  };

  float m[MR], lp[MR], acc[MR][NDV];  // lp: this lane's share of l
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    m[r] = kNegInf;
    lp[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NDV; ++i) acc[r][i] = 0.f;
  }
  const int dl = lane * NDV;  // this lane's first head dim of acc
  __syncthreads();            // q is staged

  if (nk > 0) issue(0, 0);
  for (int kk = 0; kk < nk; ++kk) {
    const int st = kk & 1;
    if (kk + 1 < nk) {
      issue(kk + 1, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();  // the one barrier of a step: this warp's stage landed
    const int g = warp + kSplitWarps * kk;
    const int d0 = (int)t0 + kGroup * g;
    const int n_in = min(kGroup, ntok - kGroup * g);
    const unsigned char* sk = wmem + st * 2 * kGroup * rb;
    const unsigned char* sv = sk + kGroup * rb;

    // scores of this lane's token against every row, f32
    float sc[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) sc[r] = 0.f;
    const unsigned char* kr = sk + lane * rb;
    const float kscl = kQuant ? sSc[st * 2 * kGroup + lane] : 1.f;
    for (int c = 0; c < Dh; c += EPC) {
      float kf[EPC];
      unpack16<TP>(*reinterpret_cast<const uint4*>(kr + c * sizeof(TP)), kf);
      if constexpr (kQuant) {  // dequantize in f32, before the dot
#pragma unroll
        for (int e = 0; e < EPC; ++e) kf[e] *= kscl;
      }
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(sQ + r * Dh + c);
#pragma unroll
        for (int e4 = 0; e4 < EPC / 4; ++e4) {
          const float4 qv = qr[e4];
          sc[r] = fmaf(qv.x, kf[4 * e4], sc[r]);
          sc[r] = fmaf(qv.y, kf[4 * e4 + 1], sc[r]);
          sc[r] = fmaf(qv.z, kf[4 * e4 + 2], sc[r]);
          sc[r] = fmaf(qv.w, kf[4 * e4 + 3], sc[r]);
        }
      }
    }

    // online softmax per row over the warp's 32 tokens; the NEG_INF
    // guards make a fully-masked step an exact no-op on (m, l, acc)
    const long long depth = d0 + lane;
    float pr[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const bool keep =
          lane < n_in && r < nrows && depth <= (long long)base + r0 + r;
      const float x = keep ? (scale_in_q ? sc[r] : sc[r] * scale) : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = m[r] <= kNegInf ? 0.f : expf(m[r] - m_new);
      pr[r] = x <= kNegInf ? 0.f : expf(x - m_new);
      lp[r] = lp[r] * alpha + pr[r];
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < NDV; ++i) acc[r][i] *= alpha;
    }
    if constexpr (MR == 1) {
      sP[lane] = pr[0];
    } else {
#pragma unroll
      for (int r = 0; r < MR; r += 4)
        *reinterpret_cast<float4*>(sP + lane * PS + r) =
            make_float4(pr[r], pr[r + 1], pr[r + 2], pr[r + 3]);
    }
    __syncwarp();

    // acc += P.V: this lane's NDV head dims, token by token
    if (dl < Dh) {
      for (int t = 0; t < n_in; ++t) {
        float vf[NDV];
        load_n<TP, NDV>(sv + t * rb + dl * sizeof(TP), vf);
        if constexpr (kQuant) {
          const float vs = sSc[st * 2 * kGroup + kGroup + t];
#pragma unroll
          for (int i = 0; i < NDV; ++i) vf[i] *= vs;
        }
        float p[MR];
        if constexpr (MR == 1) {
          p[0] = sP[t];
        } else {
#pragma unroll
          for (int r = 0; r < MR; r += 4) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(sP + t * PS + r);
            p[r] = p4.x;
            p[r + 1] = p4.y;
            p[r + 2] = p4.z;
            p[r + 3] = p4.w;
          }
        }
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
          for (int i = 0; i < NDV; ++i)
            acc[r][i] = fmaf(p[r], vf[i], acc[r][i]);
      }
    }
    __syncwarp();  // done with this stage before it is refilled
  }

  // the warp's state into its own region, then the CTA merges its four
  // warps in order: weight exp(m_w - M), exactly 0 for an empty warp
  float* wacc = reinterpret_cast<float*>(wmem);  // [MR][Dh]
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const float l = warp_sum(lp[r]);
    if (dl < Dh) {
#pragma unroll
      for (int i = 0; i < NDV; ++i) wacc[r * Dh + dl + i] = acc[r][i];
    }
    if (lane == 0) {
      sP[r] = m[r];
      sP[MR + r] = l;
    }
  }
  __syncthreads();
  const size_t rows = (size_t)gridDim.z * R * H;
  for (int i = threadIdx.x; i < nrows * Dh; i += kSplitThreads) {
    const int r = i / Dh;
    const int d = i - r * Dh;
    float mw[kSplitWarps];
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float* wp = reinterpret_cast<const float*>(
          smem_raw + lay.q_bytes + w * lay.per_warp + lay.ring + 16 * kGroup);
      mw[w] = wp[r];
      M = fmaxf(M, mw[w]);
    }
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const unsigned char* wb = smem_raw + lay.q_bytes + w * lay.per_warp;
      const float wt = mw[w] <= kNegInf ? 0.f : expf(mw[w] - M);
      L += wt * reinterpret_cast<const float*>(wb + lay.ring +
                                               16 * kGroup)[MR + r];
      a += wt * reinterpret_cast<const float*>(wb)[r * Dh + d];
    }
    const size_t row = ((size_t)s * R + r0 + r) * H + h;
    if (parts == 1) {
      out[row * Dh + d] = __float2bfloat16(a / fmaxf(L, 1e-30f));
    } else {
      ws[(row * parts + part) * Dh + d] = a;
      if (d == 0) {
        float* wm = ws + rows * parts * Dh;
        wm[row * parts + part] = M;
        wm[rows * parts + row * parts + part] = L;
      }
    }
  }
}

// The partitions of each (slot, row, head) merged in partition order:
// weight exp(m_p - M) (exactly 0 for an empty partition), out = acc /
// max(l, 1e-30) in bf16. One warp a row.
__global__ void __launch_bounds__(kSplitThreads)
paged_merge_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
                   int rows, int parts, int Dh) {
  const int row = blockIdx.x * kSplitWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* pm = ws + (size_t)rows * parts * Dh + (size_t)row * parts;
  const float* pl = pm + (size_t)rows * parts;
  const float* pa = ws + (size_t)row * parts * Dh;
  float M = kNegInf;
  for (int p = 0; p < parts; ++p) M = fmaxf(M, pm[p]);
  float L = 0.f;
  for (int p = 0; p < parts; ++p)
    L += (pm[p] <= kNegInf ? 0.f : expf(pm[p] - M)) * pl[p];
  const float den = fmaxf(L, 1e-30f);
  for (int d = lane; d < Dh; d += 32) {
    float a = 0.f;
    for (int p = 0; p < parts; ++p)
      a += (pm[p] <= kNegInf ? 0.f : expf(pm[p] - M)) * pa[(size_t)p * Dh + d];
    out[(size_t)row * Dh + d] = __float2bfloat16(a / den);
  }
}

// partitions of the split kernel for these shapes: about kSplitTokens
// tokens each, more (down to kMinSplitTokens) while the grid holds fewer
// than two waves of CTAs; never more than MAXB, and every partition
// holds at least one table entry
int split_parts(int S, int R, int H, int Bt, int MAXB) {
  const int MR = split_rows(R);
  const long long ctas = (long long)S * H * ((R + MR - 1) / MR);
  const long long ctx = (long long)MAXB * Bt;
  long long parts = (ctx + kSplitTokens - 1) / kSplitTokens;
  const long long want = (kWaveCtas + ctas - 1) / ctas;
  if (parts < want) {
    const long long most = (ctx + kMinSplitTokens - 1) / kMinSplitTokens;
    parts = want < most ? want : most;
  }
  if (parts > MAXB) parts = MAXB;
  const int epp = (MAXB + (int)parts - 1) / (int)parts;
  return (MAXB + epp - 1) / epp;
}

template <typename TP, int MR, int NDV>
cudaError_t split_launch(const void* q, const void* k_pool, const void* v_pool,
                         const float* k_scale, const float* v_scale,
                         const int* tables, const int* base, int base_scalar,
                         void* out, float* ws, int parts, int S, int R, int H,
                         int Dh, int NB, int Bt, int MAXB, float scale,
                         int scale_in_q, cudaStream_t stream) {
  const int smem = SplitLayout<MR>(Dh, sizeof(TP)).bytes();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<TP, MR, NDV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int epp = (MAXB + parts - 1) / parts;
  const dim3 grid(parts, ((R + MR - 1) / MR) * H, S);
  paged_split_kernel<TP, MR, NDV><<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), k_scale, v_scale, tables, base,
      base_scalar, static_cast<bf16*>(out), ws, R, H, Dh, NB, Bt, MAXB, parts,
      epp, scale, scale_in_q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return e;
  const int rows = S * R * H;
  paged_merge_kernel<<<(rows + kSplitWarps - 1) / kSplitWarps, kSplitThreads,
                       0, stream>>>(ws, static_cast<bf16*>(out), rows, parts,
                                    Dh);
  return cudaGetLastError();
}

template <typename TP>
cudaError_t split_rows_dims(const void* q, const void* k_pool,
                            const void* v_pool, const float* k_scale,
                            const float* v_scale, const int* tables,
                            const int* base, int base_scalar, void* out,
                            float* ws, int parts, int S, int R, int H, int Dh,
                            int NB, int Bt, int MAXB, float scale,
                            int scale_in_q, cudaStream_t stream) {
#define SPLIT(MR, NDV)                                                    \
  split_launch<TP, MR, NDV>(q, k_pool, v_pool, k_scale, v_scale, tables,  \
                            base, base_scalar, out, ws, parts, S, R, H,   \
                            Dh, NB, Bt, MAXB, scale, scale_in_q, stream)
#define SPLIT_DIMS(MR) (Dh <= 64 ? SPLIT(MR, 2) : SPLIT(MR, 4))
  switch (split_rows(R)) {
    case 1:
      return SPLIT_DIMS(1);
    case 4:
      return SPLIT_DIMS(4);
    default:
      return SPLIT_DIMS(16);
  }
#undef SPLIT_DIMS
#undef SPLIT
}

// C interface bound with ctypes (parallel/paged_attention.py). Pointers
// and the stream come from torch; `base` may be null, in which case
// every slot's window starts at `base_scalar` (the one-slot prefill
// chunk). The pools hold q's type (`pool_type` 0, scales null) or int8
// (1) / e4m3 (2) codes with f32 scales [NB, H]. Each returns the
// cudaError_t of its launch (0 = launched).

// f32 q and out (`is_bf16` must be 0: bf16 q launches through
// paged_attention_split_launch)
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* base, int base_scalar, void* out, int is_bf16, int pool_type,
    int S, int R, int H, int Dh, int NB, int Bt, int MAXB, float scale,
    int scale_in_q, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (is_bf16) return (int)cudaErrorInvalidValue;
  if (S == 0 || R == 0 || H == 0) return 0;
  e = launch_pool<float>(pool_type, q, k_pool, v_pool,
                         static_cast<const float*>(k_scale),
                         static_cast<const float*>(v_scale),
                         static_cast<const int*>(tables),
                         static_cast<const int*>(base), base_scalar, out, S,
                         R, H, Dh, NB, Bt, MAXB, scale, scale_in_q,
                         static_cast<cudaStream_t>(stream));
  return (int)e;
}

// The number of context partitions the split kernel takes at these
// shapes (set by the shapes alone, never by positions or table contents).
extern "C" int paged_split_parts(int S, int R, int H, int Bt, int MAXB) {
  if (S < 1 || R < 1 || H < 1 || Bt < 1 || MAXB < 1) return -1;
  return split_parts(S, R, H, Bt, MAXB);
}

// Dynamic shared memory (bytes per CTA) the split kernel requests for R
// window rows of head width Dh over pools of `pool_type`.
extern "C" int paged_split_shared_bytes(int pool_type, int R, int Dh) {
  if (pool_type < 0 || pool_type > 2 || R < 1 || Dh < 1 || Dh > kMaxDh)
    return -1;
  const int esize = pool_type == 0 ? (int)sizeof(bf16) : 1;
  switch (split_rows(R)) {
    case 1:
      return SplitLayout<1>(Dh, esize).bytes();
    case 4:
      return SplitLayout<4>(Dh, esize).bytes();
    default:
      return SplitLayout<16>(Dh, esize).bytes();
  }
}

// bf16 q and out through the split kernel and, with more than one
// partition, the merge. `parts` is paged_split_parts(S, R, H, Bt, MAXB);
// with parts > 1, `workspace` holds S * R * H * parts * (Dh + 2) f32.
extern "C" int paged_attention_split_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* base, int base_scalar, void* out, void* workspace, int parts,
    int pool_type, int S, int R, int H, int Dh, int NB, int Bt, int MAXB,
    float scale, int scale_in_q, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (S == 0 || R == 0 || H == 0) return 0;
  const bool quant = pool_type != 0;
  if (Dh < 1 || Dh > kMaxDh || Bt < 1 || MAXB < 1 || NB < 1 ||
      parts != split_parts(S, R, H, Bt, MAXB) ||
      (parts > 1 && workspace == nullptr) ||
      (quant && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(tables);
  const int* bs = static_cast<const int*>(base);
  float* ws = static_cast<float*>(workspace);
#define ARGS                                                                 \
  q, k_pool, v_pool, ksc, vsc, tbl, bs, base_scalar, out, ws, parts, S, R, H, \
      Dh, NB, Bt, MAXB, scale, scale_in_q, st
  switch (pool_type) {
    case 0:
      e = Dh % 8 ? cudaErrorInvalidValue : split_rows_dims<bf16>(ARGS);
      break;
    case 1:
      e = Dh % 16 ? cudaErrorInvalidValue : split_rows_dims<int8_t>(ARGS);
      break;
    case 2:
      e = Dh % 16 ? cudaErrorInvalidValue
                  : split_rows_dims<__nv_fp8_e4m3>(ARGS);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
#undef ARGS
  return (int)e;
}
