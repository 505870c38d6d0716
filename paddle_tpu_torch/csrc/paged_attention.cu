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
// One design for q in bf16 and in f32 (over pools of q's dtype, int8 or
// e4m3): split context (flash-decoding), `paged_split_kernel<TQ, TP, MR,
// NDV, ST>` and `paged_merge_kernel<TQ>`, TQ the type of q and out, TP the
// pools'.
//   * the grid is (partition, row tile x head, slot): each CTA takes a
//     contiguous range of about 256 tokens' table entries for up to 16
//     window rows (1 for decode, 4 for a verify window) and writes its
//     partial (m, l, acc[rows, Dh]) in f32 to a workspace; a second small
//     kernel merges the partitions in partition order (weight exactly 0
//     for an empty one) and writes acc / max(l, 1e-30) in TQ. With one
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
//     conflicts. Where two stages would pass the 227 KB a CTA may take
//     (f32 pools at Dh 128: 528-byte rows), the ring has one stage and a
//     warp issues its next group once it is done with the current one
//     (the other warps' copies still overlap its math). Conversion and
//     dequantization happen in f32 at use;
//   * scores: a lane dots its token's K row with every q row (q staged
//     once in f32, the verify/prefill scale folded in); P stays f32 and
//     P.V runs token by token, each lane owning 2 or 4 head dims. No
//     tensor cores: the TPU kernel computes in f32 throughout, so f32 q
//     and bf16 q run the same math and differ only in q's load and the
//     output's store.
//   * f32 pools double the bytes of a staged row (272 B at Dh 64): a
//     CTA takes about 139 KB of shared memory there, one CTA an SM,
//     against two for bf16 pools.
// Left for later work: TMA loads in place of cp.async, and CUDA-graph
// capture of the decode step around the kernels.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxDh = 128;
constexpr float kNegInf = -1e30f;  // parallel/kernel_utils.py NEG_INF
// the most dynamic shared memory a CTA may take on sm_90 (227 KB)
constexpr int kMaxShared = 232448;

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

}  // namespace

// ---------------------------------------------------------------------
// the split-context kernel (flash-decoding) and its merge
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
// ring of `stages` stages of K and V rows [kGroup][rb] in the pool's
// storage type, the stages' per-token K and V scales [stages][2][kGroup]
// f32, and the step's probabilities [kGroup][PS] f32 (token-major, padded
// past 4 rows so the float4 stores of 32 lanes do not collide). After its
// last step a warp leaves its (m, l, acc) there for the CTA's merge. Two
// stages where they fit in a CTA's shared memory, else one.
template <int MR>
struct SplitLayout {
  static constexpr int PS = MR <= 4 ? MR : MR + 4;
  int rb, q_bytes, stages, ring, sc, per_warp;
  __host__ __device__ SplitLayout(int Dh, int esize)
      : rb(split_row_bytes(Dh, esize)), q_bytes(MR * Dh * 4) {
    set(2);
    if (bytes() > kMaxShared) set(1);
  }
  __host__ __device__ void set(int n) {
    stages = n;
    ring = n * 2 * kGroup * rb;
    sc = n * 2 * kGroup * 4;
    per_warp = ring + sc + kGroup * PS * 4;
  }
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

// N consecutive elements of a staged row (2, 4, 8 or 16 bytes) as f32
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
template <>
struct Raw<16> {
  using T = uint4;
};
__device__ __forceinline__ float code_f32(float x) { return x; }
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
// f32 -> q's type (out is written in it)
template <typename TQ>
__device__ TQ from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
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

// TQ: q and out (bf16 or f32); TP: the pools (TQ, or int8 / e4m3 codes
// with scales [NB, H]); MR: rows of q a CTA takes (split_rows); NDV: head
// dims a lane accumulates (consecutive, Dh <= 32 * NDV); ST: the ring's
// stages, SplitLayout's choice at these shapes (1 only for f32 pools past
// Dh 100). One CTA per (partition, row tile x head, slot); partition p
// takes table entries [p * epp, (p + 1) * epp). With parts == 1 it
// writes `out`; otherwise its (m, l, acc) go to the workspace for
// paged_merge_kernel.
template <typename TQ, typename TP, int MR, int NDV, int ST>
__global__ void __launch_bounds__(kSplitThreads)
paged_split_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pool,
                   const TP* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ tables,
                   const int* __restrict__ base_arr, int base_scalar,
                   TQ* __restrict__ out, float* __restrict__ ws, int R,
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
  // [stages][2][32] scales, then [32][PS] probabilities
  float* sSc = reinterpret_cast<float*>(wmem + lay.ring);
  float* sP = reinterpret_cast<float*>(wmem + lay.ring + lay.sc);

  for (int i = threadIdx.x; i < MR * Dh; i += kSplitThreads) {
    const int r = i / Dh;
    float x = 0.f;
    if (r < nrows) {
      x = code_f32(q[(((size_t)s * R + r0 + r) * H + h) * Dh + i - r * Dh]);
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

  constexpr bool two = ST == 2;
  if (nk > 0) issue(0, 0);
  for (int kk = 0; kk < nk; ++kk) {
    const int st = two ? kk & 1 : 0;
    if (two && kk + 1 < nk) {
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
    if (!two && kk + 1 < nk) issue(kk + 1, 0);
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
          smem_raw + lay.q_bytes + w * lay.per_warp + lay.ring + lay.sc);
      mw[w] = wp[r];
      M = fmaxf(M, mw[w]);
    }
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const unsigned char* wb = smem_raw + lay.q_bytes + w * lay.per_warp;
      const float wt = mw[w] <= kNegInf ? 0.f : expf(mw[w] - M);
      L += wt * reinterpret_cast<const float*>(wb + lay.ring + lay.sc)[MR + r];
      a += wt * reinterpret_cast<const float*>(wb)[r * Dh + d];
    }
    const size_t row = ((size_t)s * R + r0 + r) * H + h;
    if (parts == 1) {
      out[row * Dh + d] = from_f32<TQ>(a / fmaxf(L, 1e-30f));
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
// max(l, 1e-30) in q's type. One warp a row.
template <typename TQ>
__global__ void __launch_bounds__(kSplitThreads)
paged_merge_kernel(const float* __restrict__ ws, TQ* __restrict__ out,
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
    out[(size_t)row * Dh + d] = from_f32<TQ>(a / den);
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

template <typename TQ, typename TP, int MR, int NDV, int ST>
cudaError_t split_launch_stages(const void* q, const void* k_pool,
                                const void* v_pool, const float* k_scale,
                                const float* v_scale, const int* tables,
                                const int* base, int base_scalar, void* out,
                                float* ws, int parts, int S, int R, int H,
                                int Dh, int NB, int Bt, int MAXB, float scale,
                                int scale_in_q, cudaStream_t stream) {
  const SplitLayout<MR> lay(Dh, sizeof(TP));
  if (lay.stages != ST) return cudaErrorInvalidValue;
  const int smem = lay.bytes();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_split_kernel<TQ, TP, MR, NDV, ST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int epp = (MAXB + parts - 1) / parts;
  const dim3 grid(parts, ((R + MR - 1) / MR) * H, S);
  paged_split_kernel<TQ, TP, MR, NDV, ST>
      <<<grid, kSplitThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pool),
      static_cast<const TP*>(v_pool), k_scale, v_scale, tables, base,
      base_scalar, static_cast<TQ*>(out), ws, R, H, Dh, NB, Bt, MAXB, parts,
      epp, scale, scale_in_q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || parts == 1) return e;
  const int rows = S * R * H;
  paged_merge_kernel<TQ><<<(rows + kSplitWarps - 1) / kSplitWarps,
                           kSplitThreads, 0, stream>>>(
      ws, static_cast<TQ*>(out), rows, parts, Dh);
  return cudaGetLastError();
}

// the ring's stages as a template argument: one only where two would
// not fit, which only f32 pools past Dh 64 can reach
template <typename TQ, typename TP, int MR, int NDV>
cudaError_t split_launch(const void* q, const void* k_pool, const void* v_pool,
                         const float* k_scale, const float* v_scale,
                         const int* tables, const int* base, int base_scalar,
                         void* out, float* ws, int parts, int S, int R, int H,
                         int Dh, int NB, int Bt, int MAXB, float scale,
                         int scale_in_q, cudaStream_t stream) {
#define STAGES(ST)                                                          \
  split_launch_stages<TQ, TP, MR, NDV, ST>(                                 \
      q, k_pool, v_pool, k_scale, v_scale, tables, base, base_scalar, out, \
      ws, parts, S, R, H, Dh, NB, Bt, MAXB, scale, scale_in_q, stream)
  if constexpr (sizeof(TP) == 4 && NDV == 4) {
    if (SplitLayout<MR>(Dh, sizeof(TP)).stages == 1) return STAGES(1);
  }
  return STAGES(2);
#undef STAGES
}

// the arguments every launch below passes on
#define SPLIT_PARAMS                                                        \
  const void *q, const void *k_pool, const void *v_pool,                    \
      const float *k_scale, const float *v_scale, const int *tables,        \
      const int *base, int base_scalar, void *out, float *ws, int parts,    \
      int S, int R, int H, int Dh, int NB, int Bt, int MAXB, float scale,   \
      int scale_in_q, cudaStream_t stream
#define SPLIT_ARGS                                                          \
  q, k_pool, v_pool, k_scale, v_scale, tables, base, base_scalar, out, ws, \
      parts, S, R, H, Dh, NB, Bt, MAXB, scale, scale_in_q, stream

template <typename TQ, typename TP>
cudaError_t split_rows_dims(SPLIT_PARAMS) {
#define SPLIT(MR, NDV) split_launch<TQ, TP, MR, NDV>(SPLIT_ARGS)
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

// pool_type: 0 = the pools hold TQ, 1 = int8 codes, 2 = e4m3 codes; a
// 16-byte copy must hold whole elements of a row
template <typename TQ>
cudaError_t split_pools(int pool_type, SPLIT_PARAMS) {
  switch (pool_type) {
    case 0:
      return Dh % (16 / (int)sizeof(TQ)) ? cudaErrorInvalidValue
                                          : split_rows_dims<TQ, TQ>(SPLIT_ARGS);
    case 1:
      return Dh % 16 ? cudaErrorInvalidValue
                     : split_rows_dims<TQ, int8_t>(SPLIT_ARGS);
    case 2:
      return Dh % 16 ? cudaErrorInvalidValue
                     : split_rows_dims<TQ, __nv_fp8_e4m3>(SPLIT_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
}

// C interface bound with ctypes (parallel/paged_attention.py). Pointers
// and the stream come from torch; `base` may be null, in which case
// every slot's window starts at `base_scalar` (the one-slot prefill
// chunk). q and out are bf16 (`is_bf16` 1) or f32 (0); the pools hold
// q's type (`pool_type` 0, scales null) or int8 (1) / e4m3 (2) codes
// with f32 scales [NB, H]. Each returns the cudaError_t of its launch
// (0 = launched).

// The number of context partitions the split kernel takes at these
// shapes (set by the shapes alone, never by positions or table contents).
extern "C" int paged_split_parts(int S, int R, int H, int Bt, int MAXB) {
  if (S < 1 || R < 1 || H < 1 || Bt < 1 || MAXB < 1) return -1;
  return split_parts(S, R, H, Bt, MAXB);
}

// Dynamic shared memory (bytes per CTA) the split kernel requests for R
// window rows of head width Dh over pools of `pool_type` with q in bf16
// (`is_bf16` 1) or f32 (0).
extern "C" int paged_split_shared_bytes(int is_bf16, int pool_type, int R,
                                        int Dh) {
  if (pool_type < 0 || pool_type > 2 || R < 1 || Dh < 1 || Dh > kMaxDh)
    return -1;
  const int esize = pool_type != 0 ? 1
                    : is_bf16      ? (int)sizeof(bf16)
                                   : (int)sizeof(float);
  switch (split_rows(R)) {
    case 1:
      return SplitLayout<1>(Dh, esize).bytes();
    case 4:
      return SplitLayout<4>(Dh, esize).bytes();
    default:
      return SplitLayout<16>(Dh, esize).bytes();
  }
}

// q and out through the split kernel and, with more than one partition,
// the merge. `parts` is paged_split_parts(S, R, H, Bt, MAXB); with parts
// > 1, `workspace` holds S * R * H * parts * (Dh + 2) f32.
extern "C" int paged_attention_split_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* base, int base_scalar, void* out, void* workspace, int parts,
    int is_bf16, int pool_type, int S, int R, int H, int Dh, int NB, int Bt,
    int MAXB, float scale, int scale_in_q, int device, void* stream) {
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
  pool_type, q, k_pool, v_pool, ksc, vsc, tbl, bs, base_scalar, out, ws,      \
      parts, S, R, H, Dh, NB, Bt, MAXB, scale, scale_in_q, st
  e = is_bf16 ? split_pools<bf16>(ARGS) : split_pools<float>(ARGS);
#undef ARGS
  return (int)e;
}
#undef SPLIT_ARGS
#undef SPLIT_PARAMS
