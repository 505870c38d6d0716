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
// clamps), its rows arrive as 16-byte loads of 16 codes, convert to f32
// exactly (int8 by cast, e4m3 through cuda_fp8.h) and are multiplied by
// the scale in f32 before they reach the shared tiles, as the TPU kernel
// multiplies before its dot. Everything after staging is the unquantized
// path's; no dequantized pool ever exists in device memory.
//
// What bounds it on this card: HBM bytes. Per (slot, head) the kernel
// reads every K/V row it attends exactly once and does 4*Dh flops per
// (row, depth) pair — a few flops per byte, far below the ~295 flop/B
// where an H100 turns compute-bound. The design therefore spends its
// effort on moving each K/V byte once, coalesced, and never
// materialising the gathered per-slot view the XLA "gather" form writes
// and re-reads:
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
// Left for later work: cp.async/TMA double buffering, wgmma for the
// prefill tile, and split-K over the context for small decode batches
// (one CTA per (slot, head) leaves SMs idle when S*H < 132).

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

// C interface bound with ctypes (parallel/paged_attention.py). Pointers
// and the stream come from torch; `base` may be null, in which case
// every slot's window starts at `base_scalar` (the one-slot prefill
// chunk). q and out are f32 or bf16 (`is_bf16`); the pools hold q's type
// (`pool_type` 0, scales null) or int8 (1) / e4m3 (2) codes with f32
// scales [NB, H]. Returns the cudaError_t of the launch (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* base, int base_scalar, void* out, int is_bf16, int pool_type,
    int S, int R, int H, int Dh, int NB, int Bt, int MAXB, float scale,
    int scale_in_q, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (S == 0 || R == 0 || H == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(tables);
  const int* bs = static_cast<const int*>(base);
  e = is_bf16 ? launch_pool<__nv_bfloat16>(pool_type, q, k_pool, v_pool, ksc,
                                           vsc, tbl, bs, base_scalar, out, S,
                                           R, H, Dh, NB, Bt, MAXB, scale,
                                           scale_in_q, st)
              : launch_pool<float>(pool_type, q, k_pool, v_pool, ksc, vsc,
                                   tbl, bs, base_scalar, out, S, R, H, Dh, NB,
                                   Bt, MAXB, scale, scale_in_q, st);
  return (int)e;
}
