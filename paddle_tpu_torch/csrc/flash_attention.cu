// Flash attention for Hopper (sm_90a): the forward pass and the two
// backward passes of blockwise online-softmax attention over
// [B, T, H, D] tensors (k/v [B, S, H, D]), read through their strides —
// no copy to a head-major layout.
//
// Replaces the TPU kernels of paddle_tpu/parallel/flash_attention.py:
//   flash_forward      <- `_fa_kernel` (:86, launched by `_fa_forward`)
//   flash_backward_kv  <- `_fa_bwd_kv_kernel` (:200, from `_flash_bwd`)
//   flash_backward_q   <- `_fa_bwd_q_kernel` (:245, from `_flash_bwd`)
// Same function and rounding points: f32 scores scaled after QK^T, the
// NEG_INF causal fill (kernel_utils.causal_fill) with the exact guards,
// running (m, l, acc) in f32, lse = m + log(max(l, 1e-30)); P rounded to
// the input dtype before P.V and P^T.g, dS = P * (g.V^T - delta) * scale
// rounded to the input dtype before dS^T.Q and dS.K.
//
// What bounds it on this card: at the training shape (T = S = 1024,
// D = 64, causal) the forward must move ~34 MB and do ~8.6 GFLOP, the
// backward passes ~13-17 GFLOP each — so with bf16 tensor cores the
// passes sit near the compute/bandwidth balance point, and with f32
// math on the CUDA cores (this version) they are compute-bound, at the
// 67 TFLOP/s f32 peak at best. The design:
//   * each output tile is owned by one CTA; the TPU's sequential grid
//     axis becomes a loop inside it, so no sums cross CTAs — no atomics,
//     deterministic results:
//       forward  — one CTA per (b*h, 64-row q tile), looping k tiles;
//       dK/dV    — one CTA per (b*h, 64-row k tile), looping q tiles;
//       dQ       — one CTA per (b*h, 64-row q tile), looping k tiles;
//   * the causal skip is a loop bound, not a predicate: forward and dQ
//     stop at the diagonal tile, dK/dV starts at it; q tiles are issued
//     longest first so the causal triangle's tail does not idle SMs;
//   * tiles are staged in shared memory as f32 with 16-byte global
//     loads (each row's D values are one contiguous segment); rows are
//     padded to D+1 words so both operand walks are bank-conflict free;
//   * 256 threads as a 16x16 grid, each owning a 4x4 micro-tile of the
//     64x64 score tile (rows ty+16i, cols tx+16j) and 4 x D/16 outputs:
//     per shared load ~2 FMAs, row statistics reduced with half-warp
//     shuffles (a row's 16 owners sit in one half-warp);
//   * ragged edges (T = 100, S = 384, ...) are masked in the kernel:
//     rows past T or S load as zeros, their probabilities are forced to
//     0 and they are never written.
// Left for later work: mma.sync/wgmma on the tensor cores (bf16), cp.async
// or TMA double buffering, and register-resident P between products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTile = 64;          // rows of a q or k tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLdP = kTile + 1;    // padded row of a [64, 64] f32 tile
constexpr float kNegInf = -1e30f;  // parallel/kernel_utils.py NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// x rounded to T's precision (round to nearest even), as astype(T) does
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T>
__device__ void unpack16(const uint4& u, float* dst);
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

// reductions over the 16 lanes of a half-warp (one row's owners)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Stage rows [r0, r0 + 64) of one (b, h) slice into dst [64][ld] as f32;
// rows at or past `len` are zeros. `src` points at (b, row 0, h, 0) and
// consecutive rows are `rs` elements apart.
template <typename T>
__device__ void load_tile(float* dst, const T* __restrict__ src, int r0,
                          int len, size_t rs, int D, int ld) {
  constexpr int epc = 16 / sizeof(T);  // elements per 16-byte chunk
  const int cpr = D / epc;             // chunks per row
  for (int c = threadIdx.x; c < kTile * cpr; c += kThreads) {
    const int t = c / cpr;
    const int part = c - t * cpr;
    float f[8];
    if (r0 + t < len) {
      const uint4 u = *reinterpret_cast<const uint4*>(
          src + (size_t)(r0 + t) * rs + part * epc);
      unpack16<T>(u, f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < epc; ++e) dst[t * ld + part * epc + e] = f[e];
  }
}

// acc[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d] over two staged
// [64][ld] tiles: one 4x4 micro-tile of a 64x64 product A.B^T
__device__ __forceinline__ void row_dot(const float* A, const float* B,
                                        int ld, int D, int ty, int tx,
                                        float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const float* a = A + ty * ld;
  const float* b = B + tx * ld;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[16 * i * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[16 * j * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// ---------------------------------------------------------------------
// forward: o and lse for one (b*h, q tile)
// ---------------------------------------------------------------------
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int Tq, int S, int D,
                     float scale, int causal) {
  constexpr int NJ = DM / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;
  float* sK = sQ + kTile * ld;
  float* sV = sK + kTile * ld;
  float* sP = sV + kTile * ld;  // [64][kLdP]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest first
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t rs = (size_t)H * D;
  const T* qb = q + ((size_t)b * Tq * H + h) * D;
  const T* kb = k + ((size_t)b * S * H + h) * D;
  const T* vb = v + ((size_t)b * S * H + h) * D;

  load_tile<T>(sQ, qb, q0, Tq, rs, D, ld);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  int nk = (S + kTile - 1) / kTile;
  if (causal) nk = min(nk, (q0 + kTile - 1) / kTile + 1);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous step is done with sK, sV, sP
    load_tile<T>(sK, kb, k0, S, rs, D, ld);
    load_tile<T>(sV, vb, k0, S, rs, D, ld);
    __syncthreads();

    float s[4][4];
    row_dot(sQ, sK, ld, D, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool keep = c < S && (!causal || r >= c);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      mc = half_max(mc);
      const float m_new = fmaxf(m[i], mc);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // exact guard: a masked score contributes exactly 0
        const float p = s[i][j] <= kNegInf ? 0.f : expf(s[i][j] - m_new);
        sum += p;
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = round_to<T>(p);
      }
      sum = half_sum(sum);
      const float alpha = m[i] <= kNegInf ? 0.f : expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P.V over this k tile (only its real rows)
    const int kv_rows = min(kTile, S - k0);
    for (int c = 0; c < kv_rows; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        vv[j] = tx + 16 * j < D ? sV[c * ld + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + ((size_t)(b * Tq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(orow + d, acc[i][j] / denom);
    }
    if (tx == 0) lse[(size_t)bh * Tq + r] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------
// backward, shared: P and dS for one (q tile, k tile) pair, micro-tile
// rows q0 + ty + 16i, cols k0 + tx + 16j
// ---------------------------------------------------------------------
__device__ __forceinline__ void probs_and_ds(
    const float* sQ, const float* sG, const float* sK, const float* sV,
    const float* sL, const float* sD, int ld, int D, int ty, int tx, int q0,
    int k0, int Tq, int S, float scale, int causal, float p[4][4],
    float ds[4][4]) {
  float dp[4][4];
  row_dot(sQ, sK, ld, D, ty, tx, p);
  row_dot(sG, sV, ld, D, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const float lse_r = sL[ty + 16 * i];
    const float delta_r = sD[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = k0 + tx + 16 * j;
      const bool keep = r < Tq && c < S && (!causal || r >= c);
      // exp(NEG_INF - lse) is exactly 0: masked taps drop out
      p[i][j] = keep ? expf(p[i][j] * scale - lse_r) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - delta_r) * scale;
    }
  }
}

// lse / delta rows [r0, r0 + 64) of slice bh into shared (0 past Tq)
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int Tq) {
  for (int t = threadIdx.x; t < kTile; t += kThreads)
    dst[t] = r0 + t < Tq ? src[r0 + t] : 0.f;
}

// ---------------------------------------------------------------------
// dK/dV for one (b*h, k tile), looping q tiles from the diagonal
// ---------------------------------------------------------------------
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_backward_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int H,
                         int Tq, int S, int D, float scale, int causal) {
  constexpr int NJ = DM / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sK = smem;
  float* sV = sK + kTile * ld;
  float* sQ = sV + kTile * ld;
  float* sG = sQ + kTile * ld;
  float* sP = sG + kTile * ld;   // [64 q][kLdP]
  float* sS = sP + kTile * kLdP;  // dS, [64 q][kLdP]
  float* sL = sS + kTile * kLdP;
  float* sD = sL + kTile;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * kTile;  // causal: low k tiles are longest
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t rs = (size_t)H * D;
  const T* qb = q + ((size_t)b * Tq * H + h) * D;
  const T* gb = g + ((size_t)b * Tq * H + h) * D;
  const T* kb = k + ((size_t)b * S * H + h) * D;
  const T* vb = v + ((size_t)b * S * H + h) * D;
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;

  load_tile<T>(sK, kb, k0, S, rs, D, ld);
  load_tile<T>(sV, vb, k0, S, rs, D, ld);
  float dka[4][NJ], dva[4][NJ];  // rows k0 + ty + 16i, cols tx + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int nq = (Tq + kTile - 1) / kTile;
  const int q_first = causal ? k0 / kTile : 0;
  for (int qt = q_first; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T>(sQ, qb, q0, Tq, rs, D, ld);
    load_tile<T>(sG, gb, q0, Tq, rs, D, ld);
    load_rows(sL, lb, q0, Tq);
    load_rows(sD, db, q0, Tq);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs_and_ds(sQ, sG, sK, sV, sL, sD, ld, D, ty, tx, q0, k0, Tq, S, scale,
                 causal, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int at = (ty + 16 * i) * kLdP + tx + 16 * j;
        sP[at] = round_to<T>(p[i][j]);
        sS[at] = round_to<T>(ds[i][j]);
      }
    __syncthreads();

    // dV += P^T g and dK += dS^T Q over this q tile's real rows
    const int q_rows = min(kTile, Tq - q0);
    for (int r = 0; r < q_rows; ++r) {
      float pv[4], sv[4], gv[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[r * kLdP + ty + 16 * i];
        sv[i] = sS[r * kLdP + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const bool in = tx + 16 * j < D;
        gv[j] = in ? sG[r * ld + tx + 16 * j] : 0.f;
        qv[j] = in ? sQ[r * ld + tx + 16 * j] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dva[i][j] = fmaf(pv[i], gv[j], dva[i][j]);
          dka[i][j] = fmaf(sv[i], qv[j], dka[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= S) continue;
    const size_t row = ((size_t)(b * S + c) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        store(dk + row + d, dka[i][j]);
        store(dv + row + d, dva[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// dQ for one (b*h, q tile), looping k tiles up to the diagonal
// ---------------------------------------------------------------------
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
flash_backward_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        T* __restrict__ dq, int H, int Tq, int S, int D,
                        float scale, int causal) {
  constexpr int NJ = DM / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sQ = smem;
  float* sG = sQ + kTile * ld;
  float* sK = sG + kTile * ld;
  float* sV = sK + kTile * ld;
  float* sS = sV + kTile * ld;  // dS, [64 q][kLdP]
  float* sL = sS + kTile * kLdP;
  float* sD = sL + kTile;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // longest first
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const size_t rs = (size_t)H * D;
  const T* qb = q + ((size_t)b * Tq * H + h) * D;
  const T* gb = g + ((size_t)b * Tq * H + h) * D;
  const T* kb = k + ((size_t)b * S * H + h) * D;
  const T* vb = v + ((size_t)b * S * H + h) * D;

  load_tile<T>(sQ, qb, q0, Tq, rs, D, ld);
  load_tile<T>(sG, gb, q0, Tq, rs, D, ld);
  load_rows(sL, lse + (size_t)bh * Tq, q0, Tq);
  load_rows(sD, delta + (size_t)bh * Tq, q0, Tq);
  float dqa[4][NJ];  // rows q0 + ty + 16i, cols tx + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dqa[i][j] = 0.f;

  int nk = (S + kTile - 1) / kTile;
  if (causal) nk = min(nk, (q0 + kTile - 1) / kTile + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T>(sK, kb, k0, S, rs, D, ld);
    load_tile<T>(sV, vb, k0, S, rs, D, ld);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs_and_ds(sQ, sG, sK, sV, sL, sD, ld, D, ty, tx, q0, k0, Tq, S, scale,
                 causal, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sS[(ty + 16 * i) * kLdP + tx + 16 * j] = round_to<T>(ds[i][j]);
    __syncthreads();

    // dQ += dS K over this k tile's real rows
    const int kv_rows = min(kTile, S - k0);
    for (int c = 0; c < kv_rows; ++c) {
      float sv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(ty + 16 * i) * kLdP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        kv[j] = tx + 16 * j < D ? sK[c * ld + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dqa[i][j] = fmaf(sv[i], kv[j], dqa[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Tq) continue;
    T* row = dq + ((size_t)(b * Tq + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(row + d, dqa[i][j]);
    }
  }
}

// ---------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------

struct Shape {
  int B, H, Tq, S, D;
  float scale;
  int causal;
};

bool valid(const Shape& s, int elem) {
  return s.B > 0 && s.H > 0 && s.Tq > 0 && s.S > 0 && s.D > 0 &&
         s.D <= 128 && s.D % (16 / elem) == 0 && s.B * s.H <= 65535;
}

// shared bytes: `tiles` [64][D+1] tiles, `ptiles` [64][65] tiles and
// `rows` 64-float row vectors
size_t smem_bytes(int D, int tiles, int ptiles, int rows) {
  return sizeof(float) * ((size_t)tiles * kTile * (D + 1) +
                          (size_t)ptiles * kTile * kLdP +
                          (size_t)rows * kTile);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int DM>
cudaError_t forward(const void* q, const void* k, const void* v, void* o,
                    float* lse, const Shape& s, cudaStream_t st) {
  const size_t smem = smem_bytes(s.D, 3, 1, 0);
  cudaError_t e = allow_smem(flash_forward_kernel<T, DM>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Tq + kTile - 1) / kTile, s.B * s.H);
  flash_forward_kernel<T, DM><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, s.H, s.Tq, s.S, s.D,
      s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, int DM>
cudaError_t backward_kv(const void* q, const void* k, const void* v,
                        const void* g, const float* lse, const float* delta,
                        void* dk, void* dv, const Shape& s, cudaStream_t st) {
  const size_t smem = smem_bytes(s.D, 4, 2, 2);
  cudaError_t e = allow_smem(flash_backward_kv_kernel<T, DM>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.S + kTile - 1) / kTile, s.B * s.H);
  flash_backward_kv_kernel<T, DM><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), s.H, s.Tq, s.S, s.D, s.scale,
      s.causal);
  return cudaGetLastError();
}

template <typename T, int DM>
cudaError_t backward_q(const void* q, const void* k, const void* v,
                       const void* g, const float* lse, const float* delta,
                       void* dq, const Shape& s, cudaStream_t st) {
  const size_t smem = smem_bytes(s.D, 4, 1, 2);
  cudaError_t e = allow_smem(flash_backward_q_kernel<T, DM>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Tq + kTile - 1) / kTile, s.B * s.H);
  flash_backward_q_kernel<T, DM><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dq), s.H, s.Tq, s.S, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

// dtype x D-bucket dispatch: the D-bucket sizes the register
// accumulators (D/16 columns per thread); D itself stays a runtime value
#define FLASH_DISPATCH(is_bf16, D, CALL)                               \
  ((is_bf16) ? ((D) <= 64 ? CALL(__nv_bfloat16, 64) : CALL(__nv_bfloat16, 128)) \
             : ((D) <= 64 ? CALL(float, 64) : CALL(float, 128)))

}  // namespace

// C interface bound with ctypes (parallel/flash_attention.py). q, g, o,
// dq are [B, T, H, D]; k, v, dk, dv [B, S, H, D], all contiguous in the
// input dtype (bf16 or f32); lse and delta [B, H, T] f32. Each returns
// the cudaError_t of its launch (0 = launched) on `stream`.
extern "C" int flash_forward(const void* q, const void* k, const void* v,
                             void* o, void* lse, int is_bf16, int B, int H,
                             int T, int S, int D, float scale, int causal,
                             int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Shape s{B, H, T, S, D, scale, causal};
  if (!valid(s, is_bf16 ? 2 : 4)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define CALL(TT, DM) forward<TT, DM>(q, k, v, o, l, s, st)
  e = FLASH_DISPATCH(is_bf16, D, CALL);
#undef CALL
  return (int)e;
}

extern "C" int flash_backward_kv(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int is_bf16, int B, int H, int T, int S,
                                 int D, float scale, int causal, int device,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Shape s{B, H, T, S, D, scale, causal};
  if (!valid(s, is_bf16 ? 2 : 4)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define CALL(TT, DM) backward_kv<TT, DM>(q, k, v, g, l, dl, dk, dv, s, st)
  e = FLASH_DISPATCH(is_bf16, D, CALL);
#undef CALL
  return (int)e;
}

extern "C" int flash_backward_q(const void* q, const void* k, const void* v,
                                const void* g, const void* lse,
                                const void* delta, void* dq, int is_bf16,
                                int B, int H, int T, int S, int D,
                                float scale, int causal, int device,
                                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const Shape s{B, H, T, S, D, scale, causal};
  if (!valid(s, is_bf16 ? 2 : 4)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define CALL(TT, DM) backward_q<TT, DM>(q, k, v, g, l, dl, dq, s, st)
  e = FLASH_DISPATCH(is_bf16, D, CALL);
#undef CALL
  return (int)e;
}
