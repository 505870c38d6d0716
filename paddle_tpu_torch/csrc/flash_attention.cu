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
// Three designs share the entry points:
//
// bf16 (all three passes): FlashAttention-2's structure on the tensor
// cores (`flash_forward_mma_kernel`, `flash_backward_kv_mma_kernel`,
// `flash_backward_q_mma_kernel`).
//   * every product is mma.sync m16n8k16 bf16 -> f32, its operands read
//     from shared memory by ldmatrix (.trans where the product needs the
//     transpose); accumulators stay in registers;
//   * score tiles never leave registers: the m16n8 accumulator of
//     S = Q.K^T, converted to bf16, is the A fragment of P.V (the
//     conversion is the TPU kernel's rounding of P); row max and sum
//     reduce over the quad of lanes that holds a row. dK/dV computes the
//     transposed tiles S^T = K.Q^T and dP^T = V.g^T, so P^T and dS^T are
//     already the A fragments of dV += P^T.g and dK += dS^T.Q; dQ
//     computes S and dP = g.V^T untransposed, so dS is the A fragment of
//     dQ += dS.K, with K through ldmatrix.trans as V in the forward;
//   * the streamed tiles (forward and dQ: K and V; dK/dV: Q, g, lse and
//     delta) arrive by cp.async into a two-stage ring of bf16 tiles, the
//     next tile in flight while the current one is computed, one barrier
//     per step. Rows are padded by 8 elements so ldmatrix is free of bank
//     conflicts. Rows past T or S and columns past D (D pads to the 32,
//     64 or 128 bucket) are zero-filled by cp.async's src-size;
//   * a CTA owns 128 rows (8 warps x 16): forward and dQ q rows, stepping
//     64 keys as two 32-key halves (so the score tiles fit beside the
//     accumulators in 128 registers); dK/dV key rows, stepping 64 q rows
//     from the diagonal in 16-row slices. The forward's Q fragments go to
//     registers once and Q's shared tile becomes a ring stage; dK/dV
//     reads its K and V fragments, and dQ its Q and g fragments, from
//     shared memory at each use, which keeps them within 128 registers.
//     dQ keeps the lse and delta of a warp's rows in registers (no online
//     softmax: P = exp(S * scale - lse)). At D <= 64 two CTAs share an
//     SM; q tiles are issued longest first;
//   * interior tiles skip the mask predicate, only edge and diagonal
//     tiles evaluate it; a warp skips a tile its rows cannot attend;
//   * each output tile is owned by one CTA, no atomics: deterministic.
//   What bounds them: at the training shape (T = S = 1024, D = 64,
//   causal) the forward's least time is set by its bytes (~34 MB,
//   ~8.6 GFLOP), dK/dV's and dQ's by their operations (~17.2 and ~12.9
//   GFLOP). All run well above that: mma.sync reaches only part of the
//   989 TFLOP/s bf16 peak, and with 8 warps each re-reading the streamed
//   tile, ldmatrix's shared-memory reads (about one 512-byte x4 load per
//   two mma) are the next limit. wgmma, TMA and warp specialisation are
//   the step after this one.
//
// f32 forward: the same structure on the tensor cores in 3xTF32
// (`flash_forward_tf32x3_kernel`). An f32 operand x is split into two
// TF32 values, hi = rna(x) and lo = rna(x - hi) (cvt.rna's rounding, in
// integer ops), and each product of
// tiles a.b is three mma.sync m16n8k8 .tf32 products accumulated in
// f32, the small terms first: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi. That
// holds f32's accuracy (about 2^-22 of each product; one TF32 product
// alone keeps about 2^-11) at several times the CUDA cores' FMA rate.
//   * Q.K^T and P.V both take the split; P stays f32 (the TPU kernel's
//     astype(f32) is the identity) and is split like any operand;
//   * Q and K fragments come from ldmatrix (b16 x4 over f32 rows: lane
//     i gets word i % 4 of row i / 4, the tf32 A and B layouts); V has
//     no 32-bit transposing load, so its B fragments are 32-bit shared
//     loads. The m16n8 accumulator holds keys 2t, 2t + 1 of a row where
//     the A fragment wants columns t, t + 4, so keys are permuted
//     within each group of eight (column t is key 2t, t + 4 is 2t + 1)
//     and V is read with the same permutation: P never leaves its lane;
//   * tiles are [rows][D + 4] f32: ldmatrix's rows and the V loads are
//     free of bank conflicts. The CTA's Q tile stays in shared memory
//     (its fragments split at each use) beside the two-stage K/V ring:
//     104,448 B at D 64, two CTAs an SM;
//   * numerics and edges as the bf16 forward: scale after QK^T, the
//     NEG_INF fill with its exact guards, lse = m + log(max(l, 1e-30)),
//     ragged T and S, D padded to the 32/64/128 bucket; one owner per
//     output tile, deterministic.
//   What bounds it: the tensor cores at three TF32 products per f32
//   product (3 x 8.6 GFLOP at the training shape over 494.7 TFLOP/s
//   dense TF32), and ahead of them the splits (two integer ops, a
//   subtract and two more per operand element at each use) on the ALUs.
//
// f32 backward (dK/dV and dQ): the CUDA-core design, f32 FMA.
//   * each output tile is owned by one CTA; the TPU's sequential grid
//     axis becomes a loop inside it, so no sums cross CTAs — no atomics,
//     deterministic results:
//       dK/dV    — one CTA per (b*h, 64-row k tile), looping q tiles;
//       dQ       — one CTA per (b*h, 64-row q tile), looping k tiles;
//   * the causal skip is a loop bound, not a predicate: dQ stops at the
//     diagonal tile, dK/dV starts at it; q tiles are issued longest
//     first so the causal triangle's tail does not idle SMs;
//   * tiles are staged in shared memory as f32 with 16-byte global
//     loads (each row's D values are one contiguous segment); rows are
//     padded to D+1 words so both operand walks are bank-conflict free;
//   * 256 threads as a 16x16 grid, each owning a 4x4 micro-tile of the
//     64x64 score tile (rows ty+16i, cols tx+16j) and 4 x D/16 outputs;
//   * ragged edges (T = 100, S = 384, ...) are masked in the kernel:
//     rows past T or S load as zeros, their probabilities are forced to
//     0 and they are never written.
//   What bounds them: f32 math on the CUDA cores, compute-bound at the
//   67 TFLOP/s f32 peak at best. They read the 3xTF32 forward's lse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kTile = 64;          // rows of a q or k tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLdP = kTile + 1;    // padded row of a [64, 64] f32 tile
constexpr float kNegInf = -1e30f;  // parallel/kernel_utils.py NEG_INF

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
// x rounded to T's precision, as astype(T) does (f32: unchanged)
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
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
// CUDA cores, f32: dK/dV for one (b*h, k tile), looping q tiles from the
// diagonal
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
// CUDA cores, f32: dQ for one (b*h, q tile), looping k tiles up
// to the diagonal
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
// bf16 on the tensor cores: mma.sync helpers
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kRows = 16 * kMmaWarps;  // rows a CTA owns (16 per warp)
constexpr int kStep = 64;              // rows of a streamed tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared without a register round trip; with
// `in` false nothing is read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a.b over one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 (nearest even) in one register, lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

// reductions over the quad of lanes that holds one accumulator row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ldmatrix x4 lane addresses into a row-major [rows][DM + 8] bf16 tile,
// as byte offsets from the tile's shared address: the lane's part (a, b
// or bt) plus the block's, `blk(r, c)`, a constant once loops unroll.
//   a  — the A fragment of the 16x16 block at (r, c);
//   b  — {b0, b1} of n-tiles r and r + 8 (tile rows are n, the 16
//        columns from c are k), for x4 without .trans;
//   bt — {b0, b1} of n-tiles c and c + 8 (tile rows r.. are k, columns
//        are n), for x4 with .trans.
template <int DM>
struct Frag {
  static constexpr int P = DM + 8;  // padded row, elements
  uint32_t a, b, bt;
  __device__ explicit Frag(int lane)
      : a(2 * ((lane & 15) * P + (lane >> 4) * 8)),
        b(2 * (((lane & 7) + (lane >> 4) * 8) * P + ((lane >> 3) & 1) * 8)),
        bt(2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8)) {
  }
  __device__ static constexpr uint32_t blk(int r, int c) {
    return 2 * (r * P + c);
  }
};

// Queue the copy of rows [r0, r0 + ROWS) of one (b, h) slice into the
// [ROWS][DM + 8] bf16 tile at shared address `dst`, in 16-byte chunks;
// rows at or past `len` and columns at or past D are zero-filled. `src`
// points at (b, row 0, h, 0) and consecutive rows are `rs` elements apart.
template <int ROWS, int DM>
__device__ __forceinline__ void cp_tile(uint32_t dst, const bf16* src,
                                        int r0, int len, int rs, int D) {
  constexpr int kChunks = DM / 8;  // per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int part = c % kChunks;
    const bool in = r0 + r < len && part * 8 < D;
    cp_async16(dst + Frag<DM>::blk(r, part * 8),
               in ? src + (size_t)(r0 + r) * rs + part * 8 : src, in);
  }
}

// ---------------------------------------------------------------------
// bf16 forward on the tensor cores: o and lse for one (b*h, 128-row q
// tile); warp w owns q rows 16w..16w+15 of the tile. Each 64-key stage
// is taken as two 32-key halves, each a full online-softmax update: the
// half-width score tile keeps the kernel within 128 registers (two CTAs
// per SM) without spills.
// ---------------------------------------------------------------------
constexpr int kHalf = kStep / 2;

template <int DM>
__global__ void __launch_bounds__(kMmaThreads, DM <= 64 ? 2 : 1)
flash_forward_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ o,
                         float* __restrict__ lse, int H, int Tq, int S,
                         int D, float scale, int causal) {
  constexpr int KD = DM / 16;  // k-steps of Q.K^T over the head dim
  constexpr int NO = DM / 8;   // n-tiles of o
  constexpr uint32_t kTileBytes = kStep * (DM + 8) * sizeof(bf16);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // ring stage s holds K then V, [kStep][DM + 8] each; Q [kRows][DM + 8]
  // sits in stage 1 until its fragments are in registers
  const uint32_t ring = smem_addr(smem_raw);
  const uint32_t sQ = ring + 2 * kTileBytes;
  const Frag<DM> fr(threadIdx.x & 31);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // accumulator rows gr and gr + 8
  const int tc = lane & 3;   // accumulator columns 2tc, 2tc + 1
  const int qw = q0 + 16 * warp;
  const int rs = H * D;  // row stride, elements
  const bf16* qb = q + ((size_t)b * Tq * H + h) * D;
  const bf16* kb = k + ((size_t)b * S * H + h) * D;
  const bf16* vb = v + ((size_t)b * S * H + h) * D;

  cp_tile<kRows, DM>(sQ, qb, q0, Tq, rs, D);
  cp_commit();
  cp_tile<kStep, DM>(ring, kb, 0, S, rs, D);
  cp_tile<kStep, DM>(ring + kTileBytes, vb, 0, S, rs, D);
  cp_commit();
  int nk = (S + kStep - 1) / kStep;
  if (causal) nk = min(nk, (q0 + kRows - 1) / kStep + 1);

  cp_wait<1>();  // Q has landed; K and V of step 0 may still fly
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    ldsm4(qf[kd], sQ + fr.a + fr.blk(16 * warp, 16 * kd));

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kStep;
    cp_wait<0>();
    // step kt's tiles are visible to all, and every warp is done with
    // step kt - 1 (and with Q), whose stage the next copy refills
    __syncthreads();
    if (kt + 1 < nk) {
      const uint32_t nx = ring + ((kt + 1) & 1) * 2 * kTileBytes;
      cp_tile<kStep, DM>(nx, kb, k0 + kStep, S, rs, D);
      cp_tile<kStep, DM>(nx + kTileBytes, vb, k0 + kStep, S, rs, D);
      cp_commit();
    }
    const uint32_t sK = ring + (kt & 1) * 2 * kTileBytes;
    const uint32_t sV = sK + kTileBytes;

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kh = k0 + kHalf * hf;
      if (causal && kh > qw + 15) continue;  // no row of this warp attends

      // S = Q.K^T: 16 rows x 32 keys, n-tile j = keys kh + 8j..
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kf[4];
          ldsm4(kf, sK + fr.b + fr.blk(kHalf * hf + 16 * np, 16 * kd));
          mma(s[2 * np], qf[kd], kf[0], kf[1]);
          mma(s[2 * np + 1], qf[kd], kf[2], kf[3]);
        }

      // scale after the product; mask only where a key can be out of
      // reach (the ragged end of S, the causal diagonal)
      const bool edge = kh + kHalf > S || (causal && kh + kHalf - 1 > qw);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (edge) {
            const int c = kh + 8 * j + 2 * tc + (e & 1);
            const int r = qw + gr + 8 * (e >> 1);
            if (!(c < S && (!causal || r >= c))) x = kNegInf;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        alpha[i] = m[i] <= kNegInf ? 0.f : expf(m[i] - m_new);
        m[i] = m_new;
      }
      float sum[2] = {0.f, 0.f};
      uint32_t pp[4][2];  // P rounded to bf16: rows gr and gr + 8
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // exact guard: a masked score contributes exactly 0
          const float x = s[j][e];
          p[e] = x <= kNegInf ? 0.f : expf(x - m[e >> 1]);
          sum[e >> 1] += p[e];  // l sums P before its rounding
        }
        pp[j][0] = pack_bf16(p[0], p[1]);
        pp[j][1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // acc += P.V: P's accumulators, rounded to bf16, are the A fragments
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t pa[4] = {pp[2 * kk][0], pp[2 * kk][1],
                                pp[2 * kk + 1][0], pp[2 * kk + 1][1]};
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          uint32_t vf[4];
          ldsm4_t(vf, sV + fr.bt + fr.blk(kHalf * hf + 16 * kk, 16 * dp));
          mma(acc[2 * dp], pa, vf[0], vf[1]);
          mma(acc[2 * dp + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + gr + 8 * i;
    if (r >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* orow = o + ((size_t)(b * Tq + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * tc;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
    }
    if (tc == 0) lse[(size_t)bh * Tq + r] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------
// bf16 dK/dV on the tensor cores: one (b*h, 128-row k tile), stepping
// 64-row q tiles from the diagonal; warp w owns key rows 16w..16w+15
// ---------------------------------------------------------------------
// Shared memory of the dK/dV kernel: a two-stage ring, each stage the q
// and g tiles [kStep][P] then 64 lse and 64 delta floats, followed by the
// CTA's K and V tiles [kRows][P]. K and V fragments are read from shared
// memory at each use rather than held in registers: held, they push the
// kernel past 128 registers to one CTA per SM; read, it stays within 128
// and two CTAs share an SM, which ran faster on an H100.
template <int DM>
struct KvLayout {
  static constexpr int P = DM + 8;
  static constexpr uint32_t kTileBytes = kStep * P * sizeof(bf16);  // q, g
  static constexpr uint32_t kStage =
      2 * kTileBytes + 2 * kStep * sizeof(float);
  static constexpr uint32_t kBytes = 2 * kStage + 4 * kTileBytes;
};

template <int DM>
__global__ void __launch_bounds__(kMmaThreads, DM <= 64 ? 2 : 1)
flash_backward_kv_mma_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dk, bf16* __restrict__ dv,
                             int H, int Tq, int S, int D, float scale,
                             int causal) {
  using L = KvLayout<DM>;
  constexpr int KD = DM / 16;  // k-steps of K.Q^T over the head dim
  constexpr int NO = DM / 8;   // n-tiles of dk and dv
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t sK = base + 2 * L::kStage;
  const uint32_t sV = sK + 2 * L::kTileBytes;
  const Frag<DM> fr(threadIdx.x & 31);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kRows;  // causal: low k tiles are longest
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // accumulator rows (keys) gr and gr + 8
  const int tc = lane & 3;   // accumulator columns 2tc, 2tc + 1
  const int kw = k0 + 16 * warp;
  const int rs = H * D;  // row stride, elements
  const bf16* qb = q + ((size_t)b * Tq * H + h) * D;
  const bf16* gb = g + ((size_t)b * Tq * H + h) * D;
  const bf16* kb = k + ((size_t)b * S * H + h) * D;
  const bf16* vb = v + ((size_t)b * S * H + h) * D;
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;

  // q tile qt (rows 64qt..) with its lse and delta into ring stage st
  auto issue = [&](int qt, int st) {
    const int r0 = qt * kStep;
    const uint32_t at = base + st * L::kStage;
    cp_tile<kStep, DM>(at, qb, r0, Tq, rs, D);
    cp_tile<kStep, DM>(at + L::kTileBytes, gb, r0, Tq, rs, D);
    const int t = threadIdx.x & (kStep - 1);
    const bool in = r0 + t < Tq;
    const uint32_t row = at + 2 * L::kTileBytes + 4 * t;
    if (threadIdx.x < kStep)
      cp_async4(row, in ? lb + r0 + t : lb, in);
    else if (threadIdx.x < 2 * kStep)
      cp_async4(row + 4 * kStep, in ? db + r0 + t : db, in);
    cp_commit();
  };

  cp_tile<kRows, DM>(sK, kb, k0, S, rs, D);
  cp_tile<kRows, DM>(sV, vb, k0, S, rs, D);
  cp_commit();
  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int nq = (Tq + kStep - 1) / kStep;
  const int qt0 = causal ? k0 / kStep : 0;
  if (qt0 < nq) issue(qt0, 0);
  for (int qt = qt0; qt < nq; ++qt) {
    const int st = (qt - qt0) & 1;
    cp_wait<0>();
    __syncthreads();
    if (qt + 1 < nq) issue(qt + 1, st ^ 1);
    const int q0 = qt * kStep;
    if (causal && q0 + kStep - 1 < kw) continue;  // no q row reaches a key
    const uint32_t sQ = base + st * L::kStage;
    const uint32_t sG = sQ + L::kTileBytes;
    const float* sL = reinterpret_cast<const float*>(
        smem_raw + st * L::kStage + 2 * L::kTileBytes);
    const float* sD = sL + kStep;
    const bool edge =
        q0 + kStep > Tq || kw + 16 > S || (causal && q0 < kw + 15);

#pragma unroll
    for (int sub = 0; sub < kStep / 16; ++sub) {
      const int qs = 16 * sub;  // this 16-row slice of the q tile
      if (causal && q0 + qs + 15 < kw) continue;
      // S^T = K.Q^T and dP^T = V.g^T: 16 keys x 16 q rows, n-tile j =
      // q rows qs + 8j..
      float sp[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sp[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ka[4], va[4], bq[4], bg[4];
        ldsm4(ka, sK + fr.a + fr.blk(16 * warp, 16 * kd));
        ldsm4(va, sV + fr.a + fr.blk(16 * warp, 16 * kd));
        ldsm4(bq, sQ + fr.b + fr.blk(qs, 16 * kd));
        ldsm4(bg, sG + fr.b + fr.blk(qs, 16 * kd));
        mma(sp[0], ka, bq[0], bq[1]);
        mma(sp[1], ka, bq[2], bq[3]);
        mma(dp[0], va, bg[0], bg[1]);
        mma(dp[1], va, bg[2], bg[3]);
      }
      // P^T = exp(S^T * scale - lse) (exactly 0 where masked) and
      // dS^T = P^T * (dP^T - delta) * scale, per q column
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = qs + 8 * j + 2 * tc;
        const float2 lq = *reinterpret_cast<const float2*>(sL + qc);
        const float2 dq = *reinterpret_cast<const float2*>(sD + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool keep = true;
          if (edge) {
            const int qr = q0 + qc + (e & 1);
            const int kc = kw + gr + 8 * (e >> 1);
            keep = qr < Tq && kc < S && (!causal || qr >= kc);
          }
          const float p =
              keep ? expf(sp[j][e] * scale - ((e & 1) ? lq.y : lq.x)) : 0.f;
          sp[j][e] = p;
          dp[j][e] = p * (dp[j][e] - ((e & 1) ? dq.y : dq.x)) * scale;
        }
      }
      const uint32_t pa[4] = {
          pack_bf16(sp[0][0], sp[0][1]), pack_bf16(sp[0][2], sp[0][3]),
          pack_bf16(sp[1][0], sp[1][1]), pack_bf16(sp[1][2], sp[1][3])};
      const uint32_t sa[4] = {
          pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
          pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
      // dV += P^T.g and dK += dS^T.Q over these 16 q rows
#pragma unroll
      for (int dn = 0; dn < NO / 2; ++dn) {
        uint32_t bg[4], bq[4];
        ldsm4_t(bg, sG + fr.bt + fr.blk(qs, 16 * dn));
        ldsm4_t(bq, sQ + fr.bt + fr.blk(qs, 16 * dn));
        mma(dva[2 * dn], pa, bg[0], bg[1]);
        mma(dva[2 * dn + 1], pa, bg[2], bg[3]);
        mma(dka[2 * dn], sa, bq[0], bq[1]);
        mma(dka[2 * dn + 1], sa, bq[2], bq[3]);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = kw + gr + 8 * i;
    if (c >= S) continue;
    const size_t row = ((size_t)(b * S + c) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = 8 * n + 2 * tc;
      if (d < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + row + d) =
            __floats2bfloat162_rn(dka[n][2 * i], dka[n][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + row + d) =
            __floats2bfloat162_rn(dva[n][2 * i], dva[n][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// bf16 dQ on the tensor cores: one (b*h, 128-row q tile), stepping 64-key
// K/V tiles up to the diagonal; warp w owns q rows 16w..16w+15. The
// forward's structure with a second score tile (dP = g.V^T beside S =
// Q.K^T) and no online softmax: lse and delta of the warp's two
// accumulator rows stay in registers. Each 64-key stage is taken as two
// 32-key halves; dS, rounded to bf16, is the A fragment of dQ += dS.K as
// the forward's P is of P.V. The CTA's Q and g tiles stay in shared
// memory and their fragments are read at each use, which keeps the
// kernel within 128 registers (two CTAs per SM at D <= 64).
// ---------------------------------------------------------------------
template <int DM>
struct QLayout {
  static constexpr uint32_t kTileBytes = kStep * (DM + 8) * sizeof(bf16);
  // ring stage s: K then V [kStep][DM + 8]; then Q and g [kRows][DM + 8]
  static constexpr uint32_t kQ = 4 * kTileBytes;
  static constexpr uint32_t kG = kQ + 2 * kTileBytes;
  static constexpr uint32_t kBytes = kG + 2 * kTileBytes;
};

template <int DM>
__global__ void __launch_bounds__(kMmaThreads, DM <= 64 ? 2 : 1)
flash_backward_q_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ g,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dq, int H, int Tq, int S,
                            int D, float scale, int causal) {
  using L = QLayout<DM>;
  constexpr int KD = DM / 16;  // k-steps of Q.K^T and g.V^T over D
  constexpr int NO = DM / 8;   // n-tiles of dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = smem_addr(smem_raw);
  const uint32_t sQ = ring + L::kQ;
  const uint32_t sG = ring + L::kG;
  const Frag<DM> fr(threadIdx.x & 31);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // accumulator rows gr and gr + 8
  const int tc = lane & 3;   // accumulator columns 2tc, 2tc + 1
  const int qw = q0 + 16 * warp;
  const int rs = H * D;  // row stride, elements
  const bf16* qb = q + ((size_t)b * Tq * H + h) * D;
  const bf16* gb = g + ((size_t)b * Tq * H + h) * D;
  const bf16* kb = k + ((size_t)b * S * H + h) * D;
  const bf16* vb = v + ((size_t)b * S * H + h) * D;

  cp_tile<kRows, DM>(sQ, qb, q0, Tq, rs, D);
  cp_tile<kRows, DM>(sG, gb, q0, Tq, rs, D);
  cp_tile<kStep, DM>(ring, kb, 0, S, rs, D);
  cp_tile<kStep, DM>(ring + L::kTileBytes, vb, 0, S, rs, D);
  cp_commit();
  int nk = (S + kStep - 1) / kStep;
  if (causal) nk = min(nk, (q0 + kRows - 1) / kStep + 1);

  // lse and delta of rows gr and gr + 8 (rows past Tq: zero, never
  // stored; their Q and g rows are zero-filled)
  float lr[2], dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + gr + 8 * i;
    lr[i] = r < Tq ? lse[(size_t)bh * Tq + r] : 0.f;
    dr[i] = r < Tq ? delta[(size_t)bh * Tq + r] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kStep;
    cp_wait<0>();
    // step kt's tiles (and Q, g) are visible to all, and every warp is
    // done with step kt - 1, whose stage the next copy refills
    __syncthreads();
    if (kt + 1 < nk) {
      const uint32_t nx = ring + ((kt + 1) & 1) * 2 * L::kTileBytes;
      cp_tile<kStep, DM>(nx, kb, k0 + kStep, S, rs, D);
      cp_tile<kStep, DM>(nx + L::kTileBytes, vb, k0 + kStep, S, rs, D);
      cp_commit();
    }
    const uint32_t sK = ring + (kt & 1) * 2 * L::kTileBytes;
    const uint32_t sV = sK + L::kTileBytes;

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kh = k0 + kHalf * hf;
      if (causal && kh > qw + 15) continue;  // no row of this warp attends

      // S = Q.K^T and dP = g.V^T: 16 rows x 32 keys, n-tile j = keys
      // kh + 8j..
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qa[4], ga[4];
        ldsm4(qa, sQ + fr.a + fr.blk(16 * warp, 16 * kd));
        ldsm4(ga, sG + fr.a + fr.blk(16 * warp, 16 * kd));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kf[4], vf[4];
          ldsm4(kf, sK + fr.b + fr.blk(kHalf * hf + 16 * np, 16 * kd));
          ldsm4(vf, sV + fr.b + fr.blk(kHalf * hf + 16 * np, 16 * kd));
          mma(s[2 * np], qa, kf[0], kf[1]);
          mma(s[2 * np + 1], qa, kf[2], kf[3]);
          mma(dp[2 * np], ga, vf[0], vf[1]);
          mma(dp[2 * np + 1], ga, vf[2], vf[3]);
        }
      }

      // P = exp(S * scale - lse), exactly 0 where masked (only edge and
      // diagonal tiles evaluate the mask); dS = P * (dP - delta) * scale,
      // rounded to bf16 as the TPU kernel's ds.astype(k.dtype)
      const bool edge = kh + kHalf > S || (causal && kh + kHalf - 1 > qw);
      uint32_t da[4][2];  // dS in bf16: rows gr and gr + 8
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool keep = true;
          if (edge) {
            const int c = kh + 8 * j + 2 * tc + (e & 1);
            const int r = qw + gr + 8 * (e >> 1);
            keep = c < S && (!causal || r >= c);
          }
          const float p = keep ? expf(s[j][e] * scale - lr[e >> 1]) : 0.f;
          d[e] = p * (dp[j][e] - dr[e >> 1]) * scale;
        }
        da[j][0] = pack_bf16(d[0], d[1]);
        da[j][1] = pack_bf16(d[2], d[3]);
      }

      // dQ += dS.K: dS's accumulators are the A fragments, K enters
      // through ldmatrix.trans as V does in the forward's P.V
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t a[4] = {da[2 * kk][0], da[2 * kk][1],
                               da[2 * kk + 1][0], da[2 * kk + 1][1]};
#pragma unroll
        for (int dn = 0; dn < NO / 2; ++dn) {
          uint32_t kf[4];
          ldsm4_t(kf, sK + fr.bt + fr.blk(kHalf * hf + 16 * kk, 16 * dn));
          mma(acc[2 * dn], a, kf[0], kf[1]);
          mma(acc[2 * dn + 1], a, kf[2], kf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + gr + 8 * i;
    if (r >= Tq) continue;
    bf16* row = dq + ((size_t)(b * Tq + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * tc;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------
// f32 forward on the tensor cores in 3xTF32: o and lse for one (b*h,
// 128-row q tile), the bf16 forward's structure over f32 tiles; warp w
// owns q rows 16w..16w+15, each 64-key stage is taken as two 32-key
// halves, each a full online-softmax update.
// ---------------------------------------------------------------------

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value: to
// nearest, ties away from zero, the low 13 bits cleared. Adding half a
// TF32 ulp to the magnitude bits carries into the exponent where it
// should. ptxas expands cvt.rna into a sequence that also screens NaN
// and Inf (about five instructions where this takes two); the operands
// here are finite, and on them the two are bit-identical.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo, each a TF32; x - hi is exact in f32, so hi + lo holds x
// to about 2^-22 of its size
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a.b over one m16n8k8 tile: tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32, the small terms first: a_lo.b_hi, a_hi.b_lo, then
// a_hi.b_hi; a_lo.b_lo (about 2^-22 of the product) is left out
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// Shared memory of the 3xTF32 forward: a two-stage ring, each stage a K
// then a V tile [kStep][P] f32, then the CTA's Q tile [kRows][P]. P = DM
// + 4 words: a row is an odd number of 16-byte units, so ldmatrix's
// eight rows fall on distinct banks, and P = 4 (mod 32), so the 32-bit V
// loads of a warp (keys 2t and 2t + 1, head dims gr) are free of
// conflicts too.
template <int DM>
struct Tf32Layout {
  static constexpr int P = DM + 4;
  static constexpr uint32_t kKV = kStep * P * sizeof(float);  // K or V
  static constexpr uint32_t kQ = 4 * kKV;                      // Q's offset
  static constexpr uint32_t kBytes = kQ + kRows * P * sizeof(float);
};

// ldmatrix x4 lane addresses into a row-major [rows][P] f32 tile, as byte
// offsets from the tile's shared address. An 8x8 b16 matrix is 8 rows of
// 4 f32 and lane i receives word i % 4 of row i / 4: the tf32 fragment.
//   a — the A fragment of the 16x8 block at (r, c): a0 rows r.. columns
//       c.., a1 rows r + 8.., a2 columns c + 4.., a3 both;
//   b — {b0, b1} of n-tiles r and r + 8 (tile rows are n, the 8 columns
//       from c are k).
template <int P>
struct Frag32 {
  uint32_t a, b;
  __device__ explicit Frag32(int lane)
      : a(4 * ((lane & 15) * P + (lane >> 4) * 4)),
        b(4 * (((lane & 7) + (lane >> 4) * 8) * P + ((lane >> 3) & 1) * 4)) {
  }
  __device__ static constexpr uint32_t blk(int r, int c) {
    return 4 * (r * P + c);
  }
};

// Queue the copy of rows [r0, r0 + ROWS) of one (b, h) f32 slice into the
// [ROWS][P] tile at shared address `dst`, 16 bytes (4 floats) a copy;
// rows at or past `len` and columns at or past D are zero-filled.
template <int ROWS, int DM>
__device__ __forceinline__ void cp_tile_f32(uint32_t dst, const float* src,
                                            int r0, int len, int rs, int D) {
  constexpr int kChunks = DM / 4;  // per row
  constexpr int P = Tf32Layout<DM>::P;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int part = c % kChunks;
    const bool in = r0 + r < len && part * 4 < D;
    cp_async16(dst + 4 * (r * P + part * 4),
               in ? src + (size_t)(r0 + r) * rs + part * 4 : src, in);
  }
}

template <int DM>
__global__ void __launch_bounds__(kMmaThreads, DM <= 64 ? 2 : 1)
flash_forward_tf32x3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, float* __restrict__ lse,
                            int H, int Tq, int S, int D, float scale,
                            int causal) {
  using L = Tf32Layout<DM>;
  constexpr int P = L::P;
  constexpr int KD = DM / 8;  // k-steps of Q.K^T over the head dim
  constexpr int NO = DM / 8;  // n-tiles of o
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = smem_addr(smem_raw);
  const uint32_t sQ = ring + L::kQ;
  const Frag32<P> fr(threadIdx.x & 31);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // accumulator rows gr and gr + 8
  const int tc = lane & 3;   // accumulator columns 2tc, 2tc + 1
  const int qw = q0 + 16 * warp;
  const int rs = H * D;  // row stride, elements
  const float* qb = q + ((size_t)b * Tq * H + h) * D;
  const float* kb = k + ((size_t)b * S * H + h) * D;
  const float* vb = v + ((size_t)b * S * H + h) * D;

  cp_tile_f32<kRows, DM>(sQ, qb, q0, Tq, rs, D);
  cp_tile_f32<kStep, DM>(ring, kb, 0, S, rs, D);
  cp_tile_f32<kStep, DM>(ring + L::kKV, vb, 0, S, rs, D);
  cp_commit();
  int nk = (S + kStep - 1) / kStep;
  if (causal) nk = min(nk, (q0 + kRows - 1) / kStep + 1);

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kStep;
    cp_wait<0>();
    // step kt's tiles are visible to all, and every warp is done with
    // step kt - 1, whose stage the next copy refills
    __syncthreads();
    if (kt + 1 < nk) {
      const uint32_t nx = ring + ((kt + 1) & 1) * 2 * L::kKV;
      cp_tile_f32<kStep, DM>(nx, kb, k0 + kStep, S, rs, D);
      cp_tile_f32<kStep, DM>(nx + L::kKV, vb, k0 + kStep, S, rs, D);
      cp_commit();
    }
    const uint32_t sK = ring + (kt & 1) * 2 * L::kKV;
    const float* sV = reinterpret_cast<const float*>(
        smem_raw + (kt & 1) * 2 * L::kKV + L::kKV);

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kh = k0 + kHalf * hf;
      if (causal && kh > qw + 15) continue;  // no row of this warp attends

      // S = Q.K^T: 16 rows x 32 keys, n-tile j = keys kh + 8j..; Q's
      // fragments are read from shared memory and split at each use
      float s[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qf[4], ah[4], al[4];
        ldsm4(qf, sQ + fr.a + fr.blk(16 * warp, 8 * kd));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split_tf32(__uint_as_float(qf[i]), ah[i], al[i]);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kf[4], bhi[4], blo[4];
          ldsm4(kf, sK + fr.b + fr.blk(kHalf * hf + 16 * np, 8 * kd));
#pragma unroll
          for (int i = 0; i < 4; ++i)
            split_tf32(__uint_as_float(kf[i]), bhi[i], blo[i]);
          mma3(s[2 * np], ah, al, bhi[0], bhi[1], blo[0], blo[1]);
          mma3(s[2 * np + 1], ah, al, bhi[2], bhi[3], blo[2], blo[3]);
        }
      }

      // scale after the product; mask only where a key can be out of
      // reach (the ragged end of S, the causal diagonal)
      const bool edge = kh + kHalf > S || (causal && kh + kHalf - 1 > qw);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale;
          if (edge) {
            const int c = kh + 8 * j + 2 * tc + (e & 1);
            const int r = qw + gr + 8 * (e >> 1);
            if (!(c < S && (!causal || r >= c))) x = kNegInf;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        alpha[i] = m[i] <= kNegInf ? 0.f : expf(m[i] - m_new);
        m[i] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // exact guard: a masked score contributes exactly 0
          const float x = s[j][e];
          s[j][e] = x <= kNegInf ? 0.f : expf(x - m[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // acc += P.V, k-step j = keys kh + 8j... P's accumulator holds keys
      // 2tc and 2tc + 1 of a row, so the keys are permuted within the
      // eight: A column t is key 2t and column t + 4 key 2t + 1, and V's
      // B fragment is read with the same permutation. The sum over keys
      // is unchanged and no shuffle moves P between lanes.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);  // row gr,     key 2tc
        split_tf32(s[j][2], ph[1], pl[1]);  // row gr + 8, key 2tc
        split_tf32(s[j][1], ph[2], pl[2]);  // row gr,     key 2tc + 1
        split_tf32(s[j][3], ph[3], pl[3]);  // row gr + 8, key 2tc + 1
        const float* vr = sV + (kHalf * hf + 8 * j + 2 * tc) * P + gr;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t vh0, vl0, vh1, vl1;
          split_tf32(vr[8 * n], vh0, vl0);      // key 2tc, head dim 8n + gr
          split_tf32(vr[P + 8 * n], vh1, vl1);  // key 2tc + 1
          mma3(acc[n], ph, pl, vh0, vh1, vl0, vl1);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + gr + 8 * i;
    if (r >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + ((size_t)(b * Tq + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * tc;
      if (c < D)
        *reinterpret_cast<float2*>(orow + c) =
            make_float2(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
    }
    if (tc == 0) lse[(size_t)bh * Tq + r] = m[i] + logf(denom);
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

// Dynamic shared bytes per CTA of the CUDA-core f32 kernel `which` (1
// dK/dV, 2 dQ): [64][D+1] tiles, [64][65] P/dS tiles and 64-float rows
size_t fma_shared(int which, int D) {
  constexpr int kParts[2][3] = {{4, 2, 2}, {4, 1, 2}};
  const int* n = kParts[which - 1];
  return sizeof(float) * ((size_t)n[0] * kTile * (D + 1) +
                          (size_t)n[1] * kTile * kLdP + (size_t)n[2] * kTile);
}
// tensor cores: the forward's two-stage K/V ring, KvLayout, QLayout
template <int DM>
size_t mma_shared(int which) {
  return which == 0   ? 4 * kStep * (DM + 8) * sizeof(bf16)
         : which == 1 ? KvLayout<DM>::kBytes
                      : QLayout<DM>::kBytes;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DM>
cudaError_t forward_mma(const void* q, const void* k, const void* v,
                        void* o, float* lse, const Shape& s,
                        cudaStream_t st) {
  const size_t smem = mma_shared<DM>(0);
  cudaError_t e = allow_smem(flash_forward_mma_kernel<DM>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.B * s.H, (s.Tq + kRows - 1) / kRows);
  flash_forward_mma_kernel<DM><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, s.H, s.Tq,
      s.S, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

template <int DM>
cudaError_t backward_kv_mma(const void* q, const void* k, const void* v,
                            const void* g, const float* lse,
                            const float* delta, void* dk, void* dv,
                            const Shape& s, cudaStream_t st) {
  const size_t smem = mma_shared<DM>(1);
  cudaError_t e = allow_smem(flash_backward_kv_mma_kernel<DM>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.B * s.H, (s.S + kRows - 1) / kRows);
  flash_backward_kv_mma_kernel<DM><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), s.H, s.Tq, s.S, s.D,
      s.scale, s.causal);
  return cudaGetLastError();
}

template <int DM>
cudaError_t backward_q_mma(const void* q, const void* k, const void* v,
                           const void* g, const float* lse,
                           const float* delta, void* dq, const Shape& s,
                           cudaStream_t st) {
  const size_t smem = mma_shared<DM>(2);
  cudaError_t e = allow_smem(flash_backward_q_mma_kernel<DM>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.B * s.H, (s.Tq + kRows - 1) / kRows);
  flash_backward_q_mma_kernel<DM><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
      static_cast<bf16*>(dq), s.H, s.Tq, s.S, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

template <int DM>
cudaError_t forward_tf32x3(const void* q, const void* k, const void* v,
                           void* o, float* lse, const Shape& s,
                           cudaStream_t st) {
  const size_t smem = Tf32Layout<DM>::kBytes;
  cudaError_t e = allow_smem(flash_forward_tf32x3_kernel<DM>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.B * s.H, (s.Tq + kRows - 1) / kRows);
  flash_forward_tf32x3_kernel<DM><<<grid, kMmaThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, s.H, s.Tq,
      s.S, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

template <typename T, int DM>
cudaError_t backward_kv(const void* q, const void* k, const void* v,
                        const void* g, const float* lse, const float* delta,
                        void* dk, void* dv, const Shape& s, cudaStream_t st) {
  const size_t smem = fma_shared(1, s.D);
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
  const size_t smem = fma_shared(2, s.D);
  cudaError_t e = allow_smem(flash_backward_q_kernel<T, DM>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((s.Tq + kTile - 1) / kTile, s.B * s.H);
  flash_backward_q_kernel<T, DM><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), lse, delta,
      static_cast<T*>(dq), s.H, s.Tq, s.S, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

// D-bucket dispatch: the bucket sizes the register accumulators and, on
// the tensor cores, the zero-padded tiles; D itself stays a runtime value
#define MMA_DISPATCH(D, CALL) \
  ((D) <= 32 ? CALL(32) : (D) <= 64 ? CALL(64) : CALL(128))
#define FMA_DISPATCH(T, D, CALL) ((D) <= 64 ? CALL(T, 64) : CALL(T, 128))

}  // namespace

// C interface bound with ctypes (parallel/flash_attention.py). q, g, o,
// dq are [B, T, H, D]; k, v, dk, dv [B, S, H, D], all contiguous in the
// input dtype (bf16 or f32); lse and delta [B, H, T] f32. Each returns
// the cudaError_t of its launch (0 = launched) on `stream`. bf16 runs on
// the tensor cores; the f32 forward in 3xTF32 on the tensor cores, the
// f32 backward on the CUDA cores.
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
#define MMA(DM) forward_mma<DM>(q, k, v, o, l, s, st)
#define TF32(DM) forward_tf32x3<DM>(q, k, v, o, l, s, st)
  e = is_bf16 ? MMA_DISPATCH(D, MMA) : MMA_DISPATCH(D, TF32);
#undef MMA
#undef TF32
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
#define MMA(DM) backward_kv_mma<DM>(q, k, v, g, l, dl, dk, dv, s, st)
#define FMA(TT, DM) backward_kv<TT, DM>(q, k, v, g, l, dl, dk, dv, s, st)
  e = is_bf16 ? MMA_DISPATCH(D, MMA) : FMA_DISPATCH(float, D, FMA);
#undef MMA
#undef FMA
  return (int)e;
}

// Dynamic shared memory (bytes per CTA) that a launch of kernel `which`
// (0 forward, 1 dK/dV, 2 dQ) requests at head width D.
extern "C" int flash_shared_bytes(int which, int is_bf16, int D) {
  if (which < 0 || which > 2 || D <= 0 || D > 128) return -1;
#define MMA(DM) mma_shared<DM>(which)
#define TF32(DM) Tf32Layout<DM>::kBytes
  if (is_bf16) return (int)MMA_DISPATCH(D, MMA);
  return (int)(which == 0 ? MMA_DISPATCH(D, TF32) : fma_shared(which, D));
#undef TF32
#undef MMA
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
#define MMA(DM) backward_q_mma<DM>(q, k, v, g, l, dl, dq, s, st)
#define FMA(TT, DM) backward_q<TT, DM>(q, k, v, g, l, dl, dq, s, st)
  e = is_bf16 ? MMA_DISPATCH(D, MMA) : FMA_DISPATCH(float, D, FMA);
#undef MMA
#undef FMA
  return (int)e;
}
