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
// f32 backward (dK/dV and dQ): the bf16 backward kernels' structure on
// the tensor cores in 3xTF32 (`flash_backward_kv_tf32x3_kernel`,
// `flash_backward_q_tf32x3_kernel`), every product split as in the f32
// forward.
//   * dK/dV computes S^T = K.Q^T and dP^T = V.g^T with K and V as the A
//     fragments (ldmatrix, as the forward's Q) and Q and g as the B
//     fragments (ldmatrix, as the forward's K); dQ computes S = Q.K^T and
//     dP = g.V^T as the forward computes S;
//   * P^T and dS^T (dK/dV) and dS (dQ) never leave their lanes: with the
//     q rows (or keys) permuted within each eight, as the forward's
//     keys are, the accumulators are the A fragments of dV += P^T.g,
//     dK += dS^T.Q and dQ += dS.K, and g, Q and K are read by 32-bit
//     shared loads under the same permutation, as the forward's V. No
//     transposing load is needed, and on [rows][D + 4] tiles a warp's
//     32 loads fall on 32 distinct banks;
//   * a CTA owns 16 rows a warp of keys (dK/dV) or of q (dQ): 4 warps
//     up to D 64, 8 at D 128; the streamed tiles come through a
//     cp.async ring whose stage count is a template argument: two
//     stages where they fit in a CTA's 227 KB, one where they do not
//     (both at D 128). At D 64 dK/dV takes 105,472 B and dQ 104,448 B,
//     two CTAs an SM;
//   * numerics and edges as the TPU kernels': the scale after the
//     product, P = exp(S * scale - lse), exactly 0 where masked (only
//     edge and diagonal tiles evaluate the mask), dS = P * (dP - delta)
//     * scale, the rounding points the identity in f32; one owner per
//     output tile and no atomics, so launches repeat bit for bit; the
//     causal skip and the longest-first issue as in bf16. The products
//     go to fresh sums that are added to the running ones in f32: dK/dV
//     a 16-row q slice's, one n-tile at a time (four registers, so D
//     128 fits too), dQ a streamed tile's. mma.sync's accumulation
//     truncates, and over a long sequence running sums drifted from f64
//     by ten times as much without this.
//   What bounds them: the tensor cores at three TF32 products an f32
//   product (3 x 17.2 GFLOP for dK/dV and 3 x 12.9 for dQ at the
//   training shape over 494.7 TFLOP/s dense TF32), and ahead of them
//   the splits on the ALUs: every warp splits the streamed tile again,
//   and K and V (dK/dV) or Q and g (dQ) at each use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kNegInf = -1e30f;  // parallel/kernel_utils.py NEG_INF

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

// An m16n8 accumulator tile (rows r, columns k = 2t, 2t + 1 in lane
// (r % 8) * 4 + t) as the A fragment of the next product, split into
// TF32 hi and lo. The columns are permuted within the eight (A column t
// is k = 2t, t + 4 is 2t + 1), so the accumulator's registers are the A
// fragment as they lie; the B operand is read with the same permutation.
__device__ __forceinline__ void split_acc_a(const float (&a)[4],
                                            uint32_t (&ah)[4],
                                            uint32_t (&al)[4]) {
  split_tf32(a[0], ah[0], al[0]);  // row r,     k 2t
  split_tf32(a[2], ah[1], al[1]);  // row r + 8, k 2t
  split_tf32(a[1], ah[2], al[2]);  // row r,     k 2t + 1
  split_tf32(a[3], ah[3], al[3]);  // row r + 8, k 2t + 1
}

// c[n] += a.b over one k-step where a is an accumulator tile (split_acc_a)
// and b's rows k are `bp` and `bp + P` in shared memory, column n at
// `bp[8n]`: rows 2t and 2t + 1, read by 32-bit loads and split.
template <int P, int NO>
__device__ __forceinline__ void mma3_acc_rows(float (&c)[NO][4],
                                              const float (&a)[4],
                                              const float* bp) {
  uint32_t ah[4], al[4];
  split_acc_a(a, ah, al);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    uint32_t h0, l0, h1, l1;
    split_tf32(bp[8 * n], h0, l0);      // k 2t, column 8n + r % 8
    split_tf32(bp[P + 8 * n], h1, l1);  // k 2t + 1
    mma3(c[n], ah, al, h0, h1, l0, l1);
  }
}

// As mma3_acc_rows over J k-steps (a[j]'s b rows at `bp + 8jP`), each
// n-tile's J steps summed from zero and the sum added to c[n] in f32.
// mma.sync truncates as it accumulates: products summed straight into a
// running c over a long range drift from f32's sum, and fresh sums of a
// few k-steps, each added with f32 rounding, do not. The sum takes four
// registers whatever NO.
template <int P, int NO, int J>
__device__ __forceinline__ void mma3_add_rows(float (&c)[NO][4],
                                              const float (&a)[J][4],
                                              const float* bp) {
  uint32_t ah[J][4], al[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j) split_acc_a(a[j], ah[j], al[j]);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float* b = bp + 8 * j * P + 8 * n;
      uint32_t h0, l0, h1, l1;
      split_tf32(b[0], h0, l0);
      split_tf32(b[P], h1, l1);
      mma3(t, ah[j], al[j], h0, h1, l0, l1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] += t[e];
  }
}

// One k-step's A fragment, or the B fragments of two n-tiles, by
// ldmatrix x4 at `addr` (Frag32's a or b), split into TF32 hi and lo
__device__ __forceinline__ void ldsm4_split(uint32_t (&hi)[4],
                                            uint32_t (&lo)[4],
                                            uint32_t addr) {
  uint32_t f[4];
  ldsm4(f, addr);
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(f[i]), hi[i], lo[i]);
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
// [ROWS][P] tile at shared address `dst`, 16 bytes (4 floats) a copy,
// by a CTA of THREADS threads; rows at or past `len` and columns at or
// past D are zero-filled.
template <int ROWS, int DM, int THREADS = kMmaThreads>
__device__ __forceinline__ void cp_tile_f32(uint32_t dst, const float* src,
                                            int r0, int len, int rs, int D) {
  constexpr int kChunks = DM / 4;  // per row
  constexpr int P = Tf32Layout<DM>::P;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += THREADS) {
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
        uint32_t ah[4], al[4];
        ldsm4_split(ah, al, sQ + fr.a + fr.blk(16 * warp, 8 * kd));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bhi[4], blo[4];
          ldsm4_split(bhi, blo,
                      sK + fr.b + fr.blk(kHalf * hf + 16 * np, 8 * kd));
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
      // eight and V is read at those keys, head dim 8n + gr. The sum over
      // keys is unchanged and no shuffle moves P between lanes.
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma3_acc_rows<P, NO>(acc, s[j],
                             sV + (kHalf * hf + 8 * j + 2 * tc) * P + gr);
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
// f32 backward in 3xTF32: warps a CTA and its shared memory
// ---------------------------------------------------------------------
// Warps a CTA of either pass runs, each owning 16 rows (keys for dK/dV,
// q rows for dQ): on an H100, 4 (two CTAs an SM) ran both faster at D
// 64, and 8 (one CTA an SM, each streamed tile read half as often) ran
// both faster at D 128
template <int DM>
constexpr int kBwdWarps = DM <= 64 ? 4 : 8;
template <int DM>
constexpr int kBwdRows = 16 * kBwdWarps<DM>;  // rows a CTA owns
// A CTA's dynamic shared memory at most (227 KB)
constexpr uint32_t kMaxShared = 232448;

// ---------------------------------------------------------------------
// f32 dK/dV on the tensor cores in 3xTF32: one (b*h, kBwdRows-key tile),
// stepping 64-row q tiles from the diagonal in 16-row slices; warp w
// owns key rows 16w..16w+15.
// ---------------------------------------------------------------------
// Shared memory: ST ring stages, each the q and g tiles [kStep][P] f32
// then 64 lse and 64 delta floats, followed by the CTA's K and V tiles
// [kBwdRows][P]. At D 64, 105,472 B: two CTAs an SM.
template <int DM, int ST>
struct KvLayout32 {
  static constexpr int P = DM + 4;
  static constexpr uint32_t kTile = kStep * P * sizeof(float);  // q or g
  static constexpr uint32_t kStage = 2 * kTile + 2 * kStep * sizeof(float);
  static constexpr uint32_t kKV = kBwdRows<DM> * P * sizeof(float);  // K/V
  static constexpr uint32_t kK = ST * kStage;                    // K's offset
  static constexpr uint32_t kBytes = kK + 2 * kKV;
};
// two ring stages where they fit, else one
template <int DM>
constexpr int kv_stages() {
  return KvLayout32<DM, 2>::kBytes <= kMaxShared ? 2 : 1;
}

template <int DM, int ST>
__global__ void __launch_bounds__(32 * kBwdWarps<DM>, 8 / kBwdWarps<DM>)
flash_backward_kv_tf32x3_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ g,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv,
                                int H, int Tq, int S, int D, float scale,
                                int causal) {
  using L = KvLayout32<DM, ST>;
  constexpr int P = L::P;
  constexpr int KD = DM / 8;  // k-steps of K.Q^T over the head dim
  constexpr int NO = DM / 8;  // n-tiles of dk and dv
  constexpr int kThr = 32 * kBwdWarps<DM>;
  constexpr int kCta = kBwdRows<DM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  const uint32_t sK = base + L::kK;
  const uint32_t sV = sK + L::kKV;
  const Frag32<P> fr(threadIdx.x & 31);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * kCta;  // causal: low k tiles are longest
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // accumulator rows (keys) gr and gr + 8
  const int tc = lane & 3;   // accumulator columns 2tc, 2tc + 1
  const int kw = k0 + 16 * warp;
  const int rs = H * D;  // row stride, elements
  const float* qb = q + ((size_t)b * Tq * H + h) * D;
  const float* gb = g + ((size_t)b * Tq * H + h) * D;
  const float* kb = k + ((size_t)b * S * H + h) * D;
  const float* vb = v + ((size_t)b * S * H + h) * D;
  const float* lb = lse + (size_t)bh * Tq;
  const float* db = delta + (size_t)bh * Tq;

  // q tile qt (rows 64qt..) with its lse and delta into ring stage st
  auto issue = [&](int qt, int st) {
    const int r0 = qt * kStep;
    const uint32_t at = base + st * L::kStage;
    cp_tile_f32<kStep, DM, kThr>(at, qb, r0, Tq, rs, D);
    cp_tile_f32<kStep, DM, kThr>(at + L::kTile, gb, r0, Tq, rs, D);
    const int t = threadIdx.x & (kStep - 1);
    const bool in = r0 + t < Tq;
    const uint32_t row = at + 2 * L::kTile + 4 * t;
    if (threadIdx.x < kStep)
      cp_async4(row, in ? lb + r0 + t : lb, in);
    else if (threadIdx.x < 2 * kStep)
      cp_async4(row + 4 * kStep, in ? db + r0 + t : db, in);
    cp_commit();
  };

  cp_tile_f32<kCta, DM, kThr>(sK, kb, k0, S, rs, D);
  cp_tile_f32<kCta, DM, kThr>(sV, vb, k0, S, rs, D);
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
    const int st = ST == 1 ? 0 : (qt - qt0) & 1;
    cp_wait<0>();
    // step qt's tiles are visible to all, and every warp is done with
    // the stage the next copy refills
    __syncthreads();
    if (ST > 1 && qt + 1 < nq) issue(qt + 1, st ^ 1);
    const int q0 = qt * kStep;
    if (!causal || q0 + kStep - 1 >= kw) {  // some q row reaches a key
      const uint32_t sQ = base + st * L::kStage;
      const uint32_t sG = sQ + L::kTile;
      const float* fQ =
          reinterpret_cast<const float*>(smem_raw + st * L::kStage);
      const float* fG = fQ + kStep * P;
      const float* sL = fG + kStep * P;
      const float* sD = sL + kStep;
      const bool edge =
          q0 + kStep > Tq || kw + 16 > S || (causal && q0 < kw + 15);

      // one slice at a time: unrolled, the four slices' registers spilled
      // at D 128, and the kernel ran 1.5x slower at D 128, 1.09x at D 64
      // on an H100
#pragma unroll 1
      for (int sub = 0; sub < kStep / 16; ++sub) {
        const int qs = 16 * sub;  // this 16-row slice of the q tile
        if (causal && q0 + qs + 15 < kw) continue;
        // S^T = K.Q^T and dP^T = V.g^T: 16 keys x 16 q rows, n-tile j =
        // q rows qs + 8j..; K and V are the A fragments, split at each use
        float sp[2][4], dp[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sp[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          uint32_t kh[4], kl[4], vh[4], vl[4], qh[4], ql[4], gh[4], gl[4];
          ldsm4_split(kh, kl, sK + fr.a + fr.blk(16 * warp, 8 * kd));
          ldsm4_split(qh, ql, sQ + fr.b + fr.blk(qs, 8 * kd));
          mma3(sp[0], kh, kl, qh[0], qh[1], ql[0], ql[1]);
          mma3(sp[1], kh, kl, qh[2], qh[3], ql[2], ql[3]);
          ldsm4_split(vh, vl, sV + fr.a + fr.blk(16 * warp, 8 * kd));
          ldsm4_split(gh, gl, sG + fr.b + fr.blk(qs, 8 * kd));
          mma3(dp[0], vh, vl, gh[0], gh[1], gl[0], gl[1]);
          mma3(dp[1], vh, vl, gh[2], gh[3], gl[2], gl[3]);
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
                keep ? expf(sp[j][e] * scale - ((e & 1) ? lq.y : lq.x))
                     : 0.f;
            sp[j][e] = p;
            dp[j][e] = p * (dp[j][e] - ((e & 1) ? dq.y : dq.x)) * scale;
          }
        }
        // dV += P^T.g and dK += dS^T.Q over the slice, k-step j = q rows
        // qs + 8j..: the accumulators hold q rows 2tc and 2tc + 1 of the
        // eight, so g and Q are read at those rows, head dim 8n + gr. The
        // slice's sums start from zero and are added to dva and dka in
        // f32 (summed straight into them, dK/dV drifted 6e-5 to 1.8e-4
        // from f64 at T 1024 to 4096 on an H100)
        const int at = (qs + 2 * tc) * P + gr;
        mma3_add_rows<P, NO, 2>(dva, sp, fG + at);
        mma3_add_rows<P, NO, 2>(dka, dp, fQ + at);
      }
    }
    if (ST == 1 && qt + 1 < nq) {
      __syncthreads();  // every warp is done with the one stage
      issue(qt + 1, 0);
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
        *reinterpret_cast<float2*>(dk + row + d) =
            make_float2(dka[n][2 * i], dka[n][2 * i + 1]);
        *reinterpret_cast<float2*>(dv + row + d) =
            make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------
// f32 dQ on the tensor cores in 3xTF32: one (b*h, kBwdRows-row q tile),
// stepping 64-key K/V tiles up to the diagonal, each as two 32-key
// halves; warp w owns q rows 16w..16w+15. The lse and delta of a warp's
// two accumulator rows stay in registers.
// ---------------------------------------------------------------------
// Shared memory: ST ring stages, each a K then a V tile [kStep][P] f32,
// then the CTA's Q and g tiles [kBwdRows][P]. At D 64, 104,448 B: two
// CTAs an SM.
template <int DM, int ST>
struct QLayout32 {
  static constexpr int P = DM + 4;
  static constexpr uint32_t kKV = kStep * P * sizeof(float);     // K or V
  static constexpr uint32_t kRowsB = kBwdRows<DM> * P * sizeof(float);  // Q/g
  static constexpr uint32_t kQ = ST * 2 * kKV;                     // Q's offset
  static constexpr uint32_t kG = kQ + kRowsB;
  static constexpr uint32_t kBytes = kG + kRowsB;
};
template <int DM>
constexpr int q_stages() {
  return QLayout32<DM, 2>::kBytes <= kMaxShared ? 2 : 1;
}

template <int DM, int ST>
__global__ void __launch_bounds__(32 * kBwdWarps<DM>, 8 / kBwdWarps<DM>)
flash_backward_q_tf32x3_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ g,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dq, int H, int Tq, int S,
                               int D, float scale, int causal) {
  using L = QLayout32<DM, ST>;
  constexpr int P = L::P;
  constexpr int KD = DM / 8;  // k-steps of Q.K^T and g.V^T over D
  constexpr int NO = DM / 8;  // n-tiles of dq
  constexpr int kThr = 32 * kBwdWarps<DM>;
  constexpr int kCta = kBwdRows<DM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t ring = smem_addr(smem_raw);
  const uint32_t sQ = ring + L::kQ;
  const uint32_t sG = ring + L::kG;
  const Frag32<P> fr(threadIdx.x & 31);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kCta;  // longest first
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gr = lane >> 2;  // accumulator rows gr and gr + 8
  const int tc = lane & 3;   // accumulator columns 2tc, 2tc + 1
  const int qw = q0 + 16 * warp;
  const int rs = H * D;  // row stride, elements
  const float* qb = q + ((size_t)b * Tq * H + h) * D;
  const float* gb = g + ((size_t)b * Tq * H + h) * D;
  const float* kb = k + ((size_t)b * S * H + h) * D;
  const float* vb = v + ((size_t)b * S * H + h) * D;

  // K and V of 64-key tile kt into ring stage st
  auto issue = [&](int kt, int st) {
    const uint32_t at = ring + st * 2 * L::kKV;
    cp_tile_f32<kStep, DM, kThr>(at, kb, kt * kStep, S, rs, D);
    cp_tile_f32<kStep, DM, kThr>(at + L::kKV, vb, kt * kStep, S, rs, D);
    cp_commit();
  };

  cp_tile_f32<kCta, DM, kThr>(sQ, qb, q0, Tq, rs, D);
  cp_tile_f32<kCta, DM, kThr>(sG, gb, q0, Tq, rs, D);
  issue(0, 0);
  int nk = (S + kStep - 1) / kStep;
  if (causal) nk = min(nk, (q0 + kCta - 1) / kStep + 1);

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
    const int st = ST == 1 ? 0 : kt & 1;
    cp_wait<0>();
    // step kt's tiles (and Q, g) are visible to all, and every warp is
    // done with the stage the next copy refills
    __syncthreads();
    if (ST > 1 && kt + 1 < nk) issue(kt + 1, st ^ 1);
    const uint32_t sK = ring + st * 2 * L::kKV;
    const uint32_t sV = sK + L::kKV;
    const float* fK =
        reinterpret_cast<const float*>(smem_raw + st * 2 * L::kKV);
    // this tile's sums, added to acc in f32 (as dK/dV's, against
    // mma.sync's truncating accumulation)
    float ta[NO][4] = {};

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int kh = k0 + kHalf * hf;
      if (causal && kh > qw + 15) continue;  // no row of this warp attends

      // S = Q.K^T and dP = g.V^T: 16 rows x 32 keys, n-tile j = keys
      // kh + 8j..; Q and g are the A fragments, split at each use
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t qh[4], ql[4], gh[4], gl[4];
        ldsm4_split(qh, ql, sQ + fr.a + fr.blk(16 * warp, 8 * kd));
        ldsm4_split(gh, gl, sG + fr.a + fr.blk(16 * warp, 8 * kd));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const uint32_t at = fr.b + fr.blk(kHalf * hf + 16 * np, 8 * kd);
          uint32_t xh[4], xl[4];
          ldsm4_split(xh, xl, sK + at);
          mma3(s[2 * np], qh, ql, xh[0], xh[1], xl[0], xl[1]);
          mma3(s[2 * np + 1], qh, ql, xh[2], xh[3], xl[2], xl[3]);
          ldsm4_split(xh, xl, sV + at);
          mma3(dp[2 * np], gh, gl, xh[0], xh[1], xl[0], xl[1]);
          mma3(dp[2 * np + 1], gh, gl, xh[2], xh[3], xl[2], xl[3]);
        }
      }

      // P = exp(S * scale - lse), exactly 0 where masked (only edge and
      // diagonal tiles evaluate the mask); dS = P * (dP - delta) * scale
      const bool edge = kh + kHalf > S || (causal && kh + kHalf - 1 > qw);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool keep = true;
          if (edge) {
            const int c = kh + 8 * j + 2 * tc + (e & 1);
            const int r = qw + gr + 8 * (e >> 1);
            keep = c < S && (!causal || r >= c);
          }
          const float p = keep ? expf(s[j][e] * scale - lr[e >> 1]) : 0.f;
          s[j][e] = p * (dp[j][e] - dr[e >> 1]) * scale;
        }

      // dQ += dS.K, k-step j = keys kh + 8j..: dS's accumulator holds
      // keys 2tc and 2tc + 1 of the eight, so K is read at those keys,
      // head dim 8n + gr
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma3_acc_rows<P, NO>(ta, s[j],
                             fK + (kHalf * hf + 8 * j + 2 * tc) * P + gr);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += ta[n][e];
    if (ST == 1 && kt + 1 < nk) {
      __syncthreads();  // every warp is done with the one stage
      issue(kt + 1, 0);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qw + gr + 8 * i;
    if (r >= Tq) continue;
    float* row = dq + ((size_t)(b * Tq + r) * H + h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * tc;
      if (c < D)
        *reinterpret_cast<float2*>(row + c) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
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

template <int DM>
cudaError_t backward_kv_tf32x3(const void* q, const void* k, const void* v,
                               const void* g, const float* lse,
                               const float* delta, void* dk, void* dv,
                               const Shape& s, cudaStream_t st) {
  constexpr int ST = kv_stages<DM>();
  const size_t smem = KvLayout32<DM, ST>::kBytes;
  cudaError_t e = allow_smem(flash_backward_kv_tf32x3_kernel<DM, ST>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.B * s.H, (s.S + kBwdRows<DM> - 1) / kBwdRows<DM>);
  flash_backward_kv_tf32x3_kernel<DM, ST>
      <<<grid, 32 * kBwdWarps<DM>, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), s.H, s.Tq, s.S, s.D,
      s.scale, s.causal);
  return cudaGetLastError();
}

template <int DM>
cudaError_t backward_q_tf32x3(const void* q, const void* k, const void* v,
                              const void* g, const float* lse,
                              const float* delta, void* dq, const Shape& s,
                              cudaStream_t st) {
  constexpr int ST = q_stages<DM>();
  const size_t smem = QLayout32<DM, ST>::kBytes;
  cudaError_t e = allow_smem(flash_backward_q_tf32x3_kernel<DM, ST>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(s.B * s.H, (s.Tq + kBwdRows<DM> - 1) / kBwdRows<DM>);
  flash_backward_q_tf32x3_kernel<DM, ST>
      <<<grid, 32 * kBwdWarps<DM>, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
      static_cast<float*>(dq), s.H, s.Tq, s.S, s.D, s.scale, s.causal);
  return cudaGetLastError();
}

// f32 shared bytes of kernel `which` (0 forward, 1 dK/dV, 2 dQ)
template <int DM>
size_t tf32x3_shared(int which) {
  return which == 0   ? Tf32Layout<DM>::kBytes
         : which == 1 ? KvLayout32<DM, kv_stages<DM>()>::kBytes
                      : QLayout32<DM, q_stages<DM>()>::kBytes;
}

// D-bucket dispatch: the bucket sizes the register accumulators and the
// zero-padded tiles; D itself stays a runtime value
#define MMA_DISPATCH(D, CALL) \
  ((D) <= 32 ? CALL(32) : (D) <= 64 ? CALL(64) : CALL(128))

}  // namespace

// C interface bound with ctypes (parallel/flash_attention.py). q, g, o,
// dq are [B, T, H, D]; k, v, dk, dv [B, S, H, D], all contiguous in the
// input dtype (bf16 or f32); lse and delta [B, H, T] f32. Each returns
// the cudaError_t of its launch (0 = launched) on `stream`. Every pass
// runs on the tensor cores: bf16 in m16n8k16 bf16, f32 in 3xTF32.
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
#define TF32(DM) backward_kv_tf32x3<DM>(q, k, v, g, l, dl, dk, dv, s, st)
  e = is_bf16 ? MMA_DISPATCH(D, MMA) : MMA_DISPATCH(D, TF32);
#undef MMA
#undef TF32
  return (int)e;
}

// Dynamic shared memory (bytes per CTA) that a launch of kernel `which`
// (0 forward, 1 dK/dV, 2 dQ) requests at head width D.
extern "C" int flash_shared_bytes(int which, int is_bf16, int D) {
  if (which < 0 || which > 2 || D <= 0 || D > 128) return -1;
#define MMA(DM) mma_shared<DM>(which)
#define TF32(DM) tf32x3_shared<DM>(which)
  return (int)(is_bf16 ? MMA_DISPATCH(D, MMA) : MMA_DISPATCH(D, TF32));
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
#define TF32(DM) backward_q_tf32x3<DM>(q, k, v, g, l, dl, dq, s, st)
  e = is_bf16 ? MMA_DISPATCH(D, MMA) : MMA_DISPATCH(D, TF32);
#undef MMA
#undef TF32
  return (int)e;
}
