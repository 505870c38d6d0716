"""The 3xTF32 arithmetic of csrc/flash_attention.cu's f32 kernels and
the lane maps of their mma.sync m16n8k8 .tf32 fragments, emulated in
numpy for the CPU tests (test_torch_flash_tf32x3*.py).

An f32 operand x is split into two TF32 values, hi = rna(x) and lo =
rna(x - hi) (cvt.rna.tf32.f32: 10 stored mantissa bits, round to
nearest, ties away from zero), and every product of tiles a.b is three
mma.sync products accumulated in f32, the small terms first: a_lo.b_hi,
a_hi.b_lo, a_hi.b_hi. `_mma` models one such product over the
contraction in k-steps of 8, each step's products summed exactly and
added to the f32 accumulator.
"""

import numpy as np


def _rna(x):
    """x (f32) rounded to TF32 as cvt.rna.tf32.f32 does: the low 13
    mantissa bits cleared, to nearest, ties away from zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    hi = _rna(x)
    return hi, _rna(np.float32(x) - hi)


def _mma(a, b, products, c=None):
    """c + a [M, K] . b [K, N] as the kernels take it: k-steps of 8,
    each step's TF32 products summed exactly and added to an f32
    accumulator (zeros when `c` is None); `products` 3 (lo.hi, hi.lo,
    hi.hi) or 1 (hi.hi)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    terms = [(al, bh), (ah, bl), (ah, bh)] if products == 3 else [(ah, bh)]
    if c is None:
        c = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            step = x[:, k0:k0 + 8].astype(np.float64) @ \
                y[k0:k0 + 8].astype(np.float64)
            c = (c + step).astype(np.float32)
    return c


def _c_frag(c):
    """m16n8 accumulator [16, 8] -> per-lane registers [32, 4]."""
    return np.array([[c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t],
                      c[g + 8, 2 * t + 1]]
                     for g, t in ((ln >> 2, ln & 3) for ln in range(32))])


def _mma_lanes(c, a, b):
    """mma.sync m16n8k8 .tf32 on per-lane registers (PTX's layouts):
    a [32, 4], b [32, 2], c [32, 4] -> d [32, 4]."""
    A, B, C = np.zeros((16, 8)), np.zeros((8, 8)), np.zeros((16, 8))
    for ln in range(32):
        g, t = ln >> 2, ln & 3
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[ln]
        B[t, g], B[t + 4, g] = b[ln]
        C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], \
            C[g + 8, 2 * t + 1] = c[ln]
    return _c_frag(C + A @ B)


def _ldsm4(tile, P, offsets):
    """ldmatrix .x4 .b16 over an f32 tile of P words a row: lane 8i + r
    gives row r's byte offset of matrix i; lane j receives word j % 4 of
    row j / 4 of each matrix."""
    flat = tile.reshape(-1)
    out = np.zeros((32, 4))
    for i in range(4):
        for r in range(8):
            base = offsets[8 * i + r] // 4
            out[4 * r:4 * r + 4, i] = flat[base:base + 4]
    return out


def _frag32(P):
    """The kernels' Frag32 lane offsets (bytes) into [rows][P] f32 tiles:
    (a, b) — the A fragment of a 16x8 block, {b0, b1} of two n-tiles."""
    lane = np.arange(32)
    return (4 * ((lane & 15) * P + (lane >> 4) * 4),
            4 * (((lane & 7) + (lane >> 4) * 8) * P + ((lane >> 3) & 1) * 4))


def _acc_as_a(c):
    """An accumulator's registers [32, 4] as the A fragment of the next
    product, its columns permuted within the eight (A column t is
    accumulator column 2t, t + 4 is 2t + 1)."""
    return c[:, [0, 2, 1, 3]]


def _b_rows(tile, r0, n):
    """{b0, b1} of the B fragment whose k rows are tile rows r0.. under
    the same permutation (k = t is row r0 + 2t, t + 4 is r0 + 2t + 1),
    column 8n + lane / 4: the kernels' 32-bit shared loads."""
    return np.array([[tile[r0 + 2 * (ln & 3), 8 * n + (ln >> 2)],
                      tile[r0 + 2 * (ln & 3) + 1, 8 * n + (ln >> 2)]]
                     for ln in range(32)])


def _b_row_banks(P, r0=0):
    """The shared-memory banks of a warp's two 32-bit B loads at rows r0 +
    2t and r0 + 2t + 1, column lane / 4, of a [rows][P] f32 tile."""
    return [{((r0 + 2 * (ln & 3) + w) * P + (ln >> 2)) % 32
             for ln in range(32)} for w in (0, 1)]
