"""The f32 flash forward's 3xTF32 scheme (flash_forward_tf32x3_kernel in
paddle_tpu_torch/csrc/flash_attention.cu), emulated in numpy on the CPU
and held against the JAX package's Pallas forward in interpret mode.

The kernel splits each f32 operand x into two TF32 values, hi =
rna(x) and lo = rna(x - hi) (cvt.rna.tf32.f32: 10 stored mantissa bits,
round to nearest, ties away from zero), and takes every product of
tiles a.b as three mma.sync m16n8k8 products accumulated in f32, the
small terms first: a_lo.b_hi, a_hi.b_lo, a_hi.b_hi. The emulation
below does the same splits in the kernel's order: Q.K^T and P.V in
k-steps of 8, each step's 8 products summed exactly and added to the
f32 accumulator, the online softmax over 32-key blocks with the
NEG_INF guards, lse = m + log(max(l, 1e-30)). The bar is chip_smoke.py
phase 5's f32 bar, 1e-4 on o and lse; one TF32 product alone
(hi.hi) is logged beside it. The lane maps of the fragments (ldmatrix
over f32 rows, the key permutation that lets P's accumulator be the A
fragment of P.V) are checked against the plain products.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tf32x3_emulation import _c_frag, _ldsm4, _mma, _mma_lanes, _rna, _split

jfa_mod = importlib.import_module("paddle_tpu.parallel.flash_attention")

NEG_INF = -1e30  # paddle_tpu/parallel/kernel_utils.py NEG_INF
_BAR = 1e-4


def _forward(q, k, v, causal, products=3, block=32):
    """The kernel's forward of [B, T, H, D] f32 inputs (k/v [B, S, H,
    D]) -> (o [B, T, H, D], lse [B, H, T])."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = np.float32(D ** -0.5)
    o = np.zeros_like(q)
    lse = np.zeros((B, H, T), np.float32)
    rows = np.arange(T)[:, None]
    for b in range(B):
        for h in range(H):
            m = np.full((T, 1), NEG_INF, np.float32)
            l = np.zeros((T, 1), np.float32)
            acc = np.zeros((T, D), np.float32)
            for k0 in range(0, S, block):
                kk, vv = k[b, k0:k0 + block, h], v[b, k0:k0 + block, h]
                s = _mma(q[b, :, h], kk.T, products) * scale
                cols = k0 + np.arange(kk.shape[0])[None]
                if causal:
                    s = np.where(rows >= cols, s, np.float32(NEG_INF))
                m_new = np.maximum(m, s.max(-1, keepdims=True))
                alpha = np.where(m <= NEG_INF, np.float32(0),
                                 np.exp(m - m_new)).astype(np.float32)
                p = np.where(s <= NEG_INF, np.float32(0),
                             np.exp(s - m_new)).astype(np.float32)
                l = (l * alpha + p.sum(-1, keepdims=True)).astype(
                    np.float32)
                acc = (acc * alpha + _mma(p, vv, products)).astype(
                    np.float32)
                m = m_new
            denom = np.maximum(l, np.float32(1e-30))
            o[b, :, h] = acc / denom
            lse[b, h] = (m + np.log(denom))[:, 0]
    return o, lse


def _jax_forward(q, k, v, causal):
    """The Pallas forward (interpret mode) -> (o [B, T, H, D], lse [B,
    H, T])."""
    B, T, H, D = q.shape
    S = k.shape[1]

    def bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, -1, D)

    with jax.default_matmul_precision("float32"):
        o, lse = jfa_mod._fa_forward(bh(q), bh(k), bh(v), D ** -0.5, causal,
                                     64 if T % 64 == 0 else T,
                                     64 if S % 64 == 0 else S, True)
    o = np.asarray(o).reshape(B, H, T, D).transpose(0, 2, 1, 3)
    return o, np.asarray(lse).reshape(B, H, T)


def test_split_is_tf32_and_recovers_f32():
    x = np.random.RandomState(0).randn(4096).astype(np.float32) * 10
    hi, lo = _split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21
    # ties round away from zero, as cvt.rna does
    tie = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], np.float32)
    assert _rna(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]


@pytest.mark.parametrize("D", [32, 64])
@pytest.mark.parametrize("T,S,causal", [(128, 128, True), (128, 192, False),
                                        (100, 100, True), (100, 100, False)])
def test_tf32x3_forward_matches_jax_forward(T, S, causal, D):
    rng = np.random.RandomState(T + S + D + causal)
    q, k, v = (rng.randn(2, n, 2, D).astype(np.float32) for n in (T, S, S))
    want_o, want_lse = _jax_forward(q, k, v, causal)
    o3, lse3 = _forward(q, k, v, causal, products=3)
    o1, lse1 = _forward(q, k, v, causal, products=1)
    err3 = max(np.abs(o3 - want_o).max(), np.abs(lse3 - want_lse).max())
    err1 = max(np.abs(o1 - want_o).max(), np.abs(lse1 - want_lse).max())
    print("T %d S %d D %d causal %s: 3xTF32 max abs err %.3e, one TF32 "
          "product %.3e (bar %.0e)" % (T, S, D, causal, err3, err1, _BAR))
    np.testing.assert_allclose(o3, want_o, atol=_BAR, rtol=_BAR)
    np.testing.assert_allclose(lse3, want_lse, atol=_BAR, rtol=_BAR)
    assert err1 > err3


def test_fragment_lane_maps_reproduce_the_products():
    """The kernel's Frag32 offsets (ldmatrix for Q and K), its permuted
    32-bit V loads and P's accumulator as the A fragment give Q.K^T and
    P.V exactly, over [rows][D + 4] tiles."""
    D = 64
    P = D + 4
    rng = np.random.RandomState(1)
    Q, K, V = rng.randn(16, D), rng.randn(32, D), rng.randn(32, D)
    pad = lambda x: np.pad(x, ((0, 0), (0, 4)))  # noqa: E731
    sQ, sK, sV = pad(Q), pad(K), pad(V)
    lane = np.arange(32)
    fa = 4 * ((lane & 15) * P + (lane >> 4) * 4)
    fb = 4 * (((lane & 7) + (lane >> 4) * 8) * P + ((lane >> 3) & 1) * 4)
    s = np.zeros((4, 32, 4))
    for kd in range(D // 8):
        qf = _ldsm4(sQ, P, fa + 4 * 8 * kd)
        for np_ in range(2):
            kf = _ldsm4(sK, P, fb + 4 * (16 * np_ * P + 8 * kd))
            s[2 * np_] = _mma_lanes(s[2 * np_], qf, kf[:, :2])
            s[2 * np_ + 1] = _mma_lanes(s[2 * np_ + 1], qf, kf[:, 2:])
    want = Q @ K.T
    for j in range(4):
        np.testing.assert_allclose(s[j], _c_frag(want[:, 8 * j:8 * j + 8]),
                                   atol=1e-12)
    Pm = rng.rand(16, 32)
    acc = np.zeros((D // 8, 32, 4))
    for j in range(4):
        p = _c_frag(Pm[:, 8 * j:8 * j + 8])
        a = p[:, [0, 2, 1, 3]]  # column t is key 2t, column t + 4 key 2t + 1
        for n in range(D // 8):
            b = np.array([[sV[8 * j + 2 * (ln & 3), 8 * n + (ln >> 2)],
                           sV[8 * j + 2 * (ln & 3) + 1, 8 * n + (ln >> 2)]]
                          for ln in range(32)])
            acc[n] = _mma_lanes(acc[n], a, b)
    want = Pm @ V
    for n in range(D // 8):
        np.testing.assert_allclose(acc[n], _c_frag(want[:, 8 * n:8 * n + 8]),
                                   atol=1e-12)
    # a warp's 32 V loads fall on 32 distinct banks, as do ldmatrix's rows
    for w in (0, 1):
        assert len({((2 * (ln & 3) + w) * P + (ln >> 2)) % 32
                    for ln in range(32)}) == 32
    assert len({(r * P * 4 // 16) % 8 for r in range(8)}) == 8
