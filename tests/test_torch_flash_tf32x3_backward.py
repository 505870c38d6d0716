"""The f32 flash backward's 3xTF32 scheme (flash_backward_kv_tf32x3_kernel
and flash_backward_q_tf32x3_kernel in
paddle_tpu_torch/csrc/flash_attention.cu), emulated in numpy on the CPU
and held against the JAX package's Pallas backward in interpret mode.

The emulation does the kernels' splits in their order (tf32x3_emulation:
three TF32 products a product, k-steps of 8 summed into f32
accumulators). dK/dV: a CTA of 128 keys steps 64-row q tiles from its
diagonal in 16-row slices; S^T = K.Q^T and dP^T = V.g^T over the head
dim, P^T = exp(S^T * scale - lse), exactly 0 where masked, dS^T = P^T *
(dP^T - delta) * scale, then P^T.g and dS^T.Q over the slice's rows into
fresh sums, added to dV and dK once a slice. dQ: a CTA of 64 q
rows steps 64-key tiles up to its diagonal in 32-key halves; S = Q.K^T
and dP = g.V^T, dS as above, dS.K into the tile's sums, added to dQ.
Steps the kernels skip (a warp's rows out of reach) add exact zeros
here. The emulation rounds every f32 sum to nearest; mma.sync truncates
inside a product, which this cannot show (chip_smoke.py phase 5 holds
the kernels on the card). The
bar is chip_smoke.py phase 5's f32 bar, 1e-4 on dq, dk and dv; one TF32
product alone (hi.hi) is shown to miss it. The lane maps of the
fragments (ldmatrix over f32 rows for K.Q^T, the accumulators as A
fragments under the [0, 2, 1, 3] permutation, the 32-bit B loads) are
checked against the plain products.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tf32x3_emulation import (_acc_as_a, _b_row_banks, _b_rows, _c_frag,
                              _frag32, _ldsm4, _mma, _mma_lanes)

jfa_mod = importlib.import_module("paddle_tpu.parallel.flash_attention")

_BAR = 1e-4
_KV_ROWS = 128  # keys a dK/dV CTA owns (8 warps x 16)
_Q_ROWS = 64    # q rows a dQ CTA owns (4 warps x 16)
_STEP = 64      # rows of a streamed tile


def _probs_ds(s, dp, lse, delta, keep, scale):
    """P = exp(S * scale - lse), exactly 0 where masked, and dS = P *
    (dP - delta) * scale, all in f32 (lse and delta broadcast)."""
    p = np.where(keep, np.exp(s * scale - lse), np.float32(0))
    return p.astype(np.float32), (p * (dp - delta) * scale).astype(
        np.float32)


def _backward(q, k, v, g, lse, delta, causal, products=3):
    """The kernels' backward of [B, T, H, D] f32 inputs (k/v [B, S, H,
    D]) from the forward's lse and delta [B, H, T] -> (dq, dk, dv)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = np.float32(D ** -0.5)
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for b in range(B):
        for h in range(H):
            Q, K, V, G = q[b, :, h], k[b, :, h], v[b, :, h], g[b, :, h]
            L, Dl = lse[b, h], delta[b, h]
            # dK/dV: 128 keys a CTA, q rows from the diagonal tile
            for k0 in range(0, S, _KV_ROWS):
                keys = np.arange(k0, min(k0 + _KV_ROWS, S))
                dka = np.zeros((len(keys), D), np.float32)
                dva = np.zeros((len(keys), D), np.float32)
                for q0 in range(k0 // _STEP * _STEP if causal else 0, T,
                                16):
                    rows = np.arange(q0, min(q0 + 16, T))
                    sT = _mma(K[keys], Q[rows].T, products)
                    dpT = _mma(V[keys], G[rows].T, products)
                    keep = rows[None] >= keys[:, None] if causal else True
                    pT, dsT = _probs_ds(sT, dpT, L[rows][None],
                                        Dl[rows][None], keep, scale)
                    dva = dva + _mma(pT, G[rows], products)
                    dka = dka + _mma(dsT, Q[rows], products)
                dk[b, keys, h], dv[b, keys, h] = dka, dva
            # dQ: 64 q rows a CTA, keys up to the diagonal in halves
            for q0 in range(0, T, _Q_ROWS):
                rows = np.arange(q0, min(q0 + _Q_ROWS, T))
                end = S
                if causal:
                    end = min(S, ((q0 + _Q_ROWS - 1) // _STEP + 1) * _STEP)
                acc = np.zeros((len(rows), D), np.float32)
                for t0 in range(0, end, _STEP):
                    ta = np.zeros_like(acc)
                    for kh in range(t0, min(t0 + _STEP, end), 32):
                        keys = np.arange(kh, min(kh + 32, S))
                        s = _mma(Q[rows], K[keys].T, products)
                        dp = _mma(G[rows], V[keys].T, products)
                        keep = rows[:, None] >= keys[None] if causal else True
                        _, ds = _probs_ds(s, dp, L[rows][:, None],
                                          Dl[rows][:, None], keep, scale)
                        ta = _mma(ds, K[keys], products, ta)
                    acc = acc + ta
                dq[b, rows, h] = acc
    return dq, dk, dv


def _jax_backward(q, k, v, g, causal):
    """The Pallas forward and backward (interpret mode) -> (dq, dk, dv
    [B, *, H, D], lse and delta [B, H, T]), delta = rowsum(g * o) as
    `_flash_bwd` computes it."""
    B, T, H, D = q.shape
    S = k.shape[1]

    def bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, -1, D)

    def unbh(x, n):
        return np.asarray(x).reshape(B, H, n, D).transpose(0, 2, 1, 3)

    bq = 64 if T % 64 == 0 else T
    bk = 64 if S % 64 == 0 else S
    scale = D ** -0.5
    with jax.default_matmul_precision("float32"):
        o, lse = jfa_mod._fa_forward(bh(q), bh(k), bh(v), scale, causal, bq,
                                     bk, True)
        dq, dk, dv = jfa_mod._flash_bwd(scale, causal, bq, bk, True,
                                        (bh(q), bh(k), bh(v), o, lse), bh(g))
        delta = jnp.sum(bh(g) * o, axis=-1)
    return (unbh(dq, T), unbh(dk, S), unbh(dv, S),
            np.asarray(lse).reshape(B, H, T),
            np.asarray(delta).reshape(B, H, T))


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T,S,causal", [(128, 128, True), (128, 192, False),
                                        (100, 100, True), (100, 100, False)])
def test_tf32x3_backward_matches_jax_backward(T, S, causal, D):
    rng = np.random.RandomState(T + S + D + causal)
    q, g = (rng.randn(2, T, 2, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, S, 2, D).astype(np.float32) for _ in range(2))
    want = _jax_backward(q, k, v, g, causal)
    lse, delta = want[3:]
    got3 = _backward(q, k, v, g, lse, delta, causal, products=3)
    got1 = _backward(q, k, v, g, lse, delta, causal, products=1)
    err3 = max(np.abs(a - b).max() for a, b in zip(got3, want))
    err1 = max(np.abs(a - b).max() for a, b in zip(got1, want))
    print("T %d S %d D %d causal %s: 3xTF32 max abs err %.3e, one TF32 "
          "product %.3e (bar %.0e)" % (T, S, D, causal, err3, err1, _BAR))
    for name, a, b in zip(("dq", "dk", "dv"), got3, want):
        np.testing.assert_allclose(a, b, atol=_BAR, rtol=_BAR, err_msg=name)
    assert err1 > _BAR > err3


@pytest.mark.parametrize("D", [32, 64, 128])
def test_backward_lane_maps_reproduce_the_products(D):
    """From the kernels' Frag32 offsets, the accumulators as A fragments
    under the [0, 2, 1, 3] permutation and the 32-bit B loads: S^T =
    K.Q^T (dK/dV), P^T.g and dS^T.Q (dK/dV) and dS.K (dQ) exactly, over
    [rows][D + 4] tiles, with a warp's 32-bit loads on 32 banks."""
    P = D + 4
    rng = np.random.RandomState(D)
    K, Q, G = rng.randn(16, D), rng.randn(16, D), rng.randn(16, D)
    pad = lambda x: np.pad(x, ((0, 0), (0, 4)))  # noqa: E731
    sK, sQ, sG = pad(K), pad(Q), pad(G)
    fa, fb = _frag32(P)
    # S^T = K.Q^T: K's A fragments (ldmatrix, a), Q's B (ldmatrix, b);
    # n-tile j = q rows 8j..
    st = np.zeros((2, 32, 4))
    for kd in range(D // 8):
        kf = _ldsm4(sK, P, fa + 4 * 8 * kd)
        qf = _ldsm4(sQ, P, fb + 4 * 8 * kd)
        st[0] = _mma_lanes(st[0], kf, qf[:, :2])
        st[1] = _mma_lanes(st[1], kf, qf[:, 2:])
    want = K @ Q.T
    for j in range(2):
        np.testing.assert_allclose(st[j], _c_frag(want[:, 8 * j:8 * j + 8]),
                                   atol=1e-12)
    # dV += P^T.g and dK += dS^T.Q: k-step j = q rows 8j.., the
    # accumulators of S^T's shape as A fragments, g and Q by 32-bit loads
    for tile, rows in ((sG, G), (sQ, Q)):
        a_t = rng.rand(16, 16)  # P^T or dS^T: 16 keys x 16 q rows
        acc = np.zeros((D // 8, 32, 4))
        for j in range(2):
            a = _acc_as_a(_c_frag(a_t[:, 8 * j:8 * j + 8]))
            for n in range(D // 8):
                acc[n] = _mma_lanes(acc[n], a, _b_rows(tile, 8 * j, n))
        want = a_t @ rows
        for n in range(D // 8):
            np.testing.assert_allclose(
                acc[n], _c_frag(want[:, 8 * n:8 * n + 8]), atol=1e-12)
    # dQ += dS.K: dS 16 q rows x 32 keys, k-step j = keys 8j.., K by
    # 32-bit loads of a [32][D + 4] tile
    K32 = rng.randn(32, D)
    sK32 = pad(K32)
    ds = rng.rand(16, 32)
    acc = np.zeros((D // 8, 32, 4))
    for j in range(4):
        a = _acc_as_a(_c_frag(ds[:, 8 * j:8 * j + 8]))
        for n in range(D // 8):
            acc[n] = _mma_lanes(acc[n], a, _b_rows(sK32, 8 * j, n))
    want = ds @ K32
    for n in range(D // 8):
        np.testing.assert_allclose(acc[n], _c_frag(want[:, 8 * n:8 * n + 8]),
                                   atol=1e-12)
    # a warp's 32-bit loads of the g, Q and K tiles fall on 32 distinct
    # banks at any row offset, and ldmatrix's eight rows on distinct
    # 16-byte units
    for r0 in (0, 8, 17):
        assert all(len(banks) == 32 for banks in _b_row_banks(P, r0))
    assert len({(r * P * 4 // 16) % 8 for r in range(8)}) == 8
