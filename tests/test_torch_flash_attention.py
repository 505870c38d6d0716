"""The port's flash attention (paddle_tpu_torch/parallel/flash_attention.py)
against the JAX package's Pallas kernels run in interpret mode.

On CPU tensors `_FlashAttention` runs the plain PyTorch versions of the
three kernels — the functions the Hopper kernels are held against on
the card — so these tests pin the forward (o and lse) and the
lse-based backward formulas to the reference, and to torch autograd
through `reference_attention` as an oracle with no JAX in it.

Tolerances (all f32): o and lse at 2e-5, the JAX flash suite's own bar
— the two sides differ only in reduction order (one softmax over the
row here, online (max, sum, acc) over 64-wide blocks in the Pallas
kernel); gradients at 1e-4 against `jax.grad` through the Pallas
backward (the same lse-based formulas, three products deep) and at
3e-4 against autograd of `reference_attention` (another algorithm —
scale folded into q, a softmax Jacobian — the JAX suite's bar for
flash vs reference gradients).

Numeric state: each test runs its JAX calls under
`jax.default_matmul_precision("float32")` and requires torch's float32
matmul precision "highest", whatever an earlier test file on the same
worker left behind; the forward tests also hold each side against a
float64 numpy oracle at the same 2e-5, so a drift names its side (the
lse test holds both its o and its lse so).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.parallel import kernel_utils as jku
from paddle_tpu.parallel.attention import reference_attention as jref
from paddle_tpu_torch.parallel import attention as tat
from paddle_tpu_torch.parallel import kernel_utils as tku

# both packages re-export the function under the module's name
jfa_mod = importlib.import_module("paddle_tpu.parallel.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.parallel.flash_attention")

torch.set_num_threads(2)

_FWD = 2e-5
_GRAD = 1e-4
_GRAD_REF = 3e-4


@pytest.fixture(autouse=True)
def _full_f32_matmuls():
    """Both frameworks multiply in full float32 for every test here."""
    assert torch.get_float32_matmul_precision() == "highest", \
        "torch float32 matmul precision is %r, not 'highest'" \
        % torch.get_float32_matmul_precision()
    assert not torch.is_autocast_enabled("cpu")
    with jax.default_matmul_precision("float32"):
        yield


def _oracle(q, k, v, causal):
    """float64 numpy attention of [B, T, H, D] inputs (k/v [B, S, H,
    D]): the exact answer both sides are held to."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    s = np.einsum("bthd,bshd->bhts", q, k) * q.shape[-1] ** -0.5
    if causal:
        T, S = s.shape[-2:]
        s = np.where(np.tril(np.ones((T, S), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhts,bshd->bthd", p, v)


def _oracle_lse(q, k, causal):
    """float64 log-sum-exp of the scaled scores -> [B, H, T]."""
    q, k = (np.asarray(a, np.float64) for a in (q, k))
    s = np.einsum("bthd,bshd->bhts", q, k) * q.shape[-1] ** -0.5
    if causal:
        T, S = s.shape[-2:]
        s = np.where(np.tril(np.ones((T, S), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


def _forward_held(got, want, q, k, v, causal):
    """Each side within 2e-5 of the float64 oracle, then of each other."""
    exact = _oracle(q, k, v, causal)
    for side, out in (("port (torch)", got.detach().numpy()),
                      ("reference (JAX Pallas)", np.asarray(want))):
        np.testing.assert_allclose(out, exact, atol=_FWD, rtol=_FWD,
                                   err_msg="%s drifted from the float64 "
                                   "oracle" % side)
    _close(got, want, _FWD)


def _qkv(seed, B=2, T=128, H=4, D=32, S=None):
    rng = np.random.RandomState(seed)
    S = T if S is None else S
    q = rng.randn(B, T, H, D).astype(np.float32)
    k = rng.randn(B, S, H, D).astype(np.float32)
    v = rng.randn(B, S, H, D).astype(np.float32)
    g = rng.randn(B, T, H, D).astype(np.float32)
    return q, k, v, g


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def _jflash(q, k, v, causal, bq=64, bk=64):
    return jfa_mod.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   block_q=bq, block_k=bk, interpret=True)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax_kernel(causal):
    q, k, v, _ = _qkv(0)
    want = _jflash(q, k, v, causal)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              block_q=64, block_k=64)
    assert got.shape == q.shape and got.dtype == torch.float32
    _forward_held(got, want, q, k, v, causal)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_matches_jax_residual(causal):
    q, k, v, _ = _qkv(1)
    B, T, H, D = q.shape

    def bh(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, -1, D)

    o_j, lse_j = jfa_mod._fa_forward(bh(q), bh(k), bh(v), D ** -0.5,
                                     causal, 64, 64, True)
    o, lse = tfa.flash_attention_plain(_t(q), _t(k), _t(v), D ** -0.5,
                                       causal)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    # each side against the float64 oracle first, so a drift names it
    exact_lse = _oracle_lse(q, k, causal).reshape(B * H, T, 1)
    for side, got in (("port (torch)", lse.reshape(B * H, T, 1).numpy()),
                      ("reference (JAX Pallas)", np.asarray(lse_j))):
        np.testing.assert_allclose(got, exact_lse, atol=_FWD, rtol=_FWD,
                                   err_msg="%s lse drifted from the "
                                   "float64 oracle" % side)
    exact_o = _oracle(q, k, v, causal).transpose(0, 2, 1, 3).reshape(
        B * H, T, D)
    for side, got in (("port (torch)",
                       o.permute(0, 2, 1, 3).reshape(B * H, T, D).numpy()),
                      ("reference (JAX Pallas)", np.asarray(o_j))):
        np.testing.assert_allclose(got, exact_o, atol=_FWD,
                                   rtol=_FWD, err_msg="%s o drifted from "
                                   "the float64 oracle" % side)
    _close(lse.reshape(B * H, T, 1), lse_j, _FWD)
    _close(o.permute(0, 2, 1, 3).reshape(B * H, T, D), o_j, _FWD)


def test_cross_attention_forward():
    q, k, v, _ = _qkv(2, S=384)
    want = _jflash(q, k, v, False, bq=64, bk=128)
    got = tfa.flash_attention(_t(q), _t(k), _t(v), block_q=64, block_k=128)
    _forward_held(got, want, q, k, v, False)


def _port_grads(q, k, v, g, causal, **kw):
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tfa.flash_attention(tq, tk, tv, causal=causal, **kw)
    out.backward(_t(g))
    return tq.grad, tk.grad, tv.grad


def _jax_grads(q, k, v, g, causal, bq=64, bk=64):
    def f(q, k, v):
        return jnp.sum(jfa_mod.flash_attention(
            q, k, v, causal=causal, block_q=bq, block_k=bk,
            interpret=True) * jnp.asarray(g))

    return jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))


@pytest.mark.parametrize("case", ["causal", "cross"])
def test_gradients_match_jax_pallas_backward(case):
    if case == "causal":
        q, k, v, g = _qkv(3)
        causal, bk = True, 64
    else:  # T != S: dK/dV and dQ walk different extents
        q, k, v, g = _qkv(4, T=128, S=384, H=2)
        causal, bk = False, 128
    got = _port_grads(q, k, v, g, causal, block_q=64, block_k=bk)
    want = _jax_grads(q, k, v, g, causal, bk=bk)
    for a, b in zip(got, want):
        _close(a, b, _GRAD)


@pytest.mark.parametrize("case", ["causal", "cross"])
def test_gradients_match_reference_autograd(case):
    if case == "causal":
        q, k, v, g = _qkv(5)
        causal = True
    else:
        q, k, v, g = _qkv(6, T=128, S=384, H=2)
        causal = False
    got = _port_grads(q, k, v, g, causal)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    tat.reference_attention(tq, tk, tv, causal=causal).backward(_t(g))
    for a, b in zip(got, (tq.grad, tk.grad, tv.grad)):
        _close(a, b.numpy(), _GRAD_REF)


@pytest.mark.parametrize("T", [100, 768])
def test_odd_lengths_forward_and_gradients(T):
    """T=100 runs as one whole-sequence block in JAX, T=768 as 256-row
    blocks; the port's tiles are its own either way."""
    q, k, v, g = _qkv(7 + T, B=1, T=T, H=2, D=32)
    want = _jflash(q, k, v, True, bq=1024, bk=1024)
    _forward_held(tfa.flash_attention(_t(q), _t(k), _t(v), causal=True),
                  want, q, k, v, True)
    got = _port_grads(q, k, v, g, True)
    for a, b in zip(got, _jax_grads(q, k, v, g, True, bq=1024, bk=1024)):
        _close(a, b, _GRAD)


@pytest.mark.parametrize("T,S,D,causal", [
    (128, 128, 40, True),    # D padded to the kernels' 64 bucket
    (128, 128, 128, True),   # D filling the 128 bucket
    (129, 129, 32, True),    # one row past a 128-row tile
    (200, 72, 32, False),    # ragged 64-row steps in q and in k
], ids=["D40", "D128", "causal-T129", "T200-S72"])
def test_tile_edges_forward_and_gradients(T, S, D, causal):
    """The shapes the Hopper tensor-core tiles must mask, through the
    plain versions the card's kernels are held against, vs the Pallas
    kernels run as whole-sequence blocks."""
    q, k, v, g = _qkv(20 + T + S + D, B=1, T=T, H=2, D=D, S=S)
    want = _jflash(q, k, v, causal, bq=1024, bk=1024)
    _forward_held(tfa.flash_attention(_t(q), _t(k), _t(v), causal=causal),
                  want, q, k, v, causal)
    got = _port_grads(q, k, v, g, causal)
    for a, b in zip(got, _jax_grads(q, k, v, g, causal, bq=1024,
                                    bk=1024)):
        _close(a, b, _GRAD)


def test_argument_checks_match_jax():
    q, k, v, _ = _qkv(8, B=1, T=1034, H=1, D=8)
    with pytest.raises(ValueError, match="pad the sequence"):
        tfa.flash_attention(_t(q), _t(k), _t(v))
    with pytest.raises(ValueError, match="pad the sequence"):
        jfa_mod.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), interpret=True)
    q, k, v, _ = _qkv(9, B=1, T=128, H=1, D=8)
    with pytest.raises(ValueError, match="matching q/k lengths"):
        tfa.flash_attention(_t(q), _t(k[:, :64]), _t(v[:, :64]),
                            causal=True)


def test_causal_fill_matches_jax():
    s = np.random.RandomState(10).randn(16, 8).astype(np.float32)
    for qi, kj in ((0, 0), (1, 0), (0, 1), (2, 3)):
        want = jku.causal_fill(jnp.asarray(s), qi, kj, 16, 8)
        got = tku.causal_fill(_t(s), qi, kj, 16, 8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_backward_plain_split_equals_whole():
    """The two plain backward halves (the dK/dV and dQ kernels' plain
    versions) compose to the whole plain backward, given delta."""
    q, k, v, g = [_t(a) for a in _qkv(11, T=64)]
    o, lse = tfa.flash_attention_plain(q, k, v, 0.25, True)
    dq, dk, dv = tfa.flash_backward_plain(q, k, v, o, lse, g, 0.25, True)
    delta = (g * o).sum(-1).permute(0, 2, 1)
    dk2, dv2 = tfa.flash_backward_kv_plain(q, k, v, g, lse, delta, 0.25,
                                           True)
    dq2 = tfa.flash_backward_q_plain(q, k, v, g, lse, delta, 0.25, True)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2)


def test_bf16_rounding_points_follow_the_tpu_kernel():
    """bf16 inputs: o is P (rounded to bf16) times V over the f32 sum,
    so it differs from the unrounded f32 result by bf16 rounding only."""
    q, k, v, _ = [_t(a).to(torch.bfloat16) for a in _qkv(12, T=64)]
    o, lse = tfa.flash_attention_plain(q, k, v, 0.25, True)
    o32, lse32 = tfa.flash_attention_plain(q.float(), k.float(), v.float(),
                                           0.25, True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(lse, lse32)  # scores and lse stay f32
    np.testing.assert_allclose(o.float().numpy(), o32.numpy(), atol=2e-2)


def test_cpu_counts_no_launch_and_foreign_devices_raise():
    q, k, v, g = [_t(a) for a in _qkv(13, T=64)]
    before = dict(tfa.flash_attention.launches)
    _port_grads(*[a.numpy() for a in (q, k, v, g)], True)
    assert tfa.flash_attention.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention(q.to("meta"), k, v)


def test_sequence_parallel_attention_dispatch():
    q, k, v, _ = _qkv(14, T=64)
    tq, tk, tv = _t(q), _t(k), _t(v)
    _close(tat.sequence_parallel_attention(tq, tk, tv, impl="flash",
                                           causal=True),
           _jflash(q, k, v, True), _FWD)
    _close(tat.sequence_parallel_attention(tq, tk, tv, impl="ring",
                                           causal=True),
           jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                causal=True), _FWD)
    with pytest.raises(ValueError, match="causal-only"):
        tat.sequence_parallel_attention(tq, tk, tv, impl="zigzag")
    # a mesh without the axis, or with it at extent 1, takes the
    # one-device branch, as in the JAX package (mesh runs:
    # tests/test_torch_seq_parallel.py)
    import types

    for mesh in (types.SimpleNamespace(axis_names=("data",),
                                       shape={"data": 2}),
                 types.SimpleNamespace(axis_names=("seq",), shape={"seq": 1})):
        _close(tat.sequence_parallel_attention(tq, tk, tv, mesh=mesh,
                                               impl="flash", causal=True),
               _jflash(q, k, v, True), _FWD)
        with pytest.raises(ValueError, match="causal-only"):
            tat.sequence_parallel_attention(tq, tk, tv, mesh=mesh,
                                            impl="zigzag")


def test_kernel_argument_checks():
    """What the wrappers refuse before a pointer reaches the kernel:
    dtypes, shapes, head widths, and lse/delta rows of the wrong type or
    shape (checked here on CPU tensors; the checks read no device)."""
    q, k, v, g = [_t(a) for a in _qkv(15, B=1, T=16, H=2, D=32)]
    assert tfa._check(q, k, v, g) == (1, 16, 2, 32, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._check(q.half(), k.half(), v.half())
    with pytest.raises(TypeError, match="share a dtype"):
        tfa._check(q, k, v, g.to(torch.bfloat16))
    with pytest.raises(ValueError, match=r"\[B, S, H, D\]"):
        tfa._check(q, k[:, :, :1], v)
    with pytest.raises(ValueError, match="D <= 128"):
        wide = torch.zeros(1, 16, 1, 136)
        tfa._check(wide, wide, wide)
    rows = torch.zeros(1, 2, 16)
    tfa._check_rows(q, rows, rows)
    with pytest.raises(ValueError, match="lse and delta"):
        tfa._check_rows(q, rows, rows[..., :8])
    with pytest.raises(ValueError, match="lse and delta"):
        tfa._check_rows(q, rows.double(), rows)
