"""The port's paged attention (paddle_tpu_torch/parallel/paged_attention.py)
against the JAX package's Pallas kernel run in interpret mode.

On CPU tensors each wrapper runs its plain PyTorch version — the
function the Hopper kernel is held against on the card — so these
tests pin that version to the reference: decode, verify and prefill
windows over random pools whose tables carry -1 tails, at the JAX
suite's own pinned bar (atol/rtol 2e-5, tests/test_paged_kernel.py:
the two sides differ only in reduction order — one-shot softmax here,
online (max, sum, acc) in the Pallas kernel). The garbage-row
invariant (a -1 table tail changes nothing) is checked bit for bit.
The split plain version (the function of the bf16 split-context
kernel, partition by partition) is held to the same bars at 1, 2, 3
and MAXB partitions.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.parallel import paged_attention as jpa
from paddle_tpu_torch.parallel import paged_attention as tpa

torch.set_num_threads(2)

_ATOL = 2e-5
_RTOL = 2e-5

NB, BT, H, DH = 10, 8, 4, 8


def _pools(seed):
    rng = np.random.RandomState(seed)
    k = rng.randn(NB, BT, H, DH).astype(np.float32)
    v = rng.randn(NB, BT, H, DH).astype(np.float32)
    return k, v


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_decode_matches_jax_kernel():
    k, v = _pools(0)
    rng = np.random.RandomState(1)
    tables = np.array([[0, 1, -1, -1], [2, 3, 4, -1], [5, -1, -1, -1]],
                      np.int32)
    pos = np.array([9, 20, 3], np.int32)
    q = rng.randn(3, H, DH).astype(np.float32)
    want = jpa.paged_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(tables),
                                      jnp.asarray(pos), interpret=True)
    got = tpa.paged_decode_attention(_t(q), _t(k), _t(v), _t(tables),
                                     _t(pos))
    assert got.shape == (3, H, DH) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=_RTOL, atol=_ATOL)


def test_verify_matches_jax_kernel():
    k, v = _pools(2)
    rng = np.random.RandomState(3)
    tables = np.array([[0, 1, 2, -1], [3, 4, -1, -1]], np.int32)
    pos = np.array([17, 9], np.int32)
    q = rng.randn(2, 3, H, DH).astype(np.float32)
    want = jpa.paged_verify_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(tables),
                                      jnp.asarray(pos), interpret=True)
    got = tpa.paged_verify_attention(_t(q), _t(k), _t(v), _t(tables),
                                     _t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=_RTOL, atol=_ATOL)


@pytest.mark.parametrize("start", [0, 10])
def test_prefill_matches_jax_kernel(start):
    k, v = _pools(4)
    rng = np.random.RandomState(5)
    table_row = np.array([6, 1, 2, -1], np.int32)
    q = rng.randn(8, H, DH).astype(np.float32)
    want = jpa.paged_prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v),
                                       jnp.asarray(table_row), start,
                                       interpret=True)
    got = tpa.paged_prefill_attention(_t(q), _t(k), _t(v), _t(table_row),
                                      start)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=_RTOL, atol=_ATOL)


def test_garbage_rows_bit_identical():
    """A slot whose table tail is -1 gives output bit-identical to the
    same slot over a fully allocated table, for decode and verify."""
    k, v = _pools(6)
    rng = np.random.RandomState(7)
    partial = np.array([[0, 1, -1, -1], [2, -1, -1, -1]], np.int32)
    full = np.array([[0, 1, 8, 9], [2, 7, 5, 3]], np.int32)
    pos = np.array([9, 5], np.int32)
    q = _t(rng.randn(2, H, DH).astype(np.float32))
    a = tpa.paged_decode_attention(q, _t(k), _t(v), _t(partial), _t(pos))
    b = tpa.paged_decode_attention(q, _t(k), _t(v), _t(full), _t(pos))
    assert torch.equal(a, b)
    qw = _t(rng.randn(2, 2, H, DH).astype(np.float32))
    a = tpa.paged_verify_attention(qw, _t(k), _t(v), _t(partial), _t(pos))
    b = tpa.paged_verify_attention(qw, _t(k), _t(v), _t(full), _t(pos))
    assert torch.equal(a, b)


def test_parked_row_reads_only_the_table():
    """A parked decode row (pos >= MAXB*Bt) attends its whole table —
    garbage nothing reads, but finite and in bounds."""
    k, v = _pools(8)
    tables = np.array([[0, -1, -1, -1]], np.int32)
    pos = np.array([4 * BT], np.int32)
    q = _t(np.ones((1, H, DH), np.float32))
    out = tpa.paged_decode_attention(q, _t(k), _t(v), _t(tables), _t(pos))
    assert torch.isfinite(out).all()


def test_cpu_takes_plain_version_and_counts_no_launch():
    k, v = _pools(9)
    before = dict(tpa.launches)
    tables = _t(np.array([[0, 1, -1, -1]], np.int32))
    q = torch.zeros(1, H, DH)
    tpa.paged_decode_attention(q, _t(k), _t(v), tables, _t(np.array([3])))
    tpa.paged_verify_attention(q[:, None], _t(k), _t(v), tables,
                               _t(np.array([3])))
    tpa.paged_prefill_attention(q, _t(k), _t(v), tables[0], 2)
    assert tpa.launches == before


def test_refuses_quantized_pools_and_foreign_devices():
    k, v = _pools(10)
    tables = _t(np.array([[0, -1, -1, -1]], np.int32))
    q = torch.zeros(1, H, DH)
    sc = torch.ones(NB, H)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        tpa.paged_decode_attention(q, _t(k), _t(v), tables,
                                   _t(np.array([1])), k_scale=sc)
    with pytest.raises(ValueError, match="CUDA device"):
        tpa.paged_decode_attention(q.to("meta"), _t(k), _t(v), tables,
                                   _t(np.array([1])))


# ---------------------------------------------------------------------
# the split plain version: the bf16 kernel's computation, partition by
# partition, against the unsplit plain version (atol/rtol 1e-6: the
# partitions only regroup one f32 softmax, a few ulps) and against the
# JAX kernel (its bar)
# ---------------------------------------------------------------------

MAXB = 4
PARTS = [1, 2, 3, MAXB]
_SPLIT_WINDOWS = {
    "decode": ([[0, 1, -1, -1], [2, 3, 4, -1], [5, -1, -1, -1]], [9, 20, 3],
               (3, 1, H, DH)),
    "verify": ([[0, 1, 2, -1], [3, 4, -1, -1]], [17, 9], (2, 3, H, DH)),
    "prefill": ([[6, 1, 2, -1]], [10], (1, 8, H, DH)),
}


def _split_case(which):
    """(q [S, R, H, Dh], k, v, tables, base) of one window shape."""
    k, v = _pools(11)
    tables, base, shape = _SPLIT_WINDOWS[which]
    q = np.random.RandomState(12).randn(*shape).astype(np.float32)
    return (q, k, v, np.array(tables, np.int32), np.array(base, np.int32))


@functools.lru_cache(maxsize=None)
def _jax_window(which):
    """The JAX kernel (interpret mode) on a window shape, as [S, R, H, Dh]."""
    q, k, v, tables, base = _split_case(which)
    args = (jnp.asarray(k), jnp.asarray(v))
    if which == "decode":
        out = jpa.paged_decode_attention(jnp.asarray(q[:, 0]), *args,
                                         jnp.asarray(tables),
                                         jnp.asarray(base), interpret=True)
        return np.asarray(out)[:, None]
    if which == "verify":
        return np.asarray(jpa.paged_verify_attention(
            jnp.asarray(q), *args, jnp.asarray(tables), jnp.asarray(base),
            interpret=True))
    return np.asarray(jpa.paged_prefill_attention(
        jnp.asarray(q[0]), *args, jnp.asarray(tables[0]), int(base[0]),
        interpret=True))[None]


def _both_plain(which, q, k, v, tables, base, parts):
    kw = dict(scale=1.0 / np.sqrt(DH), scale_in_q=which != "decode")
    args = (_t(q), _t(k), _t(v), _t(tables), _t(base))
    return (tpa.paged_attention_split_plain(*args, parts=parts, **kw),
            tpa.paged_attention_plain(*args, **kw))


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("which", ["decode", "verify", "prefill"])
def test_split_plain_matches_plain_and_jax_kernel(which, parts):
    split, plain = _both_plain(which, *_split_case(which), parts)
    assert split.shape == plain.shape and split.dtype == torch.float32
    torch.testing.assert_close(split, plain, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(split.numpy(), _jax_window(which),
                               rtol=_RTOL, atol=_ATOL)


@pytest.mark.parametrize("parts", PARTS)
def test_split_plain_garbage_rows_bit_identical(parts):
    """At a fixed partition count, a -1 table tail gives output
    bit-identical to a full table, for decode and verify windows."""
    k, v = _pools(6)
    rng = np.random.RandomState(7)
    partial = np.array([[0, 1, -1, -1], [2, -1, -1, -1]], np.int32)
    full = np.array([[0, 1, 8, 9], [2, 7, 5, 3]], np.int32)
    pos = np.array([9, 5], np.int32)
    for R, scale_in_q in ((1, False), (2, True)):
        q = _t(rng.randn(2, R, H, DH).astype(np.float32))
        a, b = (tpa.paged_attention_split_plain(
            q, _t(k), _t(v), _t(tbl), _t(pos), scale=0.35,
            scale_in_q=scale_in_q, parts=parts) for tbl in (partial, full))
        assert torch.equal(a, b)


@pytest.mark.parametrize("parts", PARTS)
def test_split_plain_parked_row_gets_unsplit_result(parts):
    """A parked row (pos >= MAXB*Bt) attends its whole table in every
    partition and gets the unsplit plain version's result."""
    k, v = _pools(8)
    tables = np.array([[0, -1, -1, -1], [3, 1, 4, 2]], np.int32)
    pos = np.array([MAXB * BT, 12], np.int32)
    q = np.random.RandomState(9).randn(2, 1, H, DH).astype(np.float32)
    split, plain = _both_plain("decode", q, k, v, tables, pos, parts)
    assert torch.isfinite(split).all()
    torch.testing.assert_close(split, plain, rtol=1e-6, atol=1e-6)
