"""The port's threefry PRNG (paddle_tpu_torch/utils/prng.py) bit for bit
against jax.random (threefry2x32, partitionable layout): keys, fold_in,
split, uniform floats, and categorical draws — single-key and per-row
(vmapped) — over a few seeds, counts and shapes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu_torch.utils import prng

torch.set_num_threads(2)

SEEDS = [0, 1, 12345, 2**31 + 5, -3]


def _np(t):
    return t.numpy().astype(np.int64)


def _jnp(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_bit_identical(seed):
    k, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(kt), _jnp(k))
    for d in (0, 1, 7, 4095, 2**32 - 1):
        np.testing.assert_array_equal(_np(prng.fold_in(kt, d)),
                                      _jnp(jax.random.fold_in(k, d)))
    for n in (2, 3):
        np.testing.assert_array_equal(_np(prng.split(kt, n)),
                                      _jnp(jax.random.split(k, n)))
    # batched fold_in == vmapped fold_in (the engine's per-slot keys)
    counts = np.array([0, 3, 17, 250], np.int32)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in (seed, 9, 10, 11)])
    kts = torch.stack([prng.PRNGKey(s) for s in (seed, 9, 10, 11)])
    np.testing.assert_array_equal(
        _np(prng.fold_in(kts, torch.from_numpy(counts))),
        _jnp(jax.vmap(jax.random.fold_in)(keys, jnp.asarray(counts))))


@pytest.mark.parametrize("shape", [(7,), (5, 3), (2, 3, 4)])
def test_uniform_bit_identical(shape):
    for seed in SEEDS[:3]:
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                             shape))
        got = prng.uniform(prng.PRNGKey(seed), shape).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("V", [5, 50, 1000])
def test_categorical_identical(V):
    rng = np.random.RandomState(V)
    for seed in SEEDS:
        lg = (rng.randn(6, V) * 2.0).astype(np.float32)
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 4)
        kt = prng.fold_in(prng.PRNGKey(seed), 4)
        # one key over [B, V] (gumbel noise spans the whole shape)
        np.testing.assert_array_equal(
            prng.categorical(kt, torch.from_numpy(lg)).numpy(),
            np.asarray(jax.random.categorical(k, lg)))
        np.testing.assert_array_equal(
            prng.categorical(kt, torch.from_numpy(lg[0])).numpy(),
            np.asarray(jax.random.categorical(k, lg[0])))
        # per-row keys: vmap(categorical), the engine's decode sampler
        idx = np.arange(6, dtype=np.int32) + 100
        keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
            jax.random.PRNGKey(seed), jnp.asarray(idx))
        kts = prng.fold_in(prng.PRNGKey(seed), torch.from_numpy(idx))
        np.testing.assert_array_equal(
            prng.categorical(kts, torch.from_numpy(lg)).numpy(),
            np.asarray(jax.vmap(jax.random.categorical)(keys, lg)))


@pytest.mark.parametrize("bounds", [(0, 1), (0, 40), (5, 17), (-10, 3),
                                    (0, 65536), (0, 100000), (0, 1040000),
                                    (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
                                    (4, 4)],
                         ids=lambda b: "%d_%d" % b)
def test_randint_bit_identical(bounds):
    """jax.random.randint with its default int32 dtype, as `nce` draws
    its uniform noise: spans of 1 (and empty), powers of two and not,
    ones whose (2^16 mod span)^2 wraps at 2^32, and the full int32
    range."""
    lo, hi = bounds
    for seed in SEEDS:
        for shape in [(7,), (16, 8), (3, 1, 5)]:
            key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
            want = np.asarray(jax.random.randint(key, shape, lo, hi))
            got = prng.randint(prng.fold_in(prng.PRNGKey(seed), 2), shape,
                               lo, hi).numpy()
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(4, 3), (16, 8), (5,)])
def test_categorical_shape_identical(shape):
    """jax.random.categorical(key, logits[1, V], shape=...), as `nce`
    draws noise from `neg_distribution`."""
    rng = np.random.RandomState(len(shape))
    dist = rng.uniform(0, 1, 40).astype(np.float32)
    dist[3] = 0.0  # log 0 = -inf: a class never drawn
    with np.errstate(divide="ignore"):
        logp = np.log(dist / dist.sum())[None, :]
    for seed in SEEDS:
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
        kt = prng.fold_in(prng.PRNGKey(seed), 1)
        np.testing.assert_array_equal(
            prng.categorical(kt, torch.from_numpy(logp), shape=shape).numpy(),
            np.asarray(jax.random.categorical(k, logp, shape=shape)))
