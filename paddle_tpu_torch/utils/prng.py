"""Counter-based threefry2x32 PRNG, bit-exact with jax.random's default
implementation (threefry2x32 with `jax_threefry_partitionable=True`).

The serving engine samples with `categorical(fold_in(PRNGKey(seed),
count), logits / T)`: a request's token i depends only on (seed, i),
never on slot assignment or batching, so sampled requests reproduce
across engines, slot counts and resumes. Porting the key schedule bit
for bit keeps that contract across the two packages: the JAX engine and
this one sample the same tokens from the same logits.

Keys are int64 tensors of shape [..., 2] holding uint32 values (torch
has little uint32 arithmetic, so the threefry rounds run in int64 masked
to 32 bits). Functions work on any device the key lives on.

What is ported (jax/_src/prng.py threefry_2x32 / threefry_seed /
_threefry_fold_in / _threefry_split_foldlike /
_threefry_random_bits_partitionable; jax/_src/random.py _uniform,
_gumbel (mode "low") and categorical):
  PRNGKey(seed)        -> [0, seed mod 2^32]
  fold_in(key, data)   -> threefry(key, (0, data))
  split(key, num)      -> threefry(key, (0, i)) for i < num
  categorical(key, l)  -> argmax(gumbel(key, l.shape) + l)
  uniform(key, s, lo, hi) -> max(lo, floats * (hi - lo) + lo)
  randint(key, s, lo, hi) -> lo + (hi_bits % span * (2^16 % span)^2
                                   + lo_bits % span) % span, int32
  normal(key, s)       -> sqrt(2) * erfinv(uniform(key, s, -1+ulp, 1))
  truncated_normal(key, lo, hi, s) -> the same through erf(lo), erf(hi)

The uniform bits are exact; normal and truncated_normal pass them
through torch's erfinv, which may differ from XLA's by a few ulp.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PRNGKey", "fold_in", "split", "uniform", "randint", "normal",
           "truncated_normal", "categorical"]

_M = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(np.finfo(np.float32).tiny)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher, 20 rounds: keys (k1, k2) and
    counters (x1, x2) are broadcastable int64 tensors of uint32 values;
    returns the two uint32 output words as int64 tensors."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + k1) & _M
    x2 = (x2 + k2) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M
            x2 = x1 ^ _rotl(x2, r)
        x1 = (x1 + ks[(i + 1) % 3]) & _M
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for an integer seed (32-bit mode: the
    seed's low 32 bits, high word 0)."""
    return torch.tensor([0, int(seed) & _M], dtype=torch.int64,
                        device=device)


def fold_in(key, data):
    """jax.random.fold_in for keys [..., 2] and integer data broadcast
    over the key batch (vmapped fold_in when both are batched)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _M
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def split(key, num: int = 2):
    """jax.random.split(key, num) for one key [2] -> [num, 2]."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([y1, y2], dim=-1)


def _bits32(key, n: int, offset: int = 0):
    """32 random bits per element of a flat [n] counter range for each
    key in the batch: keys [..., 2] -> [..., n] (partitionable layout:
    counter i is the uint64 (hi, lo) = (i >> 32, i & 0xffffffff)). With
    `offset`, the range starts at counter `offset`: elements offset ..
    offset + n - 1 of a larger draw, bit for bit (a rank's slice of a
    draw over the global batch, fluid/core/spmd.py); an int64 tensor of
    n counters picks those elements (a rank's block along another
    dimension)."""
    if isinstance(offset, torch.Tensor):
        i = offset.to(key.device)
    else:
        i = torch.arange(offset, offset + n, dtype=torch.int64,
                         device=key.device)
    b1, b2 = threefry2x32(key[..., 0:1], key[..., 1:2], i >> 32, i & _M)
    return b1 ^ b2


def uniform(key, shape, minval=0.0, maxval=1.0, offset=0):
    """jax.random.uniform(key, shape, float32, minval, maxval) for one
    key [2]: the mantissa of 1.0 filled with the top 23 random bits,
    scaled into [minval, maxval). `offset`: the elements from flat index
    `offset` on of a larger draw (_bits32)."""
    shape = tuple(shape)
    bits = _bits32(key, int(np.prod(shape, dtype=np.int64)), offset)
    return _to_uniform(bits, minval, maxval).reshape(shape)


def _mul32(a, b):
    """a * b mod 2^32 for int64 tensors of uint32 values, without the
    int64 overflow of a full product: b in 16-bit halves."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & _M) << 16
    return (lo + hi) & _M


def randint(key, shape, minval, maxval, offset=0):
    """jax.random.randint(key, shape, minval, maxval) with its default
    int32 dtype, for one key [2] and integer bounds (jax/_src/random.py
    _randint): 32 bits from each half of split(key), combined modulo
    span = maxval - minval (1 when maxval <= minval) through the
    multiplier (2^16 mod span)^2 mod span, every product and sum
    wrapping at 2^32 as uint32 arithmetic does."""
    shape = tuple(shape)
    lo, hi = int(minval), int(maxval)
    if not (-2 ** 31 <= lo < 2 ** 31 and -2 ** 31 <= hi < 2 ** 31):
        raise ValueError("randint bounds must fit int32: [%d, %d)" % (lo, hi))
    span = (hi - lo) & _M if hi > lo else 1
    n = int(np.prod(shape, dtype=np.int64))
    k1, k2 = split(key, 2)
    higher, lower = _bits32(k1, n, offset), _bits32(k2, n, offset)
    mult = (((1 << 16) % span) ** 2 & _M) % span
    off = (_mul32(higher % span, torch.full_like(higher, mult))
           + lower % span) & _M
    out = (lo + off % span) & _M
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(
        torch.int32).reshape(shape)


_SQRT2_F32 = float(np.float32(np.sqrt(2)))


def normal(key, shape, offset=0):
    """jax.random.normal(key, shape) in float32: sqrt(2) * erfinv(u) over
    uniform bits in (-1, 1) (jax/_src/random.py _normal_real)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return _SQRT2_F32 * torch.erfinv(uniform(key, shape, lo, 1.0, offset))


def truncated_normal(key, lower, upper, shape):
    """jax.random.truncated_normal(key, lower, upper, shape) in float32
    (jax/_src/random.py _truncated_normal): the uniform bits scaled into
    [erf(lower / sqrt2), erf(upper / sqrt2)), through erfinv, clipped to
    the open interval (lower, upper)."""
    bounds = torch.tensor([lower, upper], dtype=torch.float32)
    a, b = torch.erf(bounds / _SQRT2_F32).tolist()
    out = _SQRT2_F32 * torch.erfinv(uniform(key, shape, a, b))
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    return out.clamp(lo, hi)


def _to_uniform(bits, minval, maxval):
    # x in [1, 2): the top 23 bits as the mantissa of 1.0
    x = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = np.float32(minval)
    span = np.float32(maxval) - lo  # float32 arithmetic, as in JAX
    if span == 1.0:
        # XLA folds (x - 1) * 1 + lo into x + (lo - 1) when the bounds
        # are constants of the compiled step, which rounds differently
        # from (x - 1) + lo
        out = x + float(lo - np.float32(1.0))
    else:
        # one fused multiply-add, as XLA contracts (x - 1) * span + lo
        out = torch.addcmul(torch.full_like(x, float(lo)), x - 1.0,
                            torch.full_like(x, float(span)))
    return out.clamp_min(float(lo))


def categorical(key, logits, shape=None, offset=0):
    """Sample over the last axis of float32 `logits` with the Gumbel-max
    trick, as jax.random.categorical(key, logits, axis=-1) (gumbel mode
    "low"). `key` is one key [2] — the gumbel noise then spans the
    whole logits shape, as in JAX — or per-row keys [*B, 2] for logits
    [*B, V], which is `jax.vmap(categorical)` over the rows. `shape`
    (one key only) draws samples of that shape from logits whose batch
    dims broadcast to it, as JAX's `shape=` does: the noise then spans
    shape + [V]. `offset` (one key only) starts the noise at that flat
    element of a larger draw (_bits32)."""
    V = logits.shape[-1]
    if shape is not None:
        if key.dim() != 1:
            raise ValueError("categorical(shape=...) takes one key")
        noise_shape = tuple(shape) + (V,)
        bits = _bits32(key, int(np.prod(noise_shape, dtype=np.int64)),
                       offset)
        bits = bits.reshape(noise_shape)
    elif key.dim() == 1:
        bits = _bits32(key, logits.numel(), offset).reshape(logits.shape)
    else:
        if tuple(key.shape[:-1]) != tuple(logits.shape[:-1]):
            raise ValueError("per-row keys %s do not match logits %s"
                             % (tuple(key.shape), tuple(logits.shape)))
        bits = _bits32(key, V)
    u = _to_uniform(bits, _TINY_F32, 1.0)
    g = -torch.log(-torch.log(u))
    return torch.argmax(g + logits, dim=-1)
