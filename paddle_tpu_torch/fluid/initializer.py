"""Parameter initializers (reference python/paddle/v2/fluid/initializer.py:
Constant, Uniform, Normal, Xavier, MSRA, Bilinear). Each appends an init op
to the startup program; the startup run executes them with a
deterministic per-op PRNG stream (the JAX package's threefry key
schedule, utils/prng.py)."""

from __future__ import annotations

import numpy as np

__all__ = [
    "Initializer",
    "Constant",
    "Uniform",
    "Normal",
    "TruncatedNormal",
    "Xavier",
    "MSRA",
    "Bilinear",
    "ConstantInitializer",
    "UniformInitializer",
    "NormalInitializer",
    "XavierInitializer",
    "MSRAInitializer",
    "force_init_on_cpu",
    "init_on_cpu",
]


def force_init_on_cpu():
    # placement is the Executor's place; kept for API parity
    return False


import contextlib


@contextlib.contextmanager
def init_on_cpu():
    yield


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError

    def _fan_in_out(self, var):
        shape = var.shape
        if len(shape) < 2:
            return int(shape[0]) if shape else 1, int(shape[0]) if shape else 1
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
        return fan_in, fan_out


class Constant(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant",
            outputs={"Out": var},
            attrs={"shape": var.shape, "dtype": var.dtype, "value": float(self.value)},
        )


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random",
            outputs={"Out": var},
            attrs={
                "shape": var.shape,
                "dtype": var.dtype,
                "min": float(self.low),
                "max": float(self.high),
                "seed": self.seed,
            },
        )


class Normal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            type="gaussian_random",
            outputs={"Out": var},
            attrs={
                "shape": var.shape,
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
        )


class TruncatedNormal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": var},
            attrs={
                "shape": var.shape,
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
        )


class Xavier(Initializer):
    """Glorot init (reference initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = self._fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fi
        fan_out = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            Uniform(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / (fan_in + fan_out)))
            Normal(0.0, std, self.seed)(var, block)


class MSRA(Initializer):
    """He init (reference initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.seed = seed

    def __call__(self, var, block):
        fi, _ = self._fan_in_out(var)
        fan_in = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = float(np.sqrt(6.0 / fan_in))
            Uniform(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / fan_in))
            Normal(0.0, std, self.seed)(var, block)


class Bilinear(Initializer):
    """For conv2d_transpose upsampling kernels (reference BilinearInitializer)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D weight")
        c_out, c_in, h, w = shape
        f = np.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype=np.float32)
        for i in range(h):
            for j in range(w):
                v = (1 - abs(i / f - c)) * (1 - abs(j / f - c))
                weight[:, :, i, j] = v
        block.append_op(
            type="assign_value",
            outputs={"Out": var},
            attrs={
                "shape": shape,
                "dtype": var.dtype,
                "values": weight.reshape(-1).tolist(),
            },
        )


# reference-compatible aliases
ConstantInitializer = Constant
UniformInitializer = Uniform
NormalInitializer = Normal
XavierInitializer = Xavier
MSRAInitializer = MSRA
