"""Weight quantization for the serving engine (counterpart of
paddle_tpu/serving/quantization.py): per-tensor int8 weights with f32
absmax scales.

A decode step reads every weight byte once per token batch, so int8
weights cut that stream ~4x (LLM.int8-style absmax scaling, Dettmers et
al. 2022, the whole-tensor variant without the outlier split). The
engine quantizes its parameters once at construction and keeps the int8
tree resident; `dequantize_params` is the first operation of every
decode, verify and chunk step, so the dequantized tree exists only for
the length of one step.

Every float leaf with ndim >= 2 is quantized — the embedding and the
positional table too — and 1-D tensors (LayerNorm gains and biases) and
integer leaves pass through: they are noise in the byte stream and load
bearing in the numerics. Codes and scales are bit-identical to the
reference's on the same input (both round half to even in float32).
"""

from __future__ import annotations

import torch

__all__ = ["QuantTensor", "quantize_params", "dequantize_params",
           "params_bytes"]

_INT8_MAX = 127.0


class QuantTensor(object):
    """One per-tensor-quantized weight: int8 `codes`, a 0-d f32 absmax
    `scale`, and the dtype the dequantized tensor comes back in
    (dequant = codes * scale in f32, cast to `out_dtype`)."""

    def __init__(self, codes, scale, out_dtype):
        self.codes = codes
        self.scale = scale
        self.out_dtype = out_dtype

    def dequantize(self):
        return (self.codes.float() * self.scale).to(self.out_dtype)

    @property
    def shape(self):
        return self.codes.shape

    @property
    def device(self):
        return self.codes.device

    @property
    def nbytes(self):
        return self.codes.numel() + 4  # int8 codes + the f32 scale


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def quantize_params(params, min_ndim: int = 2):
    """Per-tensor int8 absmax quantization of every float leaf with
    ndim >= `min_ndim`; everything else passes through untouched. An
    all-zero tensor keeps scale 0 and round-trips to exact zeros."""

    def q(leaf):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < min_ndim \
                or not leaf.is_floating_point():
            return leaf
        f = leaf.float()
        s = f.abs().amax() / _INT8_MAX
        safe = torch.where(s > 0, s, torch.ones_like(s))
        codes = torch.round(f / safe).clamp(-_INT8_MAX, _INT8_MAX)
        return QuantTensor(codes.to(torch.int8), s, leaf.dtype)

    return _map(q, params)


def dequantize_params(params):
    """A plain parameter tree from a `quantize_params` tree; identity on
    trees with no QuantTensor leaves."""
    return _map(lambda leaf: leaf.dequantize()
                if isinstance(leaf, QuantTensor) else leaf, params)


def params_bytes(params) -> int:
    """Device bytes of a parameter tree (quantized leaves count their
    int8 codes and scale) — the weight term of a decode byte bound."""
    total = [0]

    def add(leaf):
        if isinstance(leaf, QuantTensor):
            total[0] += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total[0] += leaf.numel() * leaf.element_size()
        return leaf

    _map(add, params)
    return total[0]
