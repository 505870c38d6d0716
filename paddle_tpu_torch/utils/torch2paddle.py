"""Convert PyTorch weights into the v2 Parameters tar wire format
(reference python/paddle/utils/torch2paddle.py, which converted torch7
serialized models).

Modernised for torch state_dicts: map each tensor to a parameter name
in this framework and write the same tar the v2 trainer/Parameters
load (`v2/parameters.py` wire format), so converted weights drop into
`Parameters.from_tar` / `merge_v2_model` / the trainer CLI.

Usage:
    from paddle_tpu_torch.utils.torch2paddle import torch2paddle
    torch2paddle(model.state_dict(),
                 name_map={"fc.weight": "__fc_0__.w0",
                           "fc.bias": "__fc_0__.wbias"},
                 output="params.tar")

Linear layers: torch stores [out, in]; paddle stores [in, out] — by
default every 2-D tensor whose torch name ends with 'weight' is
transposed; pass an explicit `transpose` iterable to override.

A tensor may lie on the card: it is copied to the host (a bfloat16 one
through float32) before it is written as float32.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

__all__ = ["torch2paddle"]


def torch2paddle(state_dict, name_map: Dict[str, str], output,
                 transpose: Optional[Iterable[str]] = None):
    """state_dict: torch name -> tensor (torch.Tensor or ndarray);
    name_map: torch name -> paddle parameter name; output: path or file
    object for the tar. Unmapped state_dict entries are skipped;
    name_map entries missing from the state_dict raise."""
    import tarfile

    from ..v2.parameters import write_tar_param

    missing = [k for k in name_map if k not in state_dict]
    if missing:
        raise KeyError("name_map entries not in state_dict: %r" % missing)

    def _np(t):
        if hasattr(t, "detach"):
            t = t.detach().cpu()
            if str(t.dtype) == "torch.bfloat16":
                t = t.float()
            t = t.numpy()
        return np.asarray(t, np.float32)

    transpose_set = None if transpose is None else set(transpose)
    arrays = {}
    for torch_name, paddle_name in name_map.items():
        a = _np(state_dict[torch_name])
        auto_t = transpose_set is None and torch_name.endswith("weight") \
            and a.ndim == 2
        if auto_t or (transpose_set is not None
                      and torch_name in transpose_set):
            a = a.T
        arrays[paddle_name] = np.ascontiguousarray(a)

    close = False
    if not hasattr(output, "write"):
        output = open(output, "wb")
        close = True
    try:
        with tarfile.open(fileobj=output, mode="w") as tar:
            for name, a in arrays.items():
                write_tar_param(tar, name, a)
    finally:
        if close:
            output.close()
    return sorted(arrays)
