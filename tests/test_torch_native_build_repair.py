"""The test helper `torch_native_build` clears a build error that the JAX
package's `paddle_tpu.native` keeps after a lost build race.

`paddle_tpu.native` compiles its libraries to one fixed temporary name
and, when a build fails, keeps the error for the whole process: every
later `lib()` raises "native build failed earlier". Test workers that
start together can lose that race (`tests/test_native_io.py` calls
`available()` at import). `ensure_jax_native()` / `ensure_jax_infer()`
put the library in place under a file lock and then clear the stuck
error, so the port's tests that read through `paddle_tpu.native` load
the fresh library. Each case sets a stand-in error first; `monkeypatch`
puts the module's state back afterwards.
"""

import os

import numpy as np
import pytest

import paddle_tpu.native as jnative
import paddle_tpu.v2.dataset as jds
import paddle_tpu_torch.v2.dataset as tds
from torch_native_build import ensure_jax_infer, ensure_jax_native


def _stand_in():
    return RuntimeError("stand-in for a lost build race")


def test_stuck_build_error_cleared_and_convert_round_trips(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_build_error", _stand_in())
    with pytest.raises(RuntimeError, match="failed earlier"):
        jnative.lib()
    ensure_jax_native()
    assert jnative._build_error is None
    assert jnative.lib() is not None
    samples = [(i, np.arange(i, dtype=np.int64)) for i in range(23)]
    paths = jds.common.convert(str(tmp_path / "out"),
                               lambda: iter(samples), 10, "s")
    assert [os.path.basename(p) for p in paths] == \
        ["s-00000-of-00003", "s-00001-of-00003", "s-00002-of-00003"]
    for side in (jds, tds):
        got = list(side.common.read_converted(paths)())
        assert len(got) == len(samples)
        for (a, x), (b, y) in zip(got, samples):
            assert a == b and np.array_equal(np.asarray(x), y)


def test_stuck_infer_error_cleared(monkeypatch):
    monkeypatch.setattr(jnative, "_infer_lib", None)
    monkeypatch.setattr(jnative, "_infer_error", _stand_in())
    with pytest.raises(RuntimeError, match="failed earlier"):
        jnative.infer_lib_path()
    path = ensure_jax_infer()
    assert jnative._infer_error is None
    assert jnative.infer_lib_path() == path
    assert jnative.infer_lib() is not None


def test_loaded_library_keeps_its_state(monkeypatch):
    """With the library loaded, the helper leaves the module as it is."""
    ensure_jax_native()
    lib = jnative.lib()
    err = _stand_in()
    monkeypatch.setattr(jnative, "_build_error", err)
    ensure_jax_native()
    assert jnative._lib is lib and jnative._build_error is err
