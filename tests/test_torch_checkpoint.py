"""The port's durable checkpoints (paddle_tpu_torch.distributed.checkpoint)
in the JAX package's on-disk format: the same scope saved by either
package gives the same files, byte for byte; either package loads the
other's; a sharded save on two gloo ranks (each writing the blocks it
owns) loads whole on one rank, in both packages; the async save
snapshots before it returns; a corrupt step is walked back past.

The JAX package is imported inside the tests: the spawned ranks import
this module."""

import os

import numpy as np
import pytest
import torch

from torch_mesh import spawn

from paddle_tpu_torch import fluid as TF
from paddle_tpu_torch.distributed import (load_checkpoint, resume_or_init,
                                          save_checkpoint,
                                          save_checkpoint_async,
                                          verify_checkpoint)
from paddle_tpu_torch.distributed.fault_injection import corrupt_file


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc_0.w_0": rng.randn(6, 4).astype(np.float32),
            "fc_0.b_0": rng.randn(4).astype(np.float32),
            "bn/moving_mean": rng.randn(3).astype(np.float32),
            "step": np.array([7], np.int32)}


def _files(path):
    out = {}
    for dirpath, _dirs, files in os.walk(path):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = fh.read()
    return out


class _JaxScope(object):
    def __init__(self, arrays):
        import jax.numpy as jnp

        self._a = {k: jnp.asarray(v) for k, v in arrays.items()}

    def keys(self):
        return self._a.keys()

    def get(self, k):
        return self._a[k]


def test_same_scope_same_files_as_the_jax_package(tmp_path):
    from paddle_tpu.distributed import checkpoint as jck

    arrays = _arrays()
    scope = TF.scope_from_numpy(TF.Scope(), arrays, "cpu")
    save_checkpoint(scope, str(tmp_path / "t"), step=3,
                    extra={"note": "x"})
    jck.save_checkpoint(_JaxScope(arrays), str(tmp_path / "j"), step=3,
                        extra={"note": "x"})
    t, j = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(t) == sorted(j) and len(t) == len(arrays) + 1
    for name in j:
        assert t[name] == j[name], name


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_loads_the_others_checkpoint(writer, tmp_path):
    from paddle_tpu.distributed import checkpoint as jck
    import paddle_tpu.fluid as JF

    arrays = _arrays(1)
    if writer == "jax":
        jck.save_checkpoint(_JaxScope(arrays), str(tmp_path), step=5)
    else:
        save_checkpoint(TF.scope_from_numpy(TF.Scope(), arrays, "cpu"),
                        str(tmp_path), step=5)
    tscope, jscope = TF.Scope(), JF.Scope()
    tmeta = load_checkpoint(tscope, str(tmp_path))
    jmeta = jck.load_checkpoint(jscope, str(tmp_path))
    assert tmeta["step"] == jmeta["step"] == 5
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(tscope.get(k)), v)
        np.testing.assert_array_equal(np.asarray(jscope.get(k)), v)
    assert [r["ok"] for r in verify_checkpoint(str(tmp_path))] == [True]
    assert [r["ok"] for r in jck.verify_checkpoint(str(tmp_path))] == [True]


def test_async_save_snapshots_before_returning(tmp_path):
    arrays = _arrays(2)
    scope = TF.scope_from_numpy(TF.Scope(), arrays, "cpu")
    handle = save_checkpoint_async(scope, str(tmp_path), step=1)
    # the optimizer updates the scope's tensors in place: the save must
    # hold the values of the moment it was asked for
    scope.get("fc_0.w_0").add_(100.0)
    assert handle.result(timeout=60).endswith("step_0000000001")
    back = TF.Scope()
    load_checkpoint(back, str(tmp_path))
    np.testing.assert_array_equal(back.get("fc_0.w_0"), arrays["fc_0.w_0"])


def test_corrupt_newest_step_is_walked_back(tmp_path):
    arrays = _arrays(3)
    scope = TF.scope_from_numpy(TF.Scope(), arrays, "cpu")
    save_checkpoint(scope, str(tmp_path), step=1, keep_last=3)
    scope.get("fc_0.w_0").mul_(2.0)
    save_checkpoint(scope, str(tmp_path), step=2, keep_last=3)
    newest = os.path.join(str(tmp_path), "step_%010d" % 2)
    corrupt_file(os.path.join(newest, "fc_0.w_0.p0.npy"))
    back = TF.Scope()
    meta = resume_or_init(back, str(tmp_path))
    assert meta["step"] == 1
    assert "CRC" in meta["fallbacks"][0]["problems"][0]
    assert os.path.isdir(newest + ".corrupt")
    np.testing.assert_array_equal(back.get("fc_0.w_0"), arrays["fc_0.w_0"])


def _sharded_save(rank, world, out_dir):
    """Rank part of a data-parallel FSDP program on a mesh of two gloo
    ranks: train a step, save (each rank its blocks), and return the
    whole values (a gather, on every rank)."""
    from paddle_tpu_torch import parallel

    fluid = TF
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=16, act="tanh",
                            param_attr=fluid.ParamAttr(name="ck_w1"))
        pred = fluid.layers.fc(input=h, size=1,
                               param_attr=fluid.ParamAttr(name="ck_w2"))
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        main = fluid.default_main_program()
        mesh = parallel.make_mesh({"data": world}, device="cpu")
        sharded = parallel.shard_parameters_fsdp(main, mesh, min_size=64)
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
        exe = fluid.Executor(mesh=mesh)
        exe.run(fluid.default_startup_program())
        rng = np.random.RandomState(rank)
        exe.run(feed={"x": rng.randn(4, 8).astype(np.float32),
                      "y": rng.randn(4, 1).astype(np.float32)},
                fetch_list=[loss])
        scope = fluid.global_scope()
        blocks = {k: tuple(scope.get(k).shape) for k in scope.keys()
                  if scope.get(k) is not None}
        save_checkpoint(scope, out_dir, step=1)
        whole = TF.scope_to_numpy(scope)
    return dict(sharded=sharded, blocks=blocks, whole=whole)


def test_sharded_save_on_two_ranks_loads_on_one(tmp_path):
    from paddle_tpu.distributed import checkpoint as jck
    import paddle_tpu.fluid as JF

    out = str(tmp_path / "ckpt")
    ranks = spawn(_sharded_save, 2, tmp_path, out, timeout=120)
    r0 = ranks[0]
    assert "ck_w1" in r0["sharded"]
    # each rank held half of the sharded weight
    assert int(np.prod(r0["blocks"]["ck_w1"])) == 8 * 16 // 2
    assert r0["whole"]["ck_w1"].shape == (8, 16)
    for r in ranks[1:]:
        assert r["whole"].keys() == r0["whole"].keys()
    step = os.path.join(out, "step_%010d" % 1)
    metas = sorted(f for f in os.listdir(step) if f.endswith(".json"))
    assert metas == ["checkpoint.meta.p0.json", "checkpoint.meta.p1.json"]
    assert os.path.exists(os.path.join(step, "ck_w1.p1.s0.npy"))
    tscope, jscope = TF.Scope(), JF.Scope()
    load_checkpoint(tscope, out)
    jck.load_checkpoint(jscope, out)
    assert sorted(tscope.keys()) == sorted(r0["whole"])
    for k, v in r0["whole"].items():
        np.testing.assert_array_equal(np.asarray(tscope.get(k)), v,
                                      err_msg=k)
        np.testing.assert_array_equal(np.asarray(jscope.get(k)), v,
                                      err_msg=k)
    assert torch.is_tensor(torch.as_tensor(tscope.get("ck_w1")))
