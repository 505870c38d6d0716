"""The transformer LM of the port on a mesh against the JAX package:
the sequence-parallel loss and gradients, tensor-parallel parameters
laid out by `param_specs`, the Switch-MoE LM over an 'expert' axis, SGD
steps that keep every rank's parameters equal, and the GPipe pipeline.

One group of 4 gloo CPU ranks (one `spawn`) runs every mesh case, each
mesh holding a 'data' axis of 2 beside the axis under test (the data
axis replicates the computation, so each case also checks the rule that
seeds a rank's backward with 1 / ranks and sums over the mesh). The JAX
side runs jitted on a host mesh of the same axes. Loss at rtol 1e-5,
gradients at atol 2e-4 (tests/test_transformer_lm.py's bars).
"""

import types

import numpy as np
import pytest

import torch_mesh

CFG = dict(vocab=32, dim=32, heads=4, layers=2, max_len=64)
MOE = dict(CFG, moe_experts=4, moe_every=2, moe_capacity_factor=4.0)
# (case, mesh axes, config, attn_impl)
CASES = (("seq_ring", {"data": 2, "seq": 2}, CFG, "ring"),
         ("seq_flash", {"data": 2, "seq": 2}, CFG, "flash"),
         ("seq_zigzag", {"data": 2, "seq": 2}, CFG, "zigzag"),
         ("tp", {"data": 2, "model": 2}, CFG, "ring"),
         ("moe", {"data": 2, "expert": 2}, MOE, "ring"))
PIPE = dict(S=2, B=16, D=8, micro=4)


def _tokens(seed=0, b=2, t=16, vocab=32):
    rng = np.random.RandomState(seed)
    return rng.randint(0, vocab, (b, t + 1)).astype(np.int32)


def _jax_params(cfg):
    import jax

    from paddle_tpu.models import transformer as J

    jcfg = J.TransformerConfig(**cfg)
    return jcfg, jax.tree_util.tree_map(
        np.asarray, J.init_params(jcfg, jax.random.PRNGKey(0)))


def _pipe_inputs():
    rng = np.random.RandomState(3)
    S, B, D = PIPE["S"], PIPE["B"], PIPE["D"]
    return ({"w": (rng.randn(S, D, D) * 0.3).astype(np.float32),
             "b": (rng.randn(S, D) * 0.1).astype(np.float32)},
            rng.randn(B, D).astype(np.float32))


def _torch_stage(p, h):
    import torch

    return torch.tanh(h @ p["w"] + p["b"])


def _lm_rank(rank, world, params_np):
    import torch

    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.parallel import (collectives, gpipe_pipeline,
                                           make_mesh)

    torch.set_num_threads(2)
    out = {}
    toks = torch.as_tensor(_tokens())
    for name, axes, cfg, impl in CASES:
        mesh = make_mesh(axes, device="cpu")
        tcfg = T.TransformerConfig(**cfg)
        params = T.params_from_numpy(params_np[name], device="cpu")
        if name == "tp":
            params = T.shard_params(params, tcfg, mesh)
        loss, grads = T.loss_and_grads(params, toks, tcfg, mesh=mesh,
                                       attn_impl=impl)
        out[name] = (float(loss), [g.detach().numpy() for g in grads],
                     [tuple(p.shape) for p in T._leaves(params)])
        if name == "seq_ring":  # two SGD steps keep the ranks alike
            step = T.make_train_step(tcfg, lr=0.5, mesh=mesh)
            for _ in range(2):
                params, loss = step(params, toks)
            out["steps"] = (float(loss),
                            [p.detach().numpy() for p in T._leaves(params)])
    mesh = make_mesh({"data": 2, "pipe": 2}, device="cpu")
    sp, x = _pipe_inputs()
    sp = {k: torch.tensor(v, requires_grad=True) for k, v in sp.items()}
    x = torch.tensor(x, requires_grad=True)
    y = gpipe_pipeline(_torch_stage, sp, x, mesh,
                       n_microbatches=PIPE["micro"])
    g = torch.autograd.grad((y ** 2).sum(), [sp["b"], sp["w"], x],
                            grad_outputs=torch.tensor(1.0 / mesh.size))
    g = [collectives.all_reduce(t, mesh.group(("data", "pipe")))
         for t in g]
    out["pipe"] = (y.detach().numpy(), [t.numpy() for t in g])
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    params = {name: _jax_params(cfg)[1] for name, _, cfg, _ in CASES}
    return torch_mesh.spawn(_lm_rank, 4, tmp_path_factory.mktemp("lm"),
                            params)


def _jax_loss_and_grads(cfg, axes, impl):
    import jax

    from paddle_tpu import parallel
    from paddle_tpu.models import transformer as J

    jcfg, params = _jax_params(cfg)
    mesh = parallel.make_mesh(axes)
    if "model" in axes:
        from jax.sharding import NamedSharding

        params = jax.tree_util.tree_map(
            lambda p, s: jax.device_put(p, NamedSharding(mesh, s)),
            params, J.param_specs(jcfg, mesh),
            is_leaf=lambda x: isinstance(x, (np.ndarray,
                                             jax.sharding.PartitionSpec)))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: J.loss_fn(p, t, jcfg, mesh=mesh, attn_impl=impl)))(
        params, _tokens())
    return float(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(
        grads)]


def _unshard(rank_outs, name, axes):
    """Each leaf's gradient whole: the 'model' blocks of the ranks at
    data index 0 (row-major: ranks 0 and 1) concatenated where a leaf
    is split (its shape differs from rank 0's full one)."""
    grads = rank_outs[0][name][1]
    if "model" not in axes:
        return grads
    from paddle_tpu_torch.models import transformer as T

    tcfg = T.TransformerConfig(**CFG)
    full = T._leaves(T.param_shapes(tcfg))
    out = []
    for i, (g0, shape) in enumerate(zip(grads, full)):
        if tuple(g0.shape) == tuple(shape):
            out.append(g0)
            continue
        dim = [d for d in range(len(shape)) if g0.shape[d] != shape[d]][0]
        out.append(np.concatenate([rank_outs[r][name][1][i]
                                   for r in (0, 1)], axis=dim))
    return out


@pytest.mark.parametrize("name,axes,cfg,impl", CASES,
                         ids=[c[0] for c in CASES])
def test_mesh_loss_and_grads_match_jax_mesh(port, name, axes, cfg, impl):
    want_loss, want_g = _jax_loss_and_grads(
        cfg, axes, "ulysses" if impl == "flash" else impl)
    for r in port:  # the global loss on every rank
        np.testing.assert_allclose(r[name][0], want_loss, rtol=1e-5)
    got = _unshard(port, name, axes)
    assert len(got) == len(want_g)
    for a, b in zip(got, want_g):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-4)


def test_tp_ranks_hold_their_blocks(port):
    shapes = port[0]["tp"][2]
    from paddle_tpu_torch.models import transformer as T

    full = T._leaves(T.param_shapes(T.TransformerConfig(**CFG)))
    halved = [a for a, b in zip(shapes, full) if a != tuple(b)]
    # embed, and wq wk wv wo w1 w2 of each of the 2 layers
    assert len(halved) == 1 + 6 * CFG["layers"]
    embed = 10 * CFG["layers"]  # after the blocks' leaves (sorted keys)
    assert shapes[embed] == (CFG["vocab"] // 2, CFG["dim"])


def test_sgd_steps_on_the_mesh_keep_ranks_equal_to_one_device(port):
    import torch

    from paddle_tpu_torch.models import transformer as T

    torch.set_num_threads(2)
    tcfg = T.TransformerConfig(**CFG)
    params = T.params_from_numpy(_jax_params(CFG)[1], device="cpu")
    step = T.make_train_step(tcfg, lr=0.5)
    toks = torch.as_tensor(_tokens())
    for _ in range(2):
        params, loss = step(params, toks)
    for r in port:
        np.testing.assert_allclose(r["steps"][0], float(loss), rtol=1e-5)
        for a, b in zip(r["steps"][1], T._leaves(params)):
            np.testing.assert_allclose(a, b.detach().numpy(), atol=1e-4)
    for a, b in zip(port[0]["steps"][1], port[3]["steps"][1]):
        np.testing.assert_array_equal(a, b)


def test_gpipe_forward_and_grad_match_jax_mesh(port):
    import jax
    import jax.numpy as jnp

    from paddle_tpu import parallel

    sp, x = _pipe_inputs()
    mesh = parallel.make_mesh({"pipe": 2})

    def stage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def loss(p, x):
        y = parallel.gpipe_pipeline(stage, p, x, mesh,
                                    n_microbatches=PIPE["micro"])
        return jnp.sum(y ** 2), y

    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in sp.items()}, jnp.asarray(x))
    ref = parallel.reference_pipeline(stage, sp, jnp.asarray(x))
    got_y, got_g = port[0]["pipe"]
    np.testing.assert_array_equal(port[3]["pipe"][0], got_y)
    np.testing.assert_allclose(got_y, np.asarray(y), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_y, np.asarray(ref), rtol=1e-5, atol=1e-6)
    for a, b in zip(got_g, [gp["b"], gp["w"], gx]):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-4)


def test_gpipe_shape_errors_match_jax():
    import jax.numpy as jnp
    import torch

    from paddle_tpu import parallel as jpar
    from paddle_tpu_torch import parallel as tpar

    sp, x = _pipe_inputs()
    stub = types.SimpleNamespace(axis_names=("pipe",), shape={"pipe": 4})
    jmesh = jpar.make_mesh({"pipe": 4})
    for bad_x, what in ((x, "leading dim must equal"),
                        (x[:15], "must divide into")):
        if what.startswith("must"):
            stub.shape["pipe"] = 2
            jmesh = jpar.make_mesh({"pipe": 2})
        with pytest.raises(ValueError, match=what) as jerr:
            jpar.gpipe_pipeline(lambda p, h: h,
                                {k: jnp.asarray(v) for k, v in sp.items()},
                                jnp.asarray(bad_x), jmesh, n_microbatches=4)
        with pytest.raises(ValueError, match=what) as terr:
            tpar.gpipe_pipeline(lambda p, h: h,
                                {k: torch.tensor(v) for k, v in sp.items()},
                                torch.tensor(bad_x), stub, n_microbatches=4)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("cfg", [CFG, MOE], ids=["dense", "moe"])
@pytest.mark.parametrize("axes", [None, ("data", "model"),
                                  ("data", "seq", "expert")])
def test_param_specs_match_jax(cfg, axes):
    from paddle_tpu import parallel
    from paddle_tpu.models import transformer as J
    from paddle_tpu_torch.models import transformer as T

    jmesh = tmesh = None
    if axes:
        jmesh = parallel.make_mesh({a: 2 for a in axes})
        tmesh = types.SimpleNamespace(axis_names=axes)
    want = J.param_specs(J.TransformerConfig(**cfg), jmesh)
    got = T.param_specs(T.TransformerConfig(**cfg), tmesh)

    def norm(t):
        if isinstance(t, dict):
            return {k: norm(v) for k, v in t.items()}
        if isinstance(t, list):
            return [norm(v) for v in t]
        return tuple(t)

    assert norm(got) == norm(want)


def test_moe_params_leaf_order_is_jax_tree_util():
    """An MoE block's leaves in jax.tree_util's order (ln1, ln2, moe
    {b1, b2, gate_w, w1, w2}, wk, wo, wq, wv): `_leaves` and
    `params_from_numpy` carry the tree leaf for leaf."""
    import jax

    from paddle_tpu_torch.models import transformer as T

    jcfg, params = _jax_params(MOE)
    assert "moe" in params["blocks"][1] and "w1" in params["blocks"][0]
    tp = T.params_from_numpy(params, device="cpu")
    jl = jax.tree_util.tree_leaves(params)
    tl = T._leaves(tp)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b.numpy())
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(params["blocks"][1])[0]]
    assert paths[4:9] == ["['moe']['b1']", "['moe']['b2']",
                          "['moe']['gate_w']", "['moe']['w1']",
                          "['moe']['w2']"]
    tshapes = [tuple(t.shape) for t in T._leaves(T.init_params(
        T.TransformerConfig(**MOE), __import__("torch").Generator(),
        device="cpu"))]
    assert tshapes == [a.shape for a in jl]


def test_tree_walks_follow_jax_tree_util():
    """One rule for the port's walkers, jax.tree_util's: dicts (keys
    sorted), lists and tuples are containers, a PartitionSpec or a
    torch.Size a leaf."""
    import jax
    import torch

    from paddle_tpu_torch.parallel.mesh import PartitionSpec
    from paddle_tpu_torch.utils import tree

    t = {"b": (1, [2, 3]), "a": {"z": 4, "y": (5,)}}
    assert tree.leaves(t) == jax.tree_util.tree_leaves(t) == [5, 4, 1, 2, 3]
    assert tree.tree_map(lambda x: x * 10, t) == jax.tree_util.tree_map(
        lambda x: x * 10, t)
    assert tree.rebuild(t, iter("vwxyz")) == jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(t), list("vwxyz"))
    spec, shape = PartitionSpec("model", None), torch.Size((2, 3))
    assert tree.leaves({"w": spec, "s": [shape]}) == [shape, spec]
