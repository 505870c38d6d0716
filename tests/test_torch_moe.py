"""The Switch-MoE layer of the port (paddle_tpu_torch.parallel.moe)
against the JAX package's: `reference_moe` on one device, and
`expert_parallel_moe` on an 'expert' axis of 2 gloo CPU ranks (one
`spawn` for every case) against the JAX package on a 2-device host mesh,
with ample capacity and with drops, in f32: outputs at rtol 1e-5,
gradients at atol 2e-4, the drop masks equal. Also the indivisible
errors and the integer slot positions (the JAX package counts them in
the activation dtype, exact in bf16 only up to 256).
"""

import types

import numpy as np
import pytest

import torch_mesh

N, D, HID, E = 32, 8, 16, 4
# (name, capacity): ample (N: nothing dropped) and 2 slots per rank and
# expert (16 tokens a rank over 4 experts: some are dropped)
CAPS = (("ample", N), ("drops", 2))


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(N, D).astype(np.float32),
            (rng.randn(D, E) * 0.5).astype(np.float32),
            (rng.randn(E, D, HID) * 0.3).astype(np.float32),
            (rng.randn(E, HID) * 0.1).astype(np.float32),
            (rng.randn(E, HID, D) * 0.3).astype(np.float32),
            (rng.randn(E, D) * 0.1).astype(np.float32)]


def _moe_rank(rank, world):
    import torch

    from paddle_tpu_torch.parallel import (collectives, expert_parallel_moe,
                                           make_mesh)

    torch.set_num_threads(2)
    mesh = make_mesh({"expert": world}, device="cpu")
    out = {}
    for name, cap in CAPS:
        args = [torch.tensor(a, requires_grad=True) for a in _inputs()]
        dropped = int(mesh.sync_stats.dropped_tokens)
        y, keep = expert_parallel_moe(*args, mesh=mesh, capacity=cap,
                                      return_keep=True)
        out[name + "_dropped"] = (int(mesh.sync_stats.dropped_tokens)
                                  - dropped)
        grads = torch.autograd.grad((y ** 2).sum(), args,
                                    grad_outputs=torch.tensor(1.0 / world))
        grads = [collectives.all_reduce(g, mesh.group("expert"))
                 for g in grads]
        out[name] = (y.detach().numpy(), keep.numpy(),
                     [g.numpy() for g in grads])
    out["exchanges"] = mesh.sync_stats.exchanges
    return out


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return torch_mesh.spawn(_moe_rank, 2, tmp_path_factory.mktemp("moe"))


def _jax_moe(cap):
    import jax
    import jax.numpy as jnp

    from paddle_tpu import parallel

    mesh = parallel.make_mesh({"expert": 2})
    args = [jnp.asarray(a) for a in _inputs()]

    def loss(*a):
        y = parallel.expert_parallel_moe(*a, mesh=mesh, capacity=cap)
        return jnp.sum(y ** 2), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(6)),
                                           has_aux=True))(*args)
    return np.asarray(y), [np.asarray(x) for x in g]


@pytest.mark.parametrize("name,cap", CAPS)
def test_expert_parallel_moe_matches_jax_mesh(port, name, cap):
    want_y, want_g = _jax_moe(cap)
    got_y, keep, got_g = port[0][name]
    np.testing.assert_array_equal(port[1][name][0], got_y)
    np.testing.assert_allclose(got_y, want_y, rtol=1e-5, atol=1e-6)
    # the JAX package zeroes a dropped token's row: its drop mask
    np.testing.assert_array_equal(keep, np.abs(want_y).sum(1) > 0)
    assert keep.all() if name == "ample" else not keep.all()
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, atol=2e-4)


def test_expert_parallel_with_ample_capacity_is_reference_moe(port):
    import torch

    from paddle_tpu_torch.parallel import reference_moe

    ref = reference_moe(*(torch.tensor(a) for a in _inputs()))
    np.testing.assert_allclose(port[0]["ample"][0], ref.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_exchanges_count_in_the_mesh_stats(port):
    # dispatch and return, forward and backward, in each of two runs
    assert port[0]["exchanges"] == 2 * 4


@pytest.mark.parametrize("name", [c[0] for c in CAPS])
def test_each_rank_counts_its_dropped_tokens(port, name):
    keep = port[0][name][1]
    half = N // 2
    assert [r[name + "_dropped"] for r in port] == [
        int((~keep[:half]).sum()), int((~keep[half:]).sum())]


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_moe_matches_jax(seed):
    import jax
    import jax.numpy as jnp
    import torch

    from paddle_tpu import parallel as jpar
    from paddle_tpu_torch import parallel as tpar

    torch.set_num_threads(2)
    ins = _inputs(seed)
    want, jg = jax.value_and_grad(
        lambda *a: jnp.sum(jpar.reference_moe(*a) ** 2),
        argnums=tuple(range(6)))(*(jnp.asarray(a) for a in ins))
    args = [torch.tensor(a, requires_grad=True) for a in ins]
    y = tpar.reference_moe(*args)
    tg = torch.autograd.grad((y ** 2).sum(), args)
    np.testing.assert_allclose(float((y ** 2).sum().detach()), float(want),
                               rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)


def test_moe_capacity_matches_jax():
    from paddle_tpu import parallel as jpar
    from paddle_tpu_torch import parallel as tpar

    for args in ((4096, 8, 1.25), (16, 4, 1.0), (1, 64, 1.25), (100, 3, 2.0)):
        assert tpar.moe_capacity(*args) == jpar.moe_capacity(*args)


@pytest.mark.parametrize("shape,what", [((N, D), "n_experts 3 must divide"),
                                        ((31, D), "token count 31 must")])
def test_indivisible_errors_match_jax(shape, what):
    """Raised before any collective, as in the JAX package (a mesh
    stand-in with the axis suffices for the port)."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu import parallel as jpar
    from paddle_tpu_torch import parallel as tpar

    e = 3 if "experts" in what else E
    x = np.zeros(shape, np.float32)
    ws = [np.zeros(s, np.float32) for s in
          ((D, e), (e, D, HID), (e, HID), (e, HID, D), (e, D))]
    with pytest.raises(ValueError, match=what) as jerr:
        jpar.expert_parallel_moe(jnp.asarray(x), *map(jnp.asarray, ws),
                                 mesh=jpar.make_mesh({"expert": 2}))
    stub = types.SimpleNamespace(axis_names=("expert",), shape={"expert": 2})
    with pytest.raises(ValueError, match=what) as terr:
        tpar.expert_parallel_moe(torch.tensor(x), *map(torch.tensor, ws),
                                 mesh=stub)
    assert str(terr.value) == str(jerr.value)


def test_slot_positions_are_integers_where_bf16_collides():
    """600 tokens routed to one expert with capacity 640 (the full-width
    shape: 4,096 tokens a rank over 8 experts at factor 1.25): the
    port's positions are 0..599, every slot distinct. The JAX package
    counts positions as a bf16 cumulative sum, which reads 352 at row
    351, so its bf16 tokens share slots (ROADMAP Queue C)."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu_torch.parallel.moe import moe_capacity, moe_route

    cap = moe_capacity(4096, 8, 1.25)
    assert cap == 640
    expert = torch.zeros(600, dtype=torch.long)
    slot, keep = moe_route(expert, 8, cap)
    assert keep.all() and torch.equal(slot, torch.arange(600))
    jpos = np.asarray(jnp.cumsum(jnp.ones(600, jnp.bfloat16)) - 1.0,
                      np.float32)
    assert jpos[351] != 351 and len(np.unique(jpos)) < 600
