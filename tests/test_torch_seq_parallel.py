"""Sequence-parallel attention of the port (paddle_tpu_torch.parallel.
attention) against the JAX package's on host meshes of the same size:
ring, zigzag and Ulysses, causal and not, over seq axes of 2 and 4 gloo
CPU ranks.

Every case runs in one group of 4 ranks (one `spawn`); the JAX side
runs jitted on a seq mesh of as many CPU devices as the port's axis. Forward at
rtol 1e-5; gradients of sum(out ** 2) with respect to q, k and v (each
rank seeds its backward with 1 / ranks and the ranks' gradients are
summed, the mesh's rule) at atol 2e-4. Every rank must return the same
output.
"""

import types

import numpy as np
import pytest

import torch_mesh

B, T, H, D = 2, 16, 4, 8
SEQ = (2, 4)
# (impl, causal); "flash" on a mesh is Ulysses with the flash kernels'
# plain version per rank, held against the JAX package's Ulysses
CASES = (("ring", False), ("ring", True), ("zigzag", True),
         ("ulysses", False), ("ulysses", True), ("flash", True))


def _qkv():
    rng = np.random.RandomState(0)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


def _seq_rank(rank, world, cases):
    """Both seq extents from one group of 4 ranks: {'data': 2, 'seq': 2}
    holds two seq rings of 2 (the data axis replicates), {'seq': 4} one
    of 4. Each rank seeds 1 / (mesh ranks) and sums over the mesh."""
    import torch

    from paddle_tpu_torch.parallel import (collectives, make_mesh,
                                           sequence_parallel_attention)

    torch.set_num_threads(2)
    out = {}
    for n in SEQ:
        mesh = make_mesh({"data": world // n, "seq": n}, device="cpu")
        group = mesh.group(mesh.axis_names)
        for impl, causal in cases:
            q, k, v = (torch.tensor(a, requires_grad=True) for a in _qkv())
            o = sequence_parallel_attention(q, k, v, mesh=mesh, impl=impl,
                                            causal=causal)
            grads = torch.autograd.grad(
                (o ** 2).sum(), (q, k, v),
                grad_outputs=torch.tensor(1.0 / mesh.size))
            grads = [collectives.all_reduce(g, group) for g in grads]
            out[(n, impl, causal)] = (o.detach().numpy(),
                                      [g.numpy() for g in grads])
        out[(n, "exchanges")] = mesh.sync_stats.exchanges
    return out


def _jax_case(world, impl, causal):
    import jax
    import jax.numpy as jnp

    from paddle_tpu import parallel

    mesh = parallel.make_mesh({"seq": world})
    impl = "ulysses" if impl == "flash" else impl

    def attn(q, k, v):
        return parallel.sequence_parallel_attention(
            q, k, v, mesh=mesh, impl=impl, causal=causal)

    def loss(q, k, v):
        o = attn(q, k, v)
        return jnp.sum(o ** 2), o

    q, k, v = (jnp.asarray(a) for a in _qkv())
    (_, o), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                           has_aux=True))(q, k, v)
    return np.asarray(o), [np.asarray(x) for x in g]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return torch_mesh.spawn(_seq_rank, 4, tmp_path_factory.mktemp("seq"),
                            CASES)


@pytest.mark.parametrize("world", SEQ)
@pytest.mark.parametrize("impl,causal", CASES)
def test_seq_parallel_attention_matches_jax_mesh(port, world, impl, causal):
    want_o, want_g = _jax_case(world, impl, causal)
    key = (world, impl, causal)
    for r in port:  # every rank holds the gathered output
        np.testing.assert_array_equal(r[key][0], port[0][key][0])
    got_o, got_g = port[0][key]
    np.testing.assert_allclose(got_o, want_o, rtol=1e-5, atol=1e-6)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, atol=2e-4)


@pytest.mark.parametrize("world", SEQ)
def test_exchanges_count_in_the_mesh_stats(port, world):
    # a ring case rotates K/V n - 1 times forward and n - 1 times back;
    # a Ulysses case exchanges q, k, v and the output, forward and back
    ring = 2 * (world - 1)
    assert port[0][(world, "exchanges")] == 3 * ring + 3 * 8


@pytest.mark.parametrize("T_global,n", [(16, 2), (16, 8), (32, 4)])
def test_zigzag_permutation_matches_jax(T_global, n):
    from paddle_tpu import parallel as jpar
    from paddle_tpu_torch import parallel as tpar

    for a, b in zip(tpar.zigzag_permutation(T_global, n),
                    jpar.zigzag_permutation(T_global, n)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("impl,causal,shape,what", [
    ("zigzag", False, (B, T, H, D), "causal-only"),
    ("zigzag", True, (B, 10, H, D), "divisible by 2\\*axis"),
    ("ring", True, (B, 15, H, D), "not divisible by mesh axis"),
    ("ulysses", False, (B, T, 3, D), "heads divisible"),
])
def test_validation_errors_match_jax(impl, causal, shape, what):
    """The port raises where the JAX package raises, with its message,
    before any collective (a mesh stand-in with the axis suffices)."""
    import jax.numpy as jnp
    import torch

    from paddle_tpu import parallel as jpar
    from paddle_tpu_torch import parallel as tpar

    n = 2
    stub = types.SimpleNamespace(axis_names=("seq",), shape={"seq": n})
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=what) as jerr:
        jpar.sequence_parallel_attention(
            *(jnp.asarray(x),) * 3, mesh=jpar.make_mesh({"seq": n}),
            impl=impl, causal=causal)
    with pytest.raises(ValueError, match=what) as terr:
        tpar.sequence_parallel_attention(*(torch.tensor(x),) * 3,
                                         mesh=stub, impl=impl, causal=causal)
    assert str(terr.value) == str(jerr.value)
    # the zigzag causal check precedes the no-mesh branch in both
    if impl == "zigzag" and not causal:
        with pytest.raises(ValueError, match=what):
            tpar.sequence_parallel_attention(*(torch.tensor(x),) * 3,
                                             impl=impl, causal=causal)
