"""The port's tenancy (paddle_tpu_torch.serving.tenancy) against the JAX
package's: on one seeded sequence of submissions with an injected clock,
the token buckets give the same verdicts (admit, or shed with the same
retry-after) and the weighted fair queue pops the same order. The batch
lane's `executor_batch_fn` runs a port Fluid program through its
executor, inside and outside a scope. Exact: no tolerance."""

import numpy as np
import pytest

from paddle_tpu.serving import tenancy as jt
from paddle_tpu_torch.serving import tenancy as tt

SIDES = {"jax": jt, "torch": tt}


def _registry(mod):
    reg = mod.TenantRegistry()
    reg.add("alice", rate=5.0, burst=3.0, weight=3.0)
    reg.add("bob", rate=2.0, burst=1.0, weight=1.0, slo="batch")
    reg.add("carol", rate=50.0, burst=20.0, weight=0.5, adapter="ad_c")
    return reg


def _bucket_verdicts(mod, seed):
    """Feed a seeded arrival sequence through admit() with an injected
    clock: (tenant, cost, verdict, retry_after) per submission, then the
    registry's snapshot."""
    rng = np.random.RandomState(seed)
    reg = _registry(mod)
    now, out = 100.0, []
    for _ in range(300):
        now += float(rng.exponential(0.08))
        name = ("alice", "bob", "carol")[int(rng.randint(3))]
        cost = float(rng.choice([1.0, 1.0, 2.0, 0.5]))
        try:
            reg.admit(name, cost=cost, now=now)
            out.append((name, cost, "ok", None))
        except mod.TenantQuotaExceeded as e:
            out.append((name, cost, "shed", e.retry_after_s))
            assert e.tenant == name
        if rng.rand() < 0.3:
            reg.on_complete(name, int(rng.randint(1, 9)),
                            queue_wait_s=float(rng.rand()),
                            batch=bool(rng.rand() < 0.2))
        if rng.rand() < 0.05:
            reg.on_expire(name)
        if rng.rand() < 0.05:
            reg.on_reject(name)
    return out, reg.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_bucket_verdicts_match(seed):
    j_out, j_snap = _bucket_verdicts(jt, seed)
    t_out, t_snap = _bucket_verdicts(tt, seed)
    assert t_out == j_out
    assert t_snap == j_snap
    verdicts = {v for _n, _c, v, _r in t_out}
    assert verdicts == {"ok", "shed"}  # the sequence exercises both


def _wfq_order(mod, seed):
    """Interleave seeded pushes and pops; return the popped labels and
    the entries left."""
    rng = np.random.RandomState(seed)
    weights = {"alice": 3.0, "bob": 1.0, "carol": 0.5}
    q = mod.WFQueue()
    popped, k = [], 0
    for _ in range(400):
        if rng.rand() < 0.6 or not q:
            name = ("alice", "bob", "carol")[int(rng.randint(3))]
            cost = float(rng.randint(1, 64))
            q.push(name, weights[name], cost, (name, k))
            k += 1
        else:
            popped.append(q.pop())
    left = sorted(q.entries())
    while q:
        popped.append(q.pop())
    return popped, left


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wfq_pop_order_matches(seed):
    j_pop, j_left = _wfq_order(jt, seed)
    t_pop, t_left = _wfq_order(tt, seed)
    assert t_pop == j_pop and t_left == j_left
    assert len(t_pop) > 100


def test_wfq_shares_follow_weights():
    """Under constant backlog the pops split by weight (3:1 in tokens):
    the port's queue serves alice three tokens for each of bob's."""
    q = tt.WFQueue()
    for i in range(300):
        q.push("alice", 3.0, 8.0, ("alice", i))
        q.push("bob", 1.0, 8.0, ("bob", i))
    first = [q.pop()[0] for _ in range(200)]
    assert first.count("alice") == 150 and first.count("bob") == 50


def test_registry_errors_match():
    for mod in SIDES.values():
        reg = _registry(mod)
        with pytest.raises(ValueError):
            reg.add("alice")
        with pytest.raises(KeyError):
            reg.get("nobody")
        for bad in (dict(rate=0.0), dict(burst=0.5), dict(weight=0.0)):
            with pytest.raises(ValueError):
                reg.add("x", **bad)
        assert reg.names() == ["alice", "bob", "carol"]
        assert reg.has("bob") and not reg.has("x")


def test_executor_batch_fn_runs_a_port_program():
    """The batch lane's job: one Executor.run of a port Fluid program on
    the CPU, in the executor's default scope and in a given one."""
    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.fc(input=x, size=3)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
    feed = {"x": np.arange(8, dtype=np.float32).reshape(2, 4)}
    with fluid.scope_guard(scope):
        (want,) = exe.run(main, feed=feed, fetch_list=[y])
    (got,) = tt.executor_batch_fn(exe, main, feed, [y], scope=scope)()
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with fluid.scope_guard(scope):
        (again,) = tt.executor_batch_fn(exe, main, feed, [y])()
    np.testing.assert_array_equal(np.asarray(again), np.asarray(want))
