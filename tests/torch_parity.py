"""Shared fixtures of the port's serving parity tests: JAX weights carried
into the port, one fixed request trace, and a loop that records what
the two engines are compared on."""

import numpy as np
import torch

import jax

from paddle_tpu.models import transformer as J
from paddle_tpu_torch.models import transformer as T

DIMS = dict(vocab=50, dim=32, heads=4, layers=2, max_len=64)


def models(seed, **dims):
    """(JAX config, JAX params, port config, port params on the CPU) from
    one JAX init."""
    d = dict(DIMS, **dims)
    jcfg = J.TransformerConfig(**d)
    jp = J.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    return jcfg, jp, T.TransformerConfig(**d), tp


def trace(seed, vocab=DIMS["vocab"], header_len=16):
    """Six requests behind a shared header (publish boundary = header),
    alternating greedy and sampled, two of them repeating header text,
    with budgets long enough for a self-drafting engine's drafts to be
    accepted."""
    rng = np.random.RandomState(seed)
    header = rng.randint(0, vocab, header_len).astype(np.int32)
    reqs = []
    for i, (tail, n) in enumerate([(3, 12), (9, 16), (5, 14), (12, 10),
                                   (1, 16), (6, 12)]):
        suffix = rng.randint(0, vocab, tail).astype(np.int32)
        if i in (1, 3):  # the header's own text again: drafts to accept
            suffix = np.concatenate([suffix, header[:4]])
        reqs.append(dict(prompt=np.concatenate([header, suffix]),
                         max_new_tokens=n,
                         temperature=0.8 if i % 2 else 0.0, seed=100 + i,
                         publish_len=header_len))
    return reqs


def drive(eng, reqs, cow_prompt):
    """Submit the trace, step to the end recording (queue depth, live
    slots, prefilling slots, blocks in use) after every step, then serve
    a whole-block prompt twice (its resubmit copies its last block on
    write). Returns ([(sequence, finish reason)], trajectory)."""
    handles = [eng.submit(**r) for r in reqs]
    traj = []
    while eng.step():
        traj.append((eng.queue_depth, eng.live_slots, eng.prefilling_slots,
                     eng.kv_blocks_in_use))
    for _ in range(2):
        handles.append(eng.submit(cow_prompt, 4))
        eng.run()
    out = [(list(h.full_prompt) + [int(t) for t in h.tokens],
            h.finish_reason) for h in handles]
    return out, traj


def tokens_of(eng, reqs):
    """Greedy/sampled tokens of `reqs` served to completion."""
    hs = [eng.submit(**r) for r in reqs]
    eng.run()
    return [list(map(int, h.tokens)) for h in hs]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- Fluid: one program built by each package's fluid API ----------------

import paddle_tpu.fluid as JF  # noqa: E402
import paddle_tpu_torch.fluid as TF  # noqa: E402
from paddle_tpu.models import resnet as JR  # noqa: E402
from paddle_tpu_torch.models import resnet as TR  # noqa: E402


class FluidPair(object):
    """`build(fluid, resnet)` run once with each package's fluid (and
    resnet module) under fresh programs; it returns a dict of Variables,
    and may return a for_test clone under the key "test_program". The
    JAX startup program runs on the CPU, and its scope is carried into a
    port scope on the CPU (`scope_from_numpy`), so both sides train from
    the same weights whatever either RNG does. Variables of the two
    programs pair up by position (the builders are the same code), so
    `names` maps a JAX name to the port's."""

    def __init__(self, build, amp=False):
        sides = {}
        for side, fluid, resnet in (("jax", JF, JR), ("torch", TF, TR)):
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                out = build(fluid, resnet)
            main.amp = amp
            sides[side] = (main, startup, out)
        (self.jmain, self.jstartup, self.jvars) = sides["jax"]
        (self.tmain, self.tstartup, self.tvars) = sides["torch"]
        jv = list(self.jmain.global_block().vars.values())
        tv = list(self.tmain.global_block().vars.values())
        assert [(v.shape, v.dtype, v.persistable) for v in jv] == \
            [(v.shape, v.dtype, v.persistable) for v in tv]
        self.names = {a.name: b.name for a, b in zip(jv, tv)}
        self.jscope, self.tscope = JF.Scope(), TF.Scope()
        with JF.scope_guard(self.jscope):
            self.jexe = JF.Executor(JF.CPUPlace())
            self.jexe.run(self.jstartup)
        self.texe = TF.Executor(TF.CPUPlace())
        TF.scope_from_numpy(self.tscope, self.jax_state(), "cpu")

    def jax_state(self):
        """The JAX scope as numpy, under the port's names."""
        return {self.names[n]: np.asarray(self.jscope.get(n))
                for n in self.jscope.keys()}

    def run(self, feed, fetch, test=False):
        """One executor run of the main program (or the for_test clone)
        on each side: fetch names are keys of the build's dict."""
        jprog = self.jvars["test_program"] if test else self.jmain
        tprog = self.tvars["test_program"] if test else self.tmain
        with JF.scope_guard(self.jscope):
            j = self.jexe.run(jprog, feed=feed,
                              fetch_list=[self.jvars[k] for k in fetch])
        with TF.scope_guard(self.tscope):
            t = self.texe.run(tprog, feed=feed,
                              fetch_list=[self.tvars[k] for k in fetch])
        return [np.asarray(a, np.float32) for a in j], \
            [np.asarray(b, np.float32) for b in t]

    def state_diff(self):
        """{port name: max |JAX - port|} over every persistable."""
        port = TF.scope_to_numpy(self.tscope)
        return {n: float(np.abs(a.astype(np.float32)
                                - port[n].astype(np.float32)).max())
                for n, a in self.jax_state().items()}

    def model_state_names(self):
        """The port's names of the model's state: its Parameters and the
        batch-norm running statistics (the rest of the scope is
        optimizer state)."""
        block = self.tmain.global_block()
        names = {p.name for p in block.all_parameters()}
        for op in block.ops:
            if op.type == "batch_norm":
                names |= set(op.input("Mean") + op.input("Variance"))
        return names
