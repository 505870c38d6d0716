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
