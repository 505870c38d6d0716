"""Numerics shared by the port's attention kernels and their plain
versions (counterpart of paddle_tpu/parallel/kernel_utils.py).

`NEG_INF` is the finite mask fill the softmax guards compare against
EXACTLY: a masked score must contribute exactly 0 and a fully-masked
tile must leave a running (max, sum, acc) state unchanged, so the
guards test `s <= NEG_INF` and `m_prev <= NEG_INF` instead of relying
on `exp(-inf)`. The CUDA kernels (csrc/paged_attention.cu,
csrc/flash_attention.cu) hard-code the same value, the same two guards
and `causal_fill`'s mask.
"""

from __future__ import annotations

import functools
import threading

import torch

__all__ = ["NEG_INF", "guarded_exp", "causal_fill", "on_cpu", "raw_bytes",
           "bind_once", "count_launch"]

# Finite -inf stand-in for score masking. Finite on purpose: the
# online-softmax no-op guards (`p = where(s <= NEG_INF, 0, p)`,
# `alpha = where(m_prev <= NEG_INF, 0, alpha)`) need exact comparisons,
# and exp(-1e30 - m) underflows to exactly 0.0 for any finite m.
NEG_INF = -1e30


# The first torch.exp of a process can race on the CPU: when it is wide
# enough to split over OpenMP threads, one thread's share can come back
# ~1e-4 off (the exp's lazy first-call set-up run by two threads at
# once); every later exp is right. So the plain versions' exp is set up
# here, in one thread, before any of them runs
# (tests/test_torch_cpu_exp_race.py measures both).
torch.exp(torch.zeros(1))


def guarded_exp(x, m):
    """exp(x - m) with the exact no-op guard: entries at or below
    NEG_INF (masked scores, or a never-updated running max) give exactly
    0 instead of whatever exp of a huge negative rounds to."""
    e = torch.exp(x - m)
    return torch.where(x <= NEG_INF, torch.zeros_like(e), e)


def raw_bytes(t):
    """`t` itself, or its uint8 view when it holds float8_e4m3fn codes:
    not every CUDA indexing op (nor `torch.equal` on the CPU) takes
    float8, so quantized pools are gathered, scattered and copied as
    bytes."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def causal_fill(s, qi, kj, block_q, block_k):
    """Mask the upper triangle of a [..., block_q, block_k] score tile
    (q block `qi`, k block `kj`) to NEG_INF: the entries whose absolute
    q index is below their absolute k index. The flash forward and
    backward build their probability tiles through this one mask."""
    q_idx = qi * block_q + torch.arange(block_q, device=s.device)
    k_idx = kj * block_k + torch.arange(block_k, device=s.device)
    keep = q_idx[:, None] >= k_idx[None, :]
    return s.masked_fill(~keep, NEG_INF)


def on_cpu(what, *ts) -> bool:
    """True when every tensor lies on the CPU (a wrapper then runs its
    plain version), False when all lie on one CUDA device (it launches
    its kernel); raises for anything else — a kernel wrapper never falls
    back from a CUDA tensor to the plain version."""
    devs = {t.device for t in ts if isinstance(t, torch.Tensor)}
    if {d.type for d in devs} == {"cpu"}:
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(
            "%s needs all tensors on one CUDA device or all on the CPU "
            "(got %s)" % (what, sorted(str(d) for d in devs)))
    return False


def bind_once(fn):
    """Memoise a no-argument binder (build + load + declare a kernel
    library) so that it runs once per process even when several threads
    make the first call together, as a fleet's replica threads do: the
    others wait for the first and share its result. A binder that
    raises is run again by the next caller."""
    lock = threading.Lock()
    box = []

    @functools.wraps(fn)
    def wrapper():
        if not box:
            with lock:
                if not box:
                    box.append(fn())
        return box[0]

    return wrapper


# one lock for every launch counter: `+= 1` on a dict entry is a read,
# an add and a write, and two threads that launch at once could lose a
# count
_COUNT_LOCK = threading.Lock()


def count_launch(counts, key):
    """Add one to `counts[key]`, a kernel's entry in its module's dict
    of launch counters, exactly under concurrent launches."""
    with _COUNT_LOCK:
        counts[key] += 1
