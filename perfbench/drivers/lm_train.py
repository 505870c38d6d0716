"""lm_train: the port's LM training step, `make_train_step(cfg,
attn_impl="flash")` from paddle_tpu_torch.models.transformer, one step
after another on token batches made from the seed.

Set-up builds the step and its parameters once, drives them through
the traffic's `checked_steps` first steps (on distinct batches, through
the window's own call) and keeps what the comparison needs: each step's
loss, each leaf's first gradient as the step's change over the rate, and
each leaf's change over those steps. The window then runs the same step
on the same parameters, cycling over `distinct_batches` batches, with no
host read: the host stays two steps ahead. `train_tokens_per_s` is every
token trained over the whole window, which ends in a sync.

A run protocol shared by the drivers: `sync()`, `window(seconds)` ->
{"metrics", "attempted", "failed"}, `slice()` (the traced stretch, ending
in a sync), `counters` (what the per-layer readers read), `release()`
(frees the program's state once the memory peak is read) and `check()`
-> {name: reading}, the readings compared with the reference."""

import time

import torch

from ..counts import lm as counts
from ..lib import compare, dev, weights
from ..lib.lowp import fp8_act, fp8_matmul
from ..reference import gpt2 as ref


def setup(cell):
    return LMTrain(cell)


class LMTrain(object):
    def __init__(self, cell):
        c, t = cell.config, cell.traffic
        self.cell, self.dev = cell, cell.device
        self.B, self.T, self.lr = t["batch"], t["seq"], t["lr"]
        self.dtype = getattr(torch, c["torch_dtype"])
        self.heads = c["n_head"]
        self.rows = t["reference_rows"]
        d, L, V = c["n_embd"], c["n_layer"], c["vocab_size"]
        m = c["n_inner"] or 4 * d
        self.batches = weights.token_batches(
            cell.seed, t["distinct_batches"], self.B, self.T, V, self.dev)
        self.first = self.batches[:t["checked_steps"]]
        self.counters = {
            "train_flops_per_step": counts.train_flops(
                self.B, self.T, L, d, V, m // d),
            "flash_least_s_per_step": counts.flash_step_least_s(
                self.B, self.T, self.heads, d // self.heads,
                torch.empty((), dtype=self.dtype).element_size(), L)}
        flat = weights.gpt2_flat(c, cell.seed, self.dev, self.dtype)
        self.n = 0
        if cell.mode == "control":
            self.readings = ref.train_readings(
                flat, self.first, self.lr, self.heads, self.dtype,
                mm=fp8_matmul, rows=self.rows, act=fp8_act)
            self.step = None
            return
        from paddle_tpu_torch.models import transformer as tlm

        cfg = tlm.TransformerConfig(vocab=V, dim=d, heads=self.heads,
                                    layers=L, mlp_mult=m // d,
                                    max_len=c["n_positions"],
                                    dtype=self.dtype)
        self.leaves = [x for _, x in flat]
        self.tree = weights.to_tree(flat)
        self.step = _planted(tlm, cfg, cell.fault, self.B,
                             tlm.make_train_step(cfg, lr=self.lr,
                                                 attn_impl="flash"))
        self.readings = self._first_steps()

    def _first_steps(self):
        p0 = [x.clone() for x in self.leaves]
        losses = []
        for k, toks in enumerate(self.first):
            losses.append(self.step(self.tree, toks)[1])
            if k == 0:
                grad = torch.stack([(a.float() - b.float()).norm() / self.lr
                                    for a, b in zip(p0, self.leaves)])
        change = torch.stack([(b.float() - a.float()).norm()
                              for a, b in zip(p0, self.leaves)])
        return {"loss": [float(x) for x in losses], "grad_norms": grad,
                "change_norms": change}

    def sync(self):
        dev.sync(self.dev)

    def _steps(self, seconds=None, count=None):
        lag = dev.Lag(self.dev)
        n = 0
        self.sync()
        t0 = time.monotonic()
        while True:
            toks = self.batches[(len(self.first) + self.n)
                                % len(self.batches)]
            self.step(self.tree, toks)
            self.n += 1
            n += 1
            lag.mark()
            if (count is not None and n >= count) or (
                    seconds is not None
                    and time.monotonic() - t0 >= seconds):
                break
        self.sync()
        return n, time.monotonic() - t0

    def window(self, seconds):
        n, wall = self._steps(seconds=seconds)
        self.counters.update(window_steps=n, window_s=wall)
        return {"metrics": {"train_tokens_per_s":
                            n * self.B * self.T / wall},
                "attempted": n, "failed": 0}

    def slice(self):
        n, _ = self._steps(count=3)
        self.counters.update(slice_steps=n)

    def release(self):
        self.tree = self.leaves = self.step = None

    def check(self):
        flat = weights.gpt2_flat(self.cell.config, self.cell.seed, self.dev,
                                 self.dtype)
        want = ref.train_readings(flat, self.first, self.lr, self.heads,
                                  self.dtype, rows=self.rows)
        self.detail = compare.worst_leaves(self.readings, want)
        return compare.train_gaps(self.readings, want)


def _planted(tlm, cfg, fault, batch, step):
    """The step with a fault planted under it, for the readings script
    and the tests: "unchanged" returns its state unchanged, "half_batch"
    trains on the first half of the batch only."""
    if fault is None:
        return step
    if fault == "unchanged":
        def unchanged(params, tokens):
            with torch.no_grad():
                return params, tlm.loss_fn(params, tokens, cfg,
                                           attn_impl="flash")
        return unchanged
    if fault == "half_batch":
        return lambda params, tokens: step(params, tokens[:batch // 2])
    raise ValueError("no fault %r for lm_train" % fault)
