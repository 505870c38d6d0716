"""lm_serve: the port's continuous-batching ServingEngine
(paddle_tpu_torch.serving.engine) under an open loop: requests arrive on
a schedule, one every 1 / `rate` seconds, whether or not earlier ones
have finished (traffic/requests.py), greedy, with no EOS.

Set-up builds the weights and the engine, sends one request of each
prefill bucket's length through it, then offers the load for `warm_s`
so that the window opens on an engine in its steady state.
`serve_tokens_per_s` counts every output token emitted while the window
is open, by finished and unfinished requests. A mix offered far above
what the engine sustains keeps a backlog that never drains, so the rate
reads the engine's capacity; a request still queued when the window
closes is late, not failed, and only a request that errors counts as
failed. A mix with `ttft_wait_s` above 0 also reports the tail:
a request's time to first token runs from when it was due, so the wait
a stall imposes on later arrivals counts, and `ttft_p95_ms` is the 95th
percentile over every request due while the window is open; once it
closes the load goes on (uncounted) until each of those has its first
token (`ttft_wait_s` at most; one that has none then counts with the
time it has waited). The check compares a sample of the finished
requests, drawn from the seed with the longest among them, with the
reference (compare.token_gap)."""

import time

import numpy as np
import torch

from ..counts import lm as counts
from ..lib import compare, dev, weights
from ..lib.lowp import fp8_act, fp8_matmul
from ..lib.stats import pct
from ..reference import gpt2 as ref
from ..traffic import requests as traffic


def setup(cell):
    return LMServe(cell)


class LMServe(object):
    def __init__(self, cell):
        c, t = cell.config, cell.traffic
        self.cell, self.dev, self.t = cell, cell.device, t
        self.dtype = getattr(torch, c["torch_dtype"])
        self.heads, self.L = c["n_head"], c["n_layer"]
        self.d, self.V = c["n_embd"], c["vocab_size"]
        from paddle_tpu_torch.models import transformer as tlm
        from paddle_tpu_torch.serving.engine import ServingEngine

        m = c["n_inner"] or 4 * self.d
        cfg = tlm.TransformerConfig(vocab=self.V, dim=self.d,
                                    heads=self.heads, layers=self.L,
                                    mlp_mult=m // self.d,
                                    max_len=c["n_positions"],
                                    dtype=self.dtype)
        self.tree = weights.to_tree(weights.gpt2_flat(
            c, cell.seed, self.dev, self.dtype))
        self.engine = ServingEngine(
            self.tree, cfg, max_slots=t["max_slots"],
            kv_block_tokens=t["kv_block_tokens"],
            prefill_chunk_tokens=t["prefill_chunk_tokens"],
            decode_window=t["decode_window"],
            async_dispatch=t["async_dispatch"], device=self.dev)
        self.reqs = traffic.requests(t, cell.seed, self.V)
        self.gaps = traffic.gaps(t)
        self.handles = []     # every request submitted: (due, handle)
        self.counters = {"matmul_params": (4 + 2 * m // self.d) * self.L
                         * self.d * self.d, "head_params": self.V * self.d}
        self._warm()

    # -- the open loop --------------------------------------------------
    def _warm(self):
        b = 8
        while b <= self.t["prefill_chunk_tokens"]:  # each prefill bucket
            self.engine.submit(np.asarray(self.reqs[0][0][:b], np.int32), 4)
            b *= 2
        self.engine.run()
        self.next_due = time.monotonic()
        self._run_for(self.t["warm_s"])

    def _pump(self):
        """Submit every request that is due."""
        now = time.monotonic()
        while self.next_due <= now:
            i = len(self.handles)
            prompt, n_out = self.reqs[i % len(self.reqs)]
            h = self.engine.submit(np.asarray(prompt, np.int32), n_out)
            self.handles.append((self.next_due, h))
            self.next_due += self.gaps[i % len(self.gaps)]

    def _tick(self):
        self._pump()
        if not self.engine.step():
            # nothing to do: wait for the next arrival
            time.sleep(max(0.0, min(self.next_due - time.monotonic(),
                                    1e-3)))

    def _run_for(self, seconds, until=None):
        t0 = time.monotonic()
        while time.monotonic() - t0 < seconds and not (until and until()):
            self._tick()

    def sync(self):
        dev.sync(self.dev)

    @staticmethod
    def _emitted(hs):
        return sum(len(h.tokens) for h in hs)

    def window(self, seconds):
        live = [h for _, h in self.handles if not h.done]
        marks = [len(h.tokens) for h in live]
        first = len(self.handles)
        m = self.engine.metrics
        busy0 = m.device_busy_s
        t0 = time.monotonic()
        self._run_for(seconds)
        t1 = time.monotonic()
        wall = t1 - t0
        due = [(d, h) for d, h in self.handles[first:] if d < t1]
        new = [h for _, h in self.handles[first:]]
        hs = live + new
        marks = marks + [0] * len(new)
        emitted = self._emitted(hs) - sum(marks)
        self.counters.update(
            window_s=wall, window_tokens=emitted,
            window_flops=self._window_flops(hs, marks, t0, t1),
            engine_busy_s=m.device_busy_s - busy0)
        metrics = {"serve_tokens_per_s": emitted / wall}
        if self.t["ttft_wait_s"] > 0:
            # the load goes on, uncounted, until every request due in the
            # window has its first token
            self._run_for(self.t["ttft_wait_s"], until=lambda: all(
                h.ttft_s is not None or h.error is not None
                for _, h in due))
            end = time.monotonic()
            ttft = [h.submit_t + h.ttft_s - d if h.ttft_s is not None
                    else end - d for d, h in due]
            metrics["ttft_p95_ms"] = 1e3 * pct(ttft, 95)
        failed = [h for _, h in due if h.error is not None]
        return {"metrics": metrics, "attempted": len(due),
                "failed": len(failed)}

    def _window_flops(self, hs, marks, t0, t1):
        """FLOPs the window's tokens needed: each prompt whose first token
        came inside the window, prefilled whole (causal attention), and
        each output token after the first, its matrix products and its
        attention over its context; every emitted token one row of the
        tied head."""
        d, L = self.d, self.L
        per_tok = 2.0 * self.counters["matmul_params"]
        head = 2.0 * self.counters["head_params"]
        flops = 0.0
        for h, k in zip(hs, marks):
            T0 = len(h.prompt)
            if h.ttft_s is not None and t0 <= h.submit_t + h.ttft_s <= t1:
                flops += T0 * per_tok + head + 4.0 * d * L * T0 * (T0 + 1) / 2
            for i in range(max(k, 1), len(h.tokens)):
                flops += per_tok + head + 4.0 * d * L * (T0 + i)
        return flops

    def slice(self):
        hs = [h for _, h in self.handles if not h.done]
        marks = [len(h.tokens) for h in hs]
        first = len(self.handles)
        self._run_for(self.t["slice_s"])
        self.sync()
        new = [h for _, h in self.handles[first:]]
        ctxs = []
        for h, k in zip(hs + new, marks + [0] * len(new)):
            T0 = len(h.prompt)
            ctxs += [T0 + i for i in range(max(k, 1), len(h.tokens))]
        esize = torch.empty((), dtype=self.dtype).element_size()
        f, b = counts.paged_step(ctxs, self.heads, self.d // self.heads,
                                 esize)
        self.counters.update(slice_decode_flops=f * self.L,
                             slice_decode_bytes=b * self.L,
                             slice_decode_tokens=len(ctxs))

    def release(self):
        done = [h for _, h in self.handles if h.done and h.error is None
                and h.finish_reason == "budget"]
        self.finished = [(np.asarray(h.prompt, np.int64),
                          np.asarray(h.tokens, np.int64)) for h in done]
        self.engine = self.tree = self.handles = None

    def _sample(self):
        g = torch.Generator().manual_seed(int(self.cell.seed) + 3)
        n = len(self.finished)
        k = min(self.t["check_requests"], n)
        longest = max(range(n), key=lambda i: len(self.finished[i][0])
                      + len(self.finished[i][1]))
        rest = [i for i in torch.randperm(n, generator=g).tolist()
                if i != longest]
        return [self.finished[i] for i in [longest] + rest[:k - 1]]

    def check(self):
        if not self.finished:
            return {"logit_gap": float("inf")}
        flat = weights.gpt2_flat(self.cell.config, self.cell.seed, self.dev,
                                 self.dtype)
        w = {n: x.float() for n, x in flat}
        del flat
        control = self.cell.mode == "control"
        gap = 0.0
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.no_grad():
                for prompt, toks in self._sample():
                    toks = self._served(toks)
                    seq = torch.from_numpy(np.concatenate(
                        [prompt, toks[:-1]])).to(self.dev)[None]
                    z = ref.logits(w, seq, self.heads)[0, len(prompt) - 1:]
                    served = torch.from_numpy(toks).to(self.dev)
                    if control:
                        zq = ref.logits(w, seq, self.heads, fp8_matmul,
                                        fp8_act)
                        served = zq[0, len(prompt) - 1:].argmax(-1)
                    gap = max(gap, compare.token_gap(z, served))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        return {"logit_gap": gap}

    def _served(self, toks):
        if self.cell.fault == "token":  # one token altered where produced
            toks = toks.copy()
            toks[len(toks) // 2] = (toks[len(toks) // 2] + 1) % self.V
        elif self.cell.fault is not None:
            raise ValueError("no fault %r for lm_serve" % self.cell.fault)
        return toks
