"""Serving metrics: tokens/s, slot occupancy, queue wait, time-to-first-
token, prefix reuse and block-pool gauges for the continuous-batching
engine (counterpart of paddle_tpu/serving/metrics.py).

Wall-clock spans land in a small per-event collector (Calls / Total /
Min / Max / Ave in ms) that `print_report()` renders as a table.
Aggregates (`report()`) are O(1) running sums, never per-step history.
The JAX package's compile (trace) counters are left out: this port runs
eagerly, so there is nothing to count; where the reference reports the
speculative verify step's trace count, this one reports how many verify
steps ran (`spec_verify_steps`: with spec decoding on, every decode step
is one). The device-busy interval union is left out too: an eager step's dispatch-to-sync span is mostly host work, and
the device's busy share comes from a profiler (`chip_smoke.py
--profile`). Spans end where the engine synchronises (it reads each
step's tokens back), so tokens/s means the card's only when run there.
"""

from __future__ import annotations

import time
from typing import Dict, List

from ..utils.stat import RunningStat

__all__ = ["ServingMetrics"]


class _SpanTable(object):
    """event name -> [calls, total, min, max] wall-clock seconds."""

    def __init__(self):
        self.rows: Dict[str, List[float]] = {}

    def record(self, name: str, seconds: float):
        row = self.rows.get(name)
        if row is None:
            self.rows[name] = [1, seconds, seconds, seconds]
        else:
            row[0] += 1
            row[1] += seconds
            row[2] = min(row[2], seconds)
            row[3] = max(row[3], seconds)

    def table(self):
        """[{Event, Calls, Total, Min, Max, Ave}] in ms, largest total
        first."""
        out = [
            {"Event": name, "Calls": calls, "Total": total * 1e3,
             "Min": mn * 1e3, "Max": mx * 1e3, "Ave": total / calls * 1e3}
            for name, (calls, total, mn, mx) in self.rows.items()
        ]
        out.sort(key=lambda r: r["Total"], reverse=True)
        return out


def format_table(table, elapsed: float) -> str:
    lines = ["Total time span: %.4fs" % elapsed,
             "%-32s %8s %12s %12s %12s %12s" % (
                 "Event", "Calls", "Total(ms)", "Min(ms)", "Max(ms)",
                 "Ave(ms)")]
    for r in table:
        lines.append("%-32s %8d %12.4f %12.4f %12.4f %12.4f" % (
            r["Event"][:32], r["Calls"], r["Total"], r["Min"], r["Max"],
            r["Ave"]))
    return "\n".join(lines)


class ServingMetrics(object):
    def __init__(self, max_slots: int):
        self.max_slots = int(max_slots)
        self.ops = _SpanTable()  # wall-clock spans
        self.prefills = 0
        self.decode_steps = 0
        self.tokens_out = 0
        self.occupancy = RunningStat()  # live slots / max_slots per decode
        self.queue_wait_s = RunningStat()  # submit -> admission
        self.ttft_s = RunningStat()  # submit -> first token
        # chunked-prefill work actually computed, prefix-pool reuse per
        # admission, and side-band host->device uploads (the steady
        # decode loop must not grow this)
        self.prefill_chunks = 0
        self.prefill_tokens_computed = 0
        self.band_uploads = 0
        self.prefix_hit_tokens = RunningStat()  # cached tokens/admission
        self.prefix_cache = None  # set by the engine when reuse is on
        # paged KV block pool: gauges (set by the engine each step or
        # scheduler event) vs cumulative ints
        self.kv_blocks_total = 0          # gauge: pool size in blocks
        self.kv_blocks_in_use = 0         # gauge: physical blocks live
        self.kv_frag_tokens = 0           # gauge: allocated - resident
        self.kv_blocks_freed_at_retire = 0  # cumulative physical frees
        self.kv_tail_blocks_freed = 0     # cumulative: reserved, never
        #                                   reached (early EOS tails)
        self.cow_blocks = 0               # cumulative copy-on-writes
        # speculative decoding, cumulative
        self.spec_windows = 0             # verify rows run
        self.spec_drafted = 0             # drafted tokens proposed
        self.spec_accepted = 0            # drafts emitted
        # request SLO: deadlines, cancels, token-level resume
        self.expired = 0
        self.cancelled = 0
        self.resumed_requests = 0
        self.resume_tokens_reused = 0
        # EWMA of ServingEngine.step() wall time (gauge; includes the
        # injector tick, so an injected gray stall is visible here)
        self.step_ewma_s = 0.0
        self.paged_kernel = None  # gauge: "fused" | "gather"
        # gauges fixed at construction: the KV pool's storage ("none" |
        # "int8" | "fp8"), the weights' (None | "int8"), and whether decode
        # steps are spec verify steps
        self.kv_quant = None
        self.weight_quant = None
        self.spec = False
        self._t0 = None
        self._t1 = None

    STEP_EWMA_ALPHA = 0.5  # fast decay: ~3 healthy steps erase a spike

    def observe_step(self, seconds: float):
        a = self.STEP_EWMA_ALPHA
        if self.step_ewma_s == 0.0:
            self.step_ewma_s = seconds
        else:
            self.step_ewma_s = a * seconds + (1.0 - a) * self.step_ewma_s

    def span(self, name: str, seconds: float):
        self.ops.record(name, seconds)
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now - seconds
        self._t1 = now

    @property
    def wall_s(self) -> float:
        if self._t0 is None:
            return 0.0
        return (self._t1 or self._t0) - self._t0

    def report(self) -> dict:
        def _mean(st):
            return round(st.mean, 6) if st.count else None

        wall = self.wall_s
        rep = {
            "tokens_out": self.tokens_out,
            "tokens_per_sec": round(self.tokens_out / wall, 2) if wall else None,
            "decode_steps": self.decode_steps,
            "prefills": self.prefills,
            "mean_occupancy": _mean(self.occupancy),
            "mean_queue_wait_s": _mean(self.queue_wait_s),
            "max_queue_wait_s": round(self.queue_wait_s.max, 6)
            if self.queue_wait_s.count else None,
            "mean_ttft_s": _mean(self.ttft_s),
            "wall_s": round(wall, 4),
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "band_uploads": self.band_uploads,
            "mean_prefix_hit_tokens": _mean(self.prefix_hit_tokens),
            "kv_blocks_total": self.kv_blocks_total,
            "kv_blocks_in_use": self.kv_blocks_in_use,
            "kv_frag_tokens": self.kv_frag_tokens,
            "kv_blocks_freed_at_retire": self.kv_blocks_freed_at_retire,
            "kv_tail_blocks_freed": self.kv_tail_blocks_freed,
            "cow_blocks": self.cow_blocks,
            "spec_windows": self.spec_windows,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_accept_rate": round(
                self.spec_accepted / self.spec_drafted, 4)
            if self.spec_drafted else None,
            "spec_verify_steps": self.decode_steps if self.spec else 0,
            "expired": self.expired,
            "cancelled": self.cancelled,
            "resumed_requests": self.resumed_requests,
            "resume_tokens_reused": self.resume_tokens_reused,
            "step_ewma_s": round(self.step_ewma_s, 6),
            "paged_kernel": self.paged_kernel,
            "kv_quant": self.kv_quant,
            "weight_quant": self.weight_quant,
        }
        if self.prefix_cache is not None:
            rep["prefix_cache"] = self.prefix_cache.stats()
        return rep

    def table(self):
        return self.ops.table()

    def print_report(self):
        print(format_table(self.table(), self.wall_s))
