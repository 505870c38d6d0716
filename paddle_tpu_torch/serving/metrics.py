"""Serving metrics: tokens/s, slot occupancy, queue wait, time-to-first-
token, prefix reuse, block-pool, adapter-pool, fingerprint and KV-store
gauges for the continuous-batching engine (counterpart of
paddle_tpu/serving/metrics.py).

Wall-clock spans land in a small per-event collector (Calls / Total /
Min / Max / Ave in ms) that `print_report()` renders as a table.
Aggregates (`report()`) are O(1) running sums, never per-step history.
The JAX package's compile (trace) counters are left out: this port runs
eagerly, so there is nothing to count; where the reference reports the
speculative verify step's trace count, this one reports how many verify
steps ran (`spec_verify_steps`: with spec decoding on, every decode step
is one).

`device_busy_s` is the union of dispatch-to-sync spans (a decode step,
a decode window, a final prefill chunk), as in the reference. On an
eager engine a span also holds the host's own dispatch work, so
`host_overhead_frac` (wall outside those spans, over wall) is the share
of the scheduler's host work between steps, not the card's idle share;
that comes from a profiler (`chip_smoke.py --profile`). Spans end where
the engine synchronises, so tokens/s means the card's only when run
there.
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
        # gauge: the weight version the engine serves (None outside a
        # versioned fleet)
        self.weights_version = None
        # set by the engine when the adapter pool, KV fingerprints or a
        # KV store is on: report() surfaces their O(1) counters
        self.adapter_pool = None
        self.block_fp = None
        self.kv_store = None
        # durable KV tier, cumulative: closed-block prompt tokens a
        # resumed admission re-prefilled (0 on the clean path), handoff
        # imports and fallbacks, store spills, warm loads, rejections
        self.tokens_recomputed_at_migration = 0
        self.handoff_imports = 0
        self.handoff_blocks_imported = 0
        self.handoff_tokens_imported = 0
        self.handoff_fallbacks = 0
        self.store_spilled_blocks = 0
        self.store_warm_blocks = 0
        self.store_quarantined = 0
        # union of dispatch-to-sync spans (module docstring), folded
        # through a last-end watermark so overlapping async windows
        # never count twice
        self.device_busy_s = 0.0
        self._busy_last_end = 0.0
        self._t0 = None
        self._t1 = None

    STEP_EWMA_ALPHA = 0.5  # fast decay: ~3 healthy steps erase a spike

    def observe_step(self, seconds: float, tokens: int = 1):
        """Fold one engine-step wall time into the step-latency EWMA,
        normalised PER TOKEN: `tokens` is the step's token capacity (the
        static decode window), so a K-token window does not read K
        times slower than a one-token step; K=1 keeps the per-step
        meaning."""
        a = self.STEP_EWMA_ALPHA
        seconds = seconds / max(1, int(tokens))
        if self.step_ewma_s == 0.0:
            self.step_ewma_s = seconds
        else:
            self.step_ewma_s = a * seconds + (1.0 - a) * self.step_ewma_s

    def observe_device_interval(self, start: float, end: float):
        """Fold one dispatch-to-sync span into the busy union. Spans
        arrive in sync order; overlap with an earlier span (an async
        window dispatched before its predecessor synced) counts once."""
        lo = max(start, self._busy_last_end)
        if end > lo:
            self.device_busy_s += end - lo
            self._busy_last_end = end

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
            "device_busy_s": round(self.device_busy_s, 4),
            "host_overhead_frac": round(
                max(0.0, wall - self.device_busy_s) / wall, 4)
            if wall else None,
            "paged_kernel": self.paged_kernel,
            "kv_quant": self.kv_quant,
            "weight_quant": self.weight_quant,
            "weights_version": self.weights_version,
            "tokens_recomputed_at_migration":
                self.tokens_recomputed_at_migration,
            "handoff_imports": self.handoff_imports,
            "handoff_blocks_imported": self.handoff_blocks_imported,
            "handoff_tokens_imported": self.handoff_tokens_imported,
            "handoff_fallbacks": self.handoff_fallbacks,
            "store_spilled_blocks": self.store_spilled_blocks,
            "store_warm_blocks": self.store_warm_blocks,
            "store_quarantined": self.store_quarantined,
        }
        if self.prefix_cache is not None:
            rep["prefix_cache"] = self.prefix_cache.stats()
        if self.adapter_pool is not None:
            rep["adapter_pool"] = self.adapter_pool.stats()
        if self.block_fp is not None:
            rep["block_fingerprints"] = self.block_fp.stats()
        if self.kv_store is not None:
            rep["kv_store"] = self.kv_store.stats()
        return rep

    def table(self):
        return self.ops.table()

    def print_report(self):
        print(format_table(self.table(), self.wall_s))
