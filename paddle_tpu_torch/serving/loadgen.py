"""Open-loop load generator for the serving front door (counterpart of
paddle_tpu/serving/loadgen.py): fixed-rate Poisson arrivals over
real sockets, swept to the capacity knee.

Open loop, not closed loop — the sizing rule that matters (Schroeder
et al., "Open Versus Closed: A Cautionary Tale", NSDI'06): a
closed-loop client waits for a completion before sending the next
request, so when the server saturates the CLIENT slows down with it
and the measured latency stays politely bounded — collapse is
structurally invisible. An open-loop client sends at the scheduled
arrival times no matter what is outstanding, which is how real
traffic behaves; past the knee the backlog grows without bound and
p99 TTFT inflects while goodput flattens at capacity. Only the open
loop can find that knee, and the knee — not the closed-loop
throughput — is the number an operator can size against.

Determinism: arrivals, tenant choices, prompts, and budgets all come
from one seeded RandomState, so a sweep is reproducible request-for-
request; only wall-clock timings vary run to run.

Every timing below is host wall-clock around socket I/O: a run on the
CPU measures shapes (shed rates, divergence, relative knee position),
and only a run against a fleet on the card measures the card's
throughput."""

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from .wire import WireClient

# TTFT histogram bucket edges (seconds) for SLO scoring of chaos runs:
# a kill drill shows up as mass migrating to the tail buckets, which a
# bare mean would average away
SLO_BUCKETS_S = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


class LoadReport(dict):
    """One open-loop run's report: a dict (JSON-able, bench-row
    friendly) with attribute sugar for the common keys."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)


def _pct(xs: List[float], q: float) -> Optional[float]:
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _histogram(xs: List[float]) -> Dict[str, int]:
    """TTFT values -> SLO bucket counts ("<=0.05s", ..., ">5.0s")."""
    out: Dict[str, int] = {}
    for edge in SLO_BUCKETS_S:
        out["<=%gs" % edge] = 0
    out[">%gs" % SLO_BUCKETS_S[-1]] = 0
    for x in xs:
        for edge in SLO_BUCKETS_S:
            if x <= edge:
                out["<=%gs" % edge] += 1
                break
        else:
            out[">%gs" % SLO_BUCKETS_S[-1]] += 1
    return out


class _Recorder(object):
    """Per-connection frame collector. One reader thread per
    connection drains server frames into per-request records; the
    dispatcher never blocks on it (open loop)."""

    def __init__(self, client: WireClient):
        self.client = client
        self.lock = threading.Lock()
        self.records: Dict[str, dict] = {}   # guarded-by: lock
        self.thread = threading.Thread(
            target=self._loop, name="loadgen-reader", daemon=True)
        self.thread.start()

    def expect(self, req_id: str, t_send: float, tenant: str,
               streamed: bool):
        with self.lock:
            self.records[req_id] = {
                "tenant": tenant, "streamed": streamed,
                "t_send": t_send, "t_first": None, "token_t": [],
                "chunks": [], "done": None, "error": None,
                "t_done": None, "rid": None,
            }

    def _loop(self):  # thread: loadgen-reader
        while True:
            try:
                f = self.client.recv()
            except Exception:
                return
            if f is None:
                return
            now = time.monotonic()
            rid = f.get("id")
            with self.lock:
                rec = self.records.get(rid)
                if rec is None:
                    continue
                op = f.get("op")
                if op == "accepted":
                    rec["rid"] = f.get("rid")
                elif op == "tokens":
                    if rec["t_first"] is None:
                        rec["t_first"] = now
                    rec["token_t"].append(now)
                    rec["chunks"].append(list(f["tokens"]))
                elif op == "done":
                    if rec["t_first"] is None:
                        rec["t_first"] = now
                    rec["done"] = list(f["tokens"])
                    rec["t_done"] = now
                elif op == "error":
                    rec["error"] = f.get("code", "INTERNAL")
                    rec["t_done"] = now

    def unresolved(self) -> List[str]:
        with self.lock:
            return [k for k, r in self.records.items()
                    if r["done"] is None and r["error"] is None]


def run_open_loop(address, tenants, rate_rps: float,
                  duration_s: float, seed: int = 0,
                  prompt_len: int = 4, max_new_tokens: int = 8,
                  vocab: int = 97, deadline_s: Optional[float] = None,
                  stream: bool = True,
                  settle_s: float = 30.0,
                  chaos_after_s: Optional[float] = None,
                  chaos_fn=None) -> LoadReport:
    """One fixed-rate open-loop run against a front door at
    `address`. `tenants` is a list of dicts: {"name", "token",
    "weight"} (token None for a single-tenant fleet; weights are
    arrival-mix probabilities, uniform when omitted). `chaos_fn` is
    called once (from the dispatch thread) when `chaos_after_s` of
    load has elapsed — the hook the chaos variant uses to
    kill/slow a replica mid-load. `settle_s` bounds the post-dispatch
    wait for outstanding verdicts; anything still unresolved then is
    counted `wire_unresolved` (and is a finding, not a shrug)."""
    rng = np.random.RandomState(int(seed))
    n = max(1, int(round(float(rate_rps) * float(duration_s))))
    arrivals = np.cumsum(rng.exponential(1.0 / float(rate_rps), n))
    weights = np.asarray(
        [float(t.get("weight", 1.0)) for t in tenants], np.float64)
    weights = weights / weights.sum()
    t_ix = rng.choice(len(tenants), size=n, p=weights)
    prompts = rng.randint(1, int(vocab), size=(n, int(prompt_len)))

    recs: List[_Recorder] = []
    for t in tenants:
        client = WireClient(address, token=t.get("token"))
        recs.append(_Recorder(client))

    # -- dispatch (open loop: send at the SCHEDULED time, regardless
    # of what is outstanding — never gated on completions)
    t0 = time.monotonic()
    chaos_done = chaos_after_s is None
    sent = 0
    for k in range(n):
        target = t0 + float(arrivals[k])
        while True:
            now = time.monotonic()
            if not chaos_done and now - t0 >= float(chaos_after_s):
                chaos_done = True
                if chaos_fn is not None:
                    chaos_fn()
            if now >= target:
                break
            time.sleep(min(0.002, target - now))
        ti = int(t_ix[k])
        rec = recs[ti]
        req_id = "t%d-%d" % (ti, k)
        rec.expect(req_id, time.monotonic(),
                   tenants[ti]["name"], stream)
        kw = {}
        if deadline_s is not None:
            kw["deadline_s"] = float(deadline_s)
        if stream:
            kw["stream"] = True
        try:
            rec.client.generate(req_id, [int(x) for x in prompts[k]],
                                int(max_new_tokens), seed=int(k),
                                **kw)
            sent += 1
        except Exception:
            with rec.lock:
                rec.records[req_id]["error"] = "SEND_FAILED"
    if not chaos_done and chaos_fn is not None:
        chaos_fn()

    # -- settle: wait for every outstanding verdict (bounded)
    deadline = time.monotonic() + float(settle_s)
    while time.monotonic() < deadline:
        if not any(r.unresolved() for r in recs):
            break
        time.sleep(0.01)
    elapsed = time.monotonic() - t0
    for r in recs:
        r.client.close()
        r.thread.join(timeout=5.0)

    # -- score
    ttft: List[float] = []
    itl: List[float] = []
    per_tenant: Dict[str, dict] = {
        t["name"]: {"sent": 0, "completed": 0, "shed": {},
                    "unresolved": 0} for t in tenants}
    completed = 0
    divergent = 0
    rids_seen: Dict[int, int] = {}
    for r in recs:
        with r.lock:
            items = list(r.records.items())
        for _req_id, rec in items:
            pt = per_tenant[rec["tenant"]]
            pt["sent"] += 1
            if rec["rid"] is not None:
                rids_seen[rec["rid"]] = rids_seen.get(
                    rec["rid"], 0) + 1
            if rec["done"] is not None:
                completed += 1
                pt["completed"] += 1
                ttft.append(rec["t_first"] - rec["t_send"])
                ts = rec["token_t"]
                itl.extend(b - a for a, b in zip(ts, ts[1:]))
                if rec["streamed"]:
                    got = [t for c in rec["chunks"] for t in c]
                    if got != rec["done"]:
                        divergent += 1
            elif rec["error"] is not None:
                pt["shed"][rec["error"]] = \
                    pt["shed"].get(rec["error"], 0) + 1
            else:
                pt["unresolved"] += 1
    shed_total: Dict[str, int] = {}
    unresolved = 0
    for pt in per_tenant.values():
        unresolved += pt["unresolved"]
        for code, cnt in pt["shed"].items():
            shed_total[code] = shed_total.get(code, 0) + cnt
    return LoadReport(
        rate_rps=float(rate_rps), duration_s=float(duration_s),
        seed=int(seed), requests=n, sent=sent, completed=completed,
        offered_rps=round(n / elapsed, 3) if elapsed else None,
        goodput_rps=round(completed / elapsed, 3) if elapsed else None,
        ttft_p50_s=_pct(ttft, 50), ttft_p99_s=_pct(ttft, 99),
        ttft_p999_s=_pct(ttft, 99.9),
        itl_p50_s=_pct(itl, 50), itl_p99_s=_pct(itl, 99),
        itl_p999_s=_pct(itl, 99.9),
        shed=shed_total, per_tenant=per_tenant,
        stream_divergent=divergent,
        wire_unresolved=unresolved,
        duplicate_rids=sum(c - 1 for c in rids_seen.values() if c > 1),
        slo_histogram=_histogram(ttft),
    )


def sweep(address, tenants, rates, duration_s: float,
          seed: int = 0, **kw) -> List[LoadReport]:
    """Rate sweep: one open-loop run per rate (same seed base, so the
    arrival PATTERN scales with the rate deterministically)."""
    return [run_open_loop(address, tenants, r, duration_s,
                          seed=seed + i, **kw)
            for i, r in enumerate(rates)]


def find_knee(reports: List[LoadReport]) -> dict:
    """Locate the capacity knee in a rate sweep: the first rate where
    goodput stops tracking the offered rate (flattens at capacity —
    sheds absorb the excess) while p99 TTFT inflects versus the
    lowest-rate baseline. Returns {"knee_rate_rps", "reason"} with
    None when the sweep never saturated (all rates under capacity —
    sweep higher)."""
    if not reports:
        return {"knee_rate_rps": None, "reason": "empty sweep"}
    base_p99 = reports[0].get("ttft_p99_s") or 0.0
    for rep in reports:
        offered = rep.get("offered_rps") or 0.0
        goodput = rep.get("goodput_rps") or 0.0
        p99 = rep.get("ttft_p99_s")
        sheds = sum(rep.get("shed", {}).values())
        flat = offered > 0 and goodput < 0.8 * offered
        inflected = (p99 is not None and base_p99 > 0
                     and p99 > 2.0 * base_p99)
        if flat and (inflected or sheds > 0):
            return {"knee_rate_rps": rep["rate_rps"],
                    "reason": "goodput %.3f rps vs offered %.3f rps "
                              "(%d shed), p99 TTFT %s vs baseline "
                              "%.4fs" % (goodput, offered, sheds,
                                         ("%.4fs" % p99)
                                         if p99 is not None else "n/a",
                                         base_p99)}
    return {"knee_rate_rps": None,
            "reason": "no rate saturated: goodput tracked offered "
                      "load at every step (sweep higher)"}
