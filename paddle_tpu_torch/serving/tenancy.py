"""Multi-tenant serving: tenant registry, token-bucket admission
quotas, weighted fair queueing, and the batch (model-zoo) lane
(counterpart of paddle_tpu/serving/tenancy.py; adapters.py is the
weight half).

The fleet so far serves one anonymous caller; the reference's
`save_inference_model` story serves a whole model zoo to many
consumers. The multi-consumer contract this module adds to the front
door (serving/fleet.py wires it in):

  * `TenantRegistry` — named tenants, each with a TOKEN-BUCKET
    admission quota (`rate` requests/s refill, `burst` bucket
    capacity), a weighted-fair-queueing `weight`, an optional default
    adapter (adapters.py — the tenant's LoRA delta rides every
    request unless overridden), and O(1) per-tenant metrics
    (submitted/completed/shed/expired/rejected/tokens, mean queue
    wait). A submit past the bucket raises `TenantQuotaExceeded` —
    which, like `FleetSaturated`, is NEVER journaled: the durable
    table only holds requests the fleet accepted, so quota shed can
    never be replayed by a recovery.
  * `WFQueue` — classic virtual-time weighted fair queueing (the
    packet-scheduling WFQ/SFQ algorithm applied to requests): each
    request's finish tag is max(virtual time, tenant's last tag) +
    cost/weight, the queue pops the smallest tag, and virtual time
    advances to the popped tag. `cost` is the request's estimated
    service (prompt + budget tokens for LM work, the caller's
    estimate for batch jobs), so a tenant's share of the fleet is
    proportional to its weight in TOKENS, not request count — a
    tenant of long prompts cannot starve a tenant of short ones by
    counting. The fleet holds requests here when every replica's
    dispatch window is full and drains in tag order at every
    scheduler handshake; under no contention WFQ degenerates to FCFS
    (tags pop in arrival order) and costs one heap push/pop.
  * Batch (zoo) lane — a tenant whose work is batched image/CTR
    inference submits host callables (`ServingFleet.submit_batch`,
    e.g. one `Executor.run` micro-batch built by
    `executor_batch_fn`). Batch jobs ride the SAME quota buckets,
    the SAME weighted fair queue (cost-weighted against LM tokens),
    the SAME journal (assign/done with the typed `tenant` side-band,
    protocol_lint J008), and the SAME replica scheduler loop — at
    most ONE zoo micro-batch per scheduler handshake, interleaved
    with the engine's batched decode steps exactly like prefill
    chunks are (the Sarathi rule applied across workload kinds), so
    zoo throughput can never starve decode latency.

Host-only admission bookkeeping, except the batch lane: an
`executor_batch_fn` job runs a port Fluid program, on the card unless
its executor was given a CPU place. The registry takes
its own lock (`_lock`) because replica threads update tenant metrics
at completion while the caller's thread sheds in submit; the fleet's
`_cond` is always acquired FIRST when both are held (one direction —
no inversion for lock_lint's L002 to find). `WFQueue` itself is
confined to the fleet's scheduler state like the inboxes it feeds.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..utils.stat import RunningStat

__all__ = ["Tenant", "TenantRegistry", "TenantQuotaExceeded",
           "WFQueue", "executor_batch_fn"]


class TenantQuotaExceeded(RuntimeError):
    """`submit()` refused: the tenant's token bucket is empty. Like
    `FleetSaturated` this is an explicit, NEVER-journaled shed — but
    scoped to one tenant: a bursting tenant exhausts its own bucket
    and is told so, while the fleet (and every other tenant's
    admission) stays untouched. Carries the tenant and the seconds
    until one credit refills."""

    def __init__(self, msg: str, tenant=None, retry_after_s=None):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class Tenant(object):
    """One registered consumer: quota bucket + fair-share weight +
    default adapter/SLO + O(1) metrics. All mutable state is
    guarded by the owning registry's lock."""

    def __init__(self, name: str, rate: float, burst: float,
                 weight: float = 1.0, adapter: Optional[str] = None,
                 slo: Optional[str] = "interactive"):
        if float(rate) <= 0.0:
            raise ValueError("tenant rate must be > 0 requests/s")
        if float(burst) < 1.0:
            raise ValueError("tenant burst must be >= 1 request")
        if float(weight) <= 0.0:
            raise ValueError("tenant weight must be > 0")
        self.name = name
        self.rate = float(rate)      # bucket refill, requests/second
        self.burst = float(burst)    # bucket capacity, requests
        self.weight = float(weight)  # WFQ share
        self.adapter = adapter       # default adapters.py name (None = base)
        self.slo = slo               # default SLO class for its requests
        # token bucket: starts FULL (a fresh tenant may burst to its
        # capacity immediately — that is what burst means)
        self._tokens = float(burst)            # guarded-by: _lock
        self._refill_at: Optional[float] = None  # guarded-by: _lock
        # O(1) metrics (the ServingMetrics discipline)
        self.submitted = 0                     # guarded-by: _lock
        self.completed = 0                     # guarded-by: _lock
        self.shed_quota = 0                    # guarded-by: _lock
        self.expired = 0                       # guarded-by: _lock
        self.rejected = 0                      # guarded-by: _lock
        self.tokens_out = 0                    # guarded-by: _lock
        self.batch_jobs = 0                    # guarded-by: _lock
        self.queue_wait_s = RunningStat()      # guarded-by: _lock

    def snapshot(self) -> dict:  # holds: _lock (via registry)
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "shed_quota": self.shed_quota,
            "expired": self.expired,
            "rejected": self.rejected,
            "tokens_out": self.tokens_out,
            "batch_jobs": self.batch_jobs,
            "mean_queue_wait_s": (round(self.queue_wait_s.mean, 6)
                                  if self.queue_wait_s.count else None),
            "weight": self.weight,
            "rate": self.rate,
            "burst": self.burst,
            "adapter": self.adapter,
            "slo": self.slo,
        }


class TenantRegistry(object):
    """Tenant table + quota admission. One lock guards every bucket
    and metric; the fleet calls in under its own `_cond` (always
    outer), replica threads via the completion/expiry accounting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: Dict[str, Tenant] = {}  # guarded-by: _lock

    def add(self, name: str, rate: float = 100.0, burst: float = 100.0,
            weight: float = 1.0, adapter: Optional[str] = None,
            slo: Optional[str] = "interactive") -> Tenant:
        t = Tenant(name, rate, burst, weight=weight, adapter=adapter,
                   slo=slo)
        with self._lock:
            if name in self._tenants:
                raise ValueError("tenant %r already registered" % name)
            self._tenants[name] = t
        return t

    def get(self, name: str) -> Tenant:
        with self._lock:
            t = self._tenants.get(name)
        if t is None:
            raise KeyError("unknown tenant %r (registered: %r)"
                           % (name, self.names()))
        return t

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._tenants

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._tenants)

    # -- quota admission ------------------------------------------------
    def check_quota(self, name: str, cost: float = 1.0,
                    now: Optional[float] = None):
        """Refill the tenant's token bucket and raise
        `TenantQuotaExceeded` (counting the shed) when it cannot cover
        `cost` — WITHOUT consuming anything. The fleet calls this
        BEFORE its own saturation shed and `consume()` only once the
        request is actually accepted: a request refused for fleet
        overload must not drain the tenant's bucket or count against
        its submissions (quota punished for overload would be exactly
        the blur the check ordering exists to prevent). The bucket
        refills continuously at `rate`, capped at `burst` — the
        standard token bucket, so a tenant may burst to its capacity
        and then sustains exactly its rate. Never journaled by the
        caller: shed requests were never accepted."""
        t = self.get(name)
        now = time.monotonic() if now is None else now
        with self._lock:
            if t._refill_at is not None:
                t._tokens = min(
                    t.burst, t._tokens + (now - t._refill_at) * t.rate)
            t._refill_at = now
            if t._tokens < cost:
                t.shed_quota += 1
                retry = (cost - t._tokens) / t.rate
                raise TenantQuotaExceeded(
                    "tenant %r over admission quota: %.2f credit(s) in "
                    "bucket, %.2f needed (rate %g/s, burst %g) — retry "
                    "in %.3fs" % (name, t._tokens, cost, t.rate,
                                  t.burst, retry),
                    tenant=name, retry_after_s=retry)

    def consume(self, name: str, cost: float = 1.0):
        """The accept half: charge the bucket and count the
        submission. Clamped at zero for robustness, but under the
        fleet's lock a `check_quota` that just passed guarantees the
        credit is there."""
        t = self.get(name)
        with self._lock:
            t._tokens = max(0.0, t._tokens - cost)
            t.submitted += 1

    def admit(self, name: str, cost: float = 1.0,
              now: Optional[float] = None):
        """check_quota + consume as one call (tests / callers without
        an intervening accept gate)."""
        self.check_quota(name, cost=cost, now=now)
        self.consume(name, cost=cost)

    # -- completion accounting (called under the fleet's _cond) ---------
    def on_complete(self, name: str, n_tokens: int,
                    queue_wait_s: Optional[float] = None,
                    batch: bool = False):
        t = self.get(name)
        with self._lock:
            t.completed += 1
            t.tokens_out += int(n_tokens)
            if batch:
                t.batch_jobs += 1
            if queue_wait_s is not None:
                t.queue_wait_s.append(queue_wait_s)

    def on_expire(self, name: str):
        t = self.get(name)
        with self._lock:
            t.expired += 1

    def on_reject(self, name: str):
        t = self.get(name)
        with self._lock:
            t.rejected += 1

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {n: t.snapshot() for n, t in self._tenants.items()}


class WFQueue(object):
    """Virtual-time weighted fair queue of fleet handles. Confined to
    the fleet's scheduler state (mutated only under its `_cond`, like
    the replica inboxes this drains into)."""

    def __init__(self):
        # heap of (finish_tag, seq, handle); seq breaks ties FCFS
        self._heap: List[Tuple[float, int, object]] = []  # guarded-by: fleet
        self._seq = 0                                     # guarded-by: fleet
        self._vtime = 0.0                                 # guarded-by: fleet
        self._last_tag: Dict[str, float] = {}             # guarded-by: fleet

    def push(self, tenant: str, weight: float, cost: float, handle):
        """Stamp the request's virtual finish tag and enqueue. A
        tenant with backlog accumulates tags `cost/weight` apart; an
        idle tenant re-enters at the current virtual time (it is not
        owed credit for time it had nothing queued — the WFQ
        freshness rule)."""
        tag = max(self._vtime, self._last_tag.get(tenant, 0.0)) \
            + float(cost) / float(weight)
        self._last_tag[tenant] = tag
        heapq.heappush(self._heap, (tag, self._seq, handle))
        self._seq += 1

    def pop(self):
        tag, _seq, h = heapq.heappop(self._heap)
        self._vtime = tag
        return h

    def entries(self):
        """The waiting handles, unordered (the fleet's deadline sweep:
        a verdict must not wait for dispatch-window capacity)."""
        return [h for _tag, _seq, h in self._heap]

    def clear(self):
        self._heap = []

    def __len__(self):
        return len(self._heap)

    def __bool__(self):
        return bool(self._heap)


def executor_batch_fn(exe, program, feed: dict, fetch_list,
                      scope=None):
    """One model-zoo micro-batch as a batch-lane job: a closure over
    the EXISTING `fluid.Executor` path (the reference's
    `save_inference_model` serving story), runnable by
    `ServingFleet.submit_batch`. The replica scheduler runs it between
    engine steps; its return value lands on the handle's
    `batch_result`. Pass the `scope` the program's parameters live in
    when it is not the executor's default."""
    def run():
        if scope is not None:
            from ..fluid.executor import scope_guard

            with scope_guard(scope):
                return exe.run(program, feed=feed,
                               fetch_list=fetch_list)
        return exe.run(program, feed=feed, fetch_list=fetch_list)

    return run
