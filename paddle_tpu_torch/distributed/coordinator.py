"""Coordinator: fault-tolerant data-task dispatch (Go master parity;
counterpart of paddle_tpu/distributed/coordinator.py with its wire
protocol, snapshot file and lease generations: a worker of either
package leases from a CoordinatorServer of the other, and a snapshot
written by one recovers in the other).

Reference behavior being reproduced (go/master/service.go):
  - SetDataset partitions data into tasks               (service.go:280,106)
  - GetTask leases a task with a timeout                (service.go:368)
  - task timeout -> re-queue                            (service.go:341,313)
  - TaskFailed / failure count > failureMax -> discard  (service.go:455,313)
  - TaskFinished; pass rollover when todo+pending drain (service.go:411)
  - full state snapshot after every mutation, recovered
    on restart                                          (service.go:166,207)

Differences by design: no etcd (snapshots go to a local/NFS path with
atomic rename — one coordinator process serves the job, so a
distributed lock service is unnecessary); tasks name data shards (file paths, record
ranges) rather than RecordIO chunk handles.
"""

from __future__ import annotations

import json
import os
import random
import socket
import socketserver
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import fault_injection as _fi

__all__ = [
    "Task", "Coordinator", "MasterClient", "CoordinatorServer",
    "RemoteCoordinator",
]


@dataclass
class Task:
    task_id: int
    payload: Any  # JSON-serializable shard description
    epoch: int = 0
    failures: int = 0
    # records of this task already DELIVERED (and durably absorbed) by a
    # previous lease holder: a re-leased task resumes here instead of
    # replaying the whole chunk (offset-aware leases). Reported
    # via task_progress/task_failed; reset at epoch rollover.
    offset: int = 0
    # lease generation: bumped every time the task is handed out. Holder
    # calls (progress/finished/failed) that present a stale generation
    # are refused — after an expiry + re-lease, the ORIGINAL holder can
    # no longer ack, renew, or fail the new holder's lease (the
    # fencing-token pattern; without it "held" answers by task_id alone
    # and a zombie holder silently keeps a lost lease alive).
    lease: int = 0
    deadline: float = field(default=0.0, compare=False)

    def to_json(self):
        return {
            "task_id": self.task_id,
            "payload": self.payload,
            "epoch": self.epoch,
            "failures": self.failures,
            "offset": self.offset,
            "lease": self.lease,
        }

    @staticmethod
    def from_json(d):
        return Task(
            task_id=d["task_id"], payload=d["payload"], epoch=d["epoch"],
            failures=d["failures"], offset=d.get("offset", 0),
            lease=d.get("lease", 0),
        )


class Coordinator(object):
    """Single-controller task-lease service (thread-safe; serve over any
    RPC you like — in-process for tests, so distributed paths stay
    testable in one process)."""

    def __init__(self, timeout_s: float = 60.0, failure_max: int = 3,
                 snapshot_path: Optional[str] = None,
                 heartbeat_timeout_s: float = 30.0):
        self._lock = threading.Lock()
        self.timeout_s = timeout_s
        self.failure_max = failure_max
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.snapshot_path = snapshot_path
        # queue state below is served to many worker threads at once;
        # every mutation must hold _lock
        self.todo: List[Task] = []              # guarded-by: _lock
        self.pending: Dict[int, Task] = {}      # guarded-by: _lock
        self.done: List[Task] = []              # guarded-by: _lock
        self.discarded: List[Task] = []         # guarded-by: _lock
        self.epoch = 0                          # guarded-by: _lock
        self._next_id = 0                       # guarded-by: _lock
        # worker liveness registry (reference: trainers announce
        # themselves in etcd and the master watches their keys,
        # go/pserver/etcd_client.go:70-150). Ephemeral BY DESIGN: a
        # restarted coordinator sees workers re-register on their next
        # heartbeat, so membership is not snapshotted.
        self.workers: Dict[str, dict] = {}      # guarded-by: _lock
        if snapshot_path and os.path.exists(snapshot_path):
            self._recover()

    # --- dataset ------------------------------------------------------
    def set_dataset(self, shards: List[Any]):
        """Partition `shards` (any JSON-serializable descriptions) into
        tasks (reference SetDataset / partition)."""
        with self._lock:
            if self.todo or self.pending:
                return  # idempotent, like the reference's once.Do
            for payload in shards:
                self.todo.append(Task(task_id=self._next_id, payload=payload))
                self._next_id += 1
            self._snapshot()

    # --- lease protocol ----------------------------------------------
    def get_task(self, epoch_limit: Optional[int] = None) -> Optional[Task]:
        """Lease a task; None when this epoch's work is fully leased/done
        (pass end — the reference signals it with ErrPassAfter). Reclaims
        expired leases first (reference checkTimeoutFunc). Rollover into
        the next pass happens only when `epoch_limit` allows it, so bare
        `while get_task()` drain loops always terminate — and a caller's
        `epoch_limit` also caps what it can POP: a worker still draining
        pass e must not be handed tasks a faster peer already rolled to
        pass e+1 (epoch_limit=None places no cap)."""
        with self._lock:
            reclaimed = self._reclaim_expired()
            if not self.todo:
                if not self.pending and (self.done or self.discarded):
                    if epoch_limit is None or self.epoch + 1 > epoch_limit:
                        if reclaimed:
                            self._snapshot()
                        return None
                    self._next_epoch()
                if not self.todo:
                    if reclaimed:
                        self._snapshot()
                    return None
            if epoch_limit is not None and self.todo[0].epoch > epoch_limit:
                # a peer rolled the queue into a later pass than this
                # caller is on: for THIS caller the current pass is over
                if reclaimed:
                    self._snapshot()
                return None
            task = self.todo.pop(0)
            task.deadline = time.time() + self.timeout_s
            task.lease += 1  # fence out the previous holder, if any
            self.pending[task.task_id] = task
            self._snapshot()
            return task

    def task_finished(self, task_id: int, lease: Optional[int] = None):
        """Mark a lease done. A stale `lease` generation (expired +
        re-leased to someone else) is refused: the new holder still owns
        the task. lease=None skips the fence (single-holder callers)."""
        with self._lock:
            task = self.pending.get(task_id)
            if task is None:
                return
            if lease is not None and task.lease != lease:
                return  # zombie holder: the task moved on without it
            del self.pending[task_id]
            self.done.append(task)
            self._snapshot()

    def task_failed(self, task_id: int, offset: Optional[int] = None,
                    lease: Optional[int] = None):
        """Failure count + requeue or discard (reference
        processFailedTask). `offset` records how many of the task's
        records the failing holder already delivered durably — the next
        lease resumes there instead of replaying them. A stale `lease`
        is a no-op (a zombie holder must not fail — or move the offset
        of — the lease the task was re-issued under)."""
        with self._lock:
            task = self.pending.get(task_id)
            if task is None:
                return
            if lease is not None and task.lease != lease:
                return
            del self.pending[task_id]
            if offset is not None:
                task.offset = max(task.offset, int(offset))
            task.failures += 1
            if task.failures >= self.failure_max:
                self.discarded.append(task)
            else:
                self.todo.append(task)
            self._snapshot()

    def task_progress(self, task_id: int, offset: int,
                      lease: Optional[int] = None) -> dict:
        """Record durable delivery progress on a HELD lease (and renew
        its deadline — progress is also a keepalive). A lease that
        expires later requeues with this offset, so the next holder
        never re-delivers committed records. Returns {"held": False}
        when the lease is no longer pending — or is pending under a
        NEWER lease generation than the caller presents (expired and
        re-leased: the caller is a zombie) — and the caller must stop
        delivering from it; the committed offset travels with the
        requeued task instead."""
        with self._lock:
            task = self.pending.get(task_id)
            if task is None:
                return {"held": False}
            if lease is not None and task.lease != lease:
                return {"held": False}
            changed = int(offset) > task.offset
            task.offset = max(task.offset, int(offset))
            task.deadline = time.time() + self.timeout_s
            if changed:
                # deadline renewal alone is not persisted (deadlines do
                # not survive recovery anyway): pure keepalives must not
                # rewrite a byte-identical snapshot every poll
                self._snapshot()
            return {"held": True, "offset": task.offset}

    # --- worker liveness (elastic supervisor protocol) ---------------
    def _new_worker_record(self, now: float, incarnation: int = 1,
                           meta: Optional[dict] = None) -> dict:
        return {
            "incarnation": incarnation,
            "registered_at": now,
            "last_seen": now,
            "deadline": now + self.heartbeat_timeout_s,
            "step": 0,
            "meta": meta or {},
        }

    def register_worker(self, worker_id: str, meta: Optional[dict] = None):
        """(Re-)announce a worker. Each registration bumps the worker's
        incarnation — a supervisor restart of the same worker id is a NEW
        liveness lease, so a stale pre-crash heartbeat can never vouch
        for the replacement process."""
        with self._lock:
            now = time.time()
            prev = self.workers.get(worker_id)
            self.workers[worker_id] = self._new_worker_record(
                now, incarnation=(prev["incarnation"] + 1) if prev else 1,
                meta=meta,
            )
            return {"incarnation": self.workers[worker_id]["incarnation"]}

    def heartbeat(self, worker_id: str, step: Optional[int] = None):
        """Extend a worker's liveness deadline (auto-registers unknown
        ids so a worker that outlived a coordinator restart keeps its
        membership). Returns the new deadline so clients can observe
        clock skew."""
        with self._lock:
            w = self.workers.get(worker_id)
            if w is None:
                w = self.workers[worker_id] = self._new_worker_record(
                    time.time()
                )
            w["last_seen"] = time.time()
            w["deadline"] = w["last_seen"] + self.heartbeat_timeout_s
            if step is not None:
                w["step"] = int(step)
            return {"deadline": w["deadline"]}

    def membership(self) -> Dict[str, dict]:
        """Snapshot of every known worker with a computed `alive` flag
        (deadline not yet passed). The supervisor polls this to find hung
        workers: a process that is running but past its deadline gets
        killed and restarted."""
        with self._lock:
            now = time.time()
            out = {}
            for wid, w in self.workers.items():
                d = dict(w)
                d["alive"] = w["deadline"] > now
                out[wid] = d
            return out

    # --- internals ----------------------------------------------------
    def _reclaim_expired(self) -> bool:
        now = time.time()
        expired = [t for t in self.pending.values() if t.deadline <= now]
        for t in expired:
            del self.pending[t.task_id]
            t.failures += 1
            if t.failures >= self.failure_max:
                self.discarded.append(t)
            else:
                self.todo.append(t)
        return bool(expired)

    def _next_epoch(self):
        self.epoch += 1
        rollover = self.done + self.discarded
        rollover.sort(key=lambda t: t.task_id)
        for t in rollover:
            t.epoch = self.epoch
            t.failures = 0
            t.offset = 0  # a new pass delivers every record again
        self.todo = rollover
        self.done = []
        self.discarded = []

    # --- durability (reference snapshot/recover) ----------------------
    def _snapshot(self):
        if not self.snapshot_path:
            return
        state = {
            "epoch": self.epoch,
            "next_id": self._next_id,
            "todo": [t.to_json() for t in self.todo],
            "pending": [t.to_json() for t in self.pending.values()],
            "done": [t.to_json() for t in self.done],
            "discarded": [t.to_json() for t in self.discarded],
        }
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.snapshot_path)  # atomic, like the etcd put

    def _recover(self):
        with open(self.snapshot_path) as f:
            state = json.load(f)
        self.epoch = state["epoch"]
        self._next_id = state["next_id"]
        self.todo = [Task.from_json(d) for d in state["todo"]]
        # pending leases do not survive a restart: their workers are gone,
        # so they go straight back to todo (reference re-queues on recover)
        self.todo += [Task.from_json(d) for d in state["pending"]]
        self.done = [Task.from_json(d) for d in state["done"]]
        self.discarded = [Task.from_json(d) for d in state["discarded"]]


class CoordinatorServer(object):
    """TCP/JSON transport for a Coordinator: task leases survive process
    boundaries, making the coordinator a SERVICE like the reference Go
    master (go/master/service.go:280,368 serves net/rpc; here the frames
    are newline-delimited JSON — no proto toolchain needed at runtime).

    Wire format, one JSON object per line:
      -> {"method": "get_task", "params": {...}}
      <- {"ok": true, "result": ...} | {"ok": false, "error": "..."}
    """

    _METHODS = ("set_dataset", "get_task", "task_finished", "task_failed",
                "task_progress", "ping", "register_worker", "heartbeat",
                "membership")

    def __init__(self, coordinator: Coordinator, host: str = "127.0.0.1",
                 port: int = 0):
        self.coordinator = coordinator
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    line = self.rfile.readline()
                    if not line:
                        return
                    try:
                        req = json.loads(line)
                        resp = outer._dispatch(req)
                    except Exception as e:  # malformed frame / internal
                        resp = {"ok": False, "error": str(e)}
                    self.wfile.write(
                        (json.dumps(resp) + "\n").encode()
                    )
                    self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = None

    @property
    def address(self) -> str:
        return "%s:%d" % (self.host, self.port)

    def _dispatch(self, req):
        method = req.get("method")
        params = req.get("params") or {}
        if method not in self._METHODS:
            return {"ok": False, "error": "unknown method %r" % method}
        if method == "ping":
            return {"ok": True, "result": "pong"}
        if method == "set_dataset":
            self.coordinator.set_dataset(params["shards"])
            return {"ok": True, "result": None}
        if method == "get_task":
            task = self.coordinator.get_task(
                epoch_limit=params.get("epoch_limit")
            )
            return {"ok": True,
                    "result": task.to_json() if task else None}
        if method == "task_finished":
            self.coordinator.task_finished(int(params["task_id"]),
                                           lease=params.get("lease"))
            return {"ok": True, "result": None}
        if method == "task_progress":
            return {"ok": True, "result": self.coordinator.task_progress(
                int(params["task_id"]), int(params["offset"]),
                lease=params.get("lease"))}
        if method == "register_worker":
            return {"ok": True, "result": self.coordinator.register_worker(
                str(params["worker_id"]), meta=params.get("meta"))}
        if method == "heartbeat":
            return {"ok": True, "result": self.coordinator.heartbeat(
                str(params["worker_id"]), step=params.get("step"))}
        if method == "membership":
            return {"ok": True, "result": self.coordinator.membership()}
        self.coordinator.task_failed(
            int(params["task_id"]),
            offset=params.get("offset"),
            lease=params.get("lease"),
        )
        return {"ok": True, "result": None}

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def serve_forever(self):
        self._server.serve_forever()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


class RemoteCoordinator(object):
    """Client-side proxy with the Coordinator's lease API, usable by
    MasterClient unchanged (reference go/master/client.go over net/rpc).

    Transport failures retry with exponential backoff + full jitter
    under a per-call deadline (the reference trainer's etcd client loops
    the same way while the master key is absent,
    go/pserver/etcd_client.go:70-110) — a coordinator restart, a dropped
    TCP session, or an injected netsplit all heal transparently as long
    as the service returns within `retry_deadline_s`. Lease safety under
    retries comes from the SERVER-side lease timeout, not the transport:
    a get_task whose response was lost leases a task nobody works on,
    and that lease expires and requeues like any other dead worker's.
    """

    def __init__(self, address: str, timeout_s: float = 30.0,
                 retry_deadline_s: Optional[float] = None,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0):
        host, _, port = address.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        self.timeout_s = timeout_s
        self.retry_deadline_s = (
            timeout_s if retry_deadline_s is None else retry_deadline_s
        )
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        # the connection pair is swapped by the retry loop; _lock also
        # serialises whole calls (one request/response in flight).
        # close() is the accepted exception (see its docstring).
        self._sock = None   # guarded-by: _lock
        self._file = None   # guarded-by: _lock
        self._lock = threading.Lock()

    def _connect(self, connect_timeout: Optional[float] = None):
        self.close()
        s = socket.create_connection(
            self.addr,
            timeout=min(self.timeout_s, connect_timeout or self.timeout_s),
        )
        s.settimeout(self.timeout_s)
        self._sock = s
        self._file = s.makefile("rwb")

    def _check_netsplit(self):
        # injected partition (PADDLE_FAULT=netsplit@N:dur): drop the live
        # connection and fail the attempt, exactly like losing the wire
        if _fi.netsplit_active():
            self.close()
            raise ConnectionError("netsplit fault active: connection dropped")

    def _call(self, method, **params):
        with self._lock:
            deadline = time.monotonic() + self.retry_deadline_s
            attempt = 0
            while True:
                try:
                    self._check_netsplit()
                    if self._file is None:
                        self._connect(
                            connect_timeout=max(
                                deadline - time.monotonic(), 0.01
                            )
                        )
                    # the write/readline below must also respect the
                    # per-call deadline: a server that accepts but never
                    # replies would otherwise hold the call for the full
                    # transport timeout_s regardless of retry_deadline_s
                    self._sock.settimeout(min(
                        self.timeout_s,
                        max(deadline - time.monotonic(), 0.01),
                    ))
                    self._file.write(
                        (json.dumps({"method": method, "params": params})
                         + "\n").encode()
                    )
                    self._file.flush()
                    line = self._file.readline()
                    if not line:
                        raise ConnectionError("server closed connection")
                    self._check_netsplit()  # split mid-flight: distrust resp
                    resp = json.loads(line)
                    break
                except (OSError, ConnectionError):
                    self.close()
                    attempt += 1
                    delay = min(
                        self.backoff_max_s,
                        self.backoff_base_s * (2 ** (attempt - 1)),
                    )
                    delay *= random.uniform(0.5, 1.5)  # jitter: no thundering herd
                    if time.monotonic() + delay >= deadline:
                        raise
                    time.sleep(delay)
        if not resp.get("ok"):
            raise RuntimeError(
                "coordinator error: %s" % resp.get("error")
            )
        return resp.get("result")

    # Coordinator lease API ------------------------------------------------
    def ping(self):
        return self._call("ping")

    def set_dataset(self, shards):
        return self._call("set_dataset", shards=shards)

    def get_task(self, epoch_limit: Optional[int] = None):
        d = self._call("get_task", epoch_limit=epoch_limit)
        return Task.from_json(d) if d is not None else None

    def task_finished(self, task_id: int, lease: Optional[int] = None):
        return self._call("task_finished", task_id=task_id, lease=lease)

    def task_failed(self, task_id: int, offset: Optional[int] = None,
                    lease: Optional[int] = None):
        return self._call("task_failed", task_id=task_id, offset=offset,
                          lease=lease)

    def task_progress(self, task_id: int, offset: int,
                      lease: Optional[int] = None):
        return self._call("task_progress", task_id=task_id, offset=offset,
                          lease=lease)

    def register_worker(self, worker_id: str, meta: Optional[dict] = None):
        return self._call("register_worker", worker_id=worker_id, meta=meta)

    def heartbeat(self, worker_id: str, step: Optional[int] = None):
        return self._call("heartbeat", worker_id=worker_id, step=step)

    def membership(self):
        return self._call("membership")

    def close(self):
        """Tear down the connection. Deliberately lock-free: taking _lock
        here would block shutdown for up to the full retry deadline
        behind an in-flight _call, and the transport already tolerates a
        torn connection — a raced _call attempt fails like a dropped
        wire and reconnects."""
        if self._file is not None:
            try:
                self._file.close()
            except OSError:
                pass
            self._file = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


class MasterClient(object):
    """Trainer-side iterator over coordinator tasks (reference
    go/master/client.go NextRecord / python master.client:29).

    `record_fn(payload)` maps a task payload to an iterable of records;
    records stream out while the lease is held, and the task is marked
    finished (or failed, on exception) automatically. A failure reports
    the per-task record offset (with the lease's fencing token), so a
    re-leased task skips the records already yielded instead of
    replaying them (offset-aware leases). `epoch_limit` permits epoch
    rollover up to that pass number (None: this pass only)."""

    def __init__(self, coordinator: Coordinator, record_fn,
                 epoch_limit: Optional[int] = None):
        self.coordinator = coordinator
        self.record_fn = record_fn
        self.epoch_limit = epoch_limit

    def __iter__(self):
        # one full pass over the dataset: no rollover into the next epoch
        # (the training loop drives passes; reference client.go pass_end)
        while True:
            task = self.coordinator.get_task(epoch_limit=self.epoch_limit)
            if task is None:
                return
            skip = getattr(task, "offset", 0)
            lease = getattr(task, "lease", None)
            delivered = 0
            try:
                for i, rec in enumerate(self.record_fn(task.payload)):
                    if i < skip:
                        continue  # delivered by a previous lease holder
                    yield rec
                    delivered += 1
            except Exception:
                self.coordinator.task_failed(task.task_id,
                                             offset=skip + delivered,
                                             lease=lease)
                continue
            self.coordinator.task_finished(task.task_id, lease=lease)

    def reader(self):
        """As a v2-style reader creator."""
        return lambda: iter(self)
