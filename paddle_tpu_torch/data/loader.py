"""DataLoader: prefetching, resumable batch pipeline over a
ShardedDataset (counterpart of paddle_tpu/data/loader.py: the same
record stream, the same `state_dict()` JSON, so a cursor saved by either
package resumes in the other at the same record; only the device upload
differs).

The capability being rebuilt is the reference's second-generation input
path end to end (PAPER.md §Go cloud layer): the Go master leased
RecordIO chunks to trainers while the C++ DataProvider double-buffered
decode under compute. Here both live in one loader with modern idioms:

  - **prefetch threads** decode whole chunks off the training thread
    (`num_workers`; 0 = fully synchronous);
  - **ordered reassembly**: chunks decode in parallel but batches are
    assembled in plan order, so the delivered record stream is
    IDENTICAL for every `num_workers` — parallelism never changes what
    the model sees;
  - **bounded queue** (`prefetch_batches`) for backpressure, and
    optional `device_put=True` so the host->device transfer of batch
    k+1 overlaps the consumer's compute on batch k: the producer uploads
    each batch through `fluid.data_feeder.HostToDevice` (pinned memory,
    a side stream, an event), the upload AsyncDeviceFeeder takes, and
    the consumer's stream waits on the batch's event when `next()`
    hands it out;
  - **exact mid-epoch resume**: `state_dict()` is a
    (epoch, chunk cursor, record offset) position in the deterministic
    per-epoch shuffle; `load_state_dict()` re-enters at exactly the
    next undelivered record. It rides `distributed.checkpoint`'s
    `stateful=` hook, so a supervisor restart resumes the data stream
    with the model state;
  - **elastic multi-worker sharding** via `CoordinatedChunkSource`:
    chunks are leased from the `distributed.Coordinator` task queue
    (at-least-once, lease-timeout requeue) and every lease carries a
    committed record offset, so a re-leased chunk resumes where the
    previous holder's last `commit()` left it instead of replaying
    delivered records.

Exactly-once accounting (coordinated mode): completion acks and offset
progress are buffered per batch and flushed by `commit()` — call it
right after the trainer's checkpoint commits, so the coordinator's view
never runs ahead of durable state. Crash windows: uncommitted acks ride
in `state_dict()` and are re-flushed on resume (the supervisor_worker
`pending_ack` discipline); a lease that expired anyway requeues with
the committed offset, so the next holder — the resumed victim or a
peer — continues without replaying committed records. Every lease
carries a **generation (fencing token)**: a zombie holder's
progress/finish/fail calls against a re-issued lease are refused by the
server, and `commit()` surfaces the refusal as `LeaseLost` (poisoning
the iteration) instead of silently double-delivering. The residual
window: batches a zombie delivered — and its trainer
checkpointed — between its lease expiring and its next commit() are
also re-delivered by the new holder; on `LeaseLost` restart from the
checkpoint BEFORE the refused batch, or size lease timeouts above the
worst-case checkpoint+commit interval so the window never opens.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from .dataset import ShardedDataset
from .metrics import DataMetrics

__all__ = ["DataLoader", "LocalChunkSource", "CoordinatedChunkSource",
           "LeaseLost", "default_collate"]


class LeaseLost(RuntimeError):
    """The in-flight chunk's coordinator lease expired and was requeued:
    records past the last committed offset may be delivered by another
    worker. The iteration is poisoned; restart it from the last
    checkpoint (whose state no longer claims the lease)."""


class _Plan(object):
    """One chunk scheduled for delivery. `lease` is the coordinator's
    lease generation (fencing token): every ack/progress call presents
    it, so a zombie holder can never touch a re-issued lease."""

    __slots__ = ("chunk_index", "epoch", "skip", "task_id", "pos",
                 "records", "lease")

    def __init__(self, chunk_index, epoch, skip, task_id, pos, records,
                 lease=None):
        self.chunk_index = chunk_index
        self.epoch = epoch
        self.skip = skip
        self.task_id = task_id
        self.pos = pos
        self.records = records
        self.lease = lease


class LocalChunkSource(object):
    """Single-worker plan: the dataset's deterministic per-epoch chunk
    permutation, re-enterable at any (cursor, offset)."""

    mode = "local"

    def plans(self, dataset: ShardedDataset, epoch: int, pos: int,
              offset: int, inflight):
        order = dataset.epoch_order(epoch)
        for i in range(pos, len(order)):
            skip = offset if i == pos else 0
            ci = order[i]
            if dataset.is_quarantined(ci):
                continue  # sentinel-quarantined: never delivered again
            n = dataset.chunks[ci].records
            if skip >= n:
                continue  # resumed exactly at this chunk's end
            yield _Plan(ci, epoch, skip, None, i, n)

    def finish(self, task_id, lease=None):  # no queue to ack
        pass

    def progress(self, task_id, offset, lease=None):
        return True


class CoordinatedChunkSource(object):
    """Elastic multi-worker plan: chunks leased from a
    `distributed.Coordinator` (in-process or RemoteCoordinator — same
    API). `idle_grace_s` keeps polling an apparently-empty queue so a
    dead peer's lease can time out and requeue to us (set it past the
    coordinator's lease timeout in fault-tolerant jobs)."""

    mode = "coordinated"

    # plans() yields None while the queue is empty and the idle grace
    # runs: "no plan now, ask again". The loader then delivers the chunks
    # it has in flight rather than block on the source; the JAX package's
    # loader holds them until the idle grace ends (ROADMAP Queue C).

    def __init__(self, coordinator, idle_grace_s: float = 0.0,
                 poll_s: float = 0.1):
        self.coordinator = coordinator
        self.idle_grace_s = idle_grace_s
        self.poll_s = poll_s
        # leases this source holds whose records are still upstream of
        # the consumer (decoded/buffered but not yet delivered+acked),
        # task_id -> lease generation. Idle waits renew them
        # (task_progress doubles as a keepalive — offset 0 can never
        # lower the server's committed offset), so a tail wait for a
        # dead peer's requeue cannot starve our own leases into expiry.
        # Size lease timeouts to cover the decode lookahead (~2x
        # num_workers chunks) regardless.
        self._held = {}

    def publish(self, dataset: ShardedDataset):
        """Register the dataset's chunks as the shared task queue. Call
        ONCE per job (set_dataset is idempotent only while the queue is
        non-empty)."""
        self.coordinator.set_dataset(dataset.payloads())

    def plans(self, dataset: ShardedDataset, epoch: int, pos: int,
              offset: int, inflight):
        if inflight is not None:
            # reclaim our checkpointed lease first: deliver the rest of
            # the chunk from the committed offset
            ci = int(inflight["chunk"])
            if dataset.is_quarantined(ci):
                # quarantined since the checkpoint was taken (sentinel
                # rollback): never deliver its tail — ack so the queue
                # drains (every holder reads the same journal, so the
                # decision is identical fleet-wide)
                self.coordinator.task_finished(
                    inflight["task_id"], lease=inflight.get("lease"))
            else:
                self._held[inflight["task_id"]] = inflight.get("lease")
                yield _Plan(ci, int(inflight["epoch"]),
                            int(inflight["offset"]), inflight["task_id"],
                            -1, dataset.chunks[ci].records,
                            lease=inflight.get("lease"))
        idle_since = None
        while True:
            task = self.coordinator.get_task(epoch_limit=epoch)
            if task is None:
                if self.idle_grace_s <= 0:
                    return
                if idle_since is None:
                    idle_since = time.monotonic()
                if time.monotonic() - idle_since > self.idle_grace_s:
                    return
                for tid, lease in list(self._held.items()):
                    # keepalive, see __init__
                    self.coordinator.task_progress(tid, 0, lease=lease)
                yield None  # see the class comment
                time.sleep(self.poll_s)
                continue
            idle_since = None
            if task.task_id in self._held:
                # our own lease expired and came back while its records
                # are still buffered: delivering it again would
                # duplicate them. Loud failure beats silent corruption —
                # the config needs a longer lease timeout.
                raise LeaseLost(
                    "task %d re-leased to this worker while still held "
                    "(lease timeout shorter than the decode pipeline)"
                    % task.task_id)
            ci = int(task.payload["chunk"])
            skip = int(getattr(task, "offset", 0))
            n = dataset.chunks[ci].records
            lease = getattr(task, "lease", None)
            if dataset.is_quarantined(ci):
                # sentinel-quarantined chunk leased to us: never deliver
                # it; finish the lease so the pass can still drain
                self.coordinator.task_finished(task.task_id, lease=lease)
                continue
            if skip >= n:
                # a previous holder delivered (and committed) the whole
                # chunk but its finish ack was lost: nothing to deliver
                self.coordinator.task_finished(task.task_id, lease=lease)
                continue
            self._held[task.task_id] = lease
            yield _Plan(ci, task.epoch, skip, task.task_id, -1, n,
                        lease=lease)

    def abort(self):
        """The loader dropped any buffered chunks (iteration abort):
        orphaned leases simply expire and requeue at their committed
        offsets — forget them so a later requeue is not misread as a
        duplicate-delivery hazard."""
        self._held.clear()

    def finish(self, task_id, lease=None):
        self._held.pop(task_id, None)
        self.coordinator.task_finished(task_id, lease=lease)

    def progress(self, task_id, offset, lease=None):
        r = self.coordinator.task_progress(task_id, offset, lease=lease)
        return bool(r.get("held")) if isinstance(r, dict) else True


def default_collate(items):
    """Stack a batch: arrays stack along a new axis, tuples/lists/dicts
    collate per field, numbers become arrays, anything else stays a
    list."""
    first = items[0]
    if isinstance(first, np.ndarray):
        return np.stack(items)
    if isinstance(first, tuple):
        return tuple(default_collate([it[i] for it in items])
                     for i in range(len(first)))
    if isinstance(first, list):
        return [default_collate([it[i] for it in items])
                for i in range(len(first))]
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (int, float, np.integer, np.floating, bool)):
        return np.asarray(items)
    return list(items)


class _EndOfEpoch(Exception):
    pass


class DataLoader(object):
    """Iterate batches; one `iter()` pass = one epoch (resuming from the
    current cursor, so `break` + re-`iter()` continues mid-epoch).

    Arguments:
      dataset            ShardedDataset (decode_fn applies per record)
      batch_size         records per delivered batch
      source             LocalChunkSource (default) or
                         CoordinatedChunkSource
      num_workers        chunk-decode threads; 0 = synchronous inline
      prefetch_batches   bounded batch queue depth (backpressure)
      collate_fn         batch assembly; default stacks per field; pass
                         `list` for raw row lists (DataFeeder.feed rows)
      device_put         upload each batch on the producer side (h2d of
                         batch k+1 overlaps compute on batch k); batches
                         come out as tensors on `place`
      place              where device_put puts batches: the card unless
                         the caller passes CPUPlace() (CPU tensors);
                         with no card and no CPUPlace() the constructor
                         raises
      drop_last          drop the epoch's final partial batch
      auto_commit        flush coordinator acks on every batch (True);
                         checkpointing trainers set False and call
                         commit() after their checkpoint commits, plus
                         once after the epoch ends (trailing completion
                         acks for chunks whose records all rode earlier
                         batches surface at epoch end)
    """

    def __init__(self, dataset: ShardedDataset, batch_size: int,
                 source=None, num_workers: int = 2,
                 prefetch_batches: int = 4, collate_fn=default_collate,
                 device_put: bool = False, drop_last: bool = False,
                 auto_commit: bool = True, place=None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.source = source if source is not None else LocalChunkSource()
        self.num_workers = int(num_workers)
        self.prefetch_batches = max(1, int(prefetch_batches))
        self.collate_fn = collate_fn if collate_fn is not None else list
        self.device_put = device_put
        self._h2d = None
        if device_put:
            from ..fluid import core
            from ..fluid.data_feeder import HostToDevice

            self._h2d = HostToDevice(core.place_device(place))
        self.drop_last = drop_last
        self.auto_commit = auto_commit
        self.metrics = DataMetrics()
        # cursor (captured by state_dict at batch boundaries). The
        # whole cursor is CONSUMER-thread state: the producer thread
        # communicates through the bounded queue only and never touches
        # it ('# thread: producer' methods must not mutate these).
        self._epoch = 0        # guarded-by: consumer
        self._pos = 0          # guarded-by: consumer
        self._offset = 0       # guarded-by: consumer
        self._inflight = None  # guarded-by: consumer
        self._records_epoch = 0   # guarded-by: consumer
        self._batches_total = 0   # guarded-by: consumer
        # uncommitted coordinator acks (flushed by commit())
        self._pending_finish = []       # guarded-by: consumer
        self._pending_progress = None   # guarded-by: consumer
        self._batches_since_load = 0    # guarded-by: consumer
        self._lease_lost = False        # guarded-by: consumer
        self._exhausted = False         # guarded-by: consumer
        # iteration machinery (consumer-owned: the producer receives
        # q/stop as call arguments and only READS self._pool to submit
        # decodes; the consumer replaces/tears down _pool only after
        # joining the producer — a producer outliving the 5 s join
        # deadline in _abort_iteration is abandoned, not raced)
        self._pool = None      # guarded-by: consumer
        # inline generator (num_workers == 0)
        self._gen = None       # guarded-by: consumer
        self._q = None         # guarded-by: consumer
        self._thread = None    # guarded-by: consumer
        self._stop = None      # guarded-by: consumer

    # --- epoch / cursor ------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._epoch

    def state_dict(self) -> dict:
        """JSON-serializable cursor: everything needed to re-enter the
        record stream at exactly the next undelivered record (plus any
        coordinator acks not yet flushed, re-flushed on resume)."""
        return {
            "version": 1,
            "mode": self.source.mode,
            "epoch": self._epoch,
            "pos": self._pos,
            "offset": self._offset,
            "inflight": dict(self._inflight) if self._inflight else None,
            "records_epoch": self._records_epoch,
            "batches_total": self._batches_total,
            "pending": {
                "finish": list(self._pending_finish),
                "progress": dict(self._pending_progress)
                if self._pending_progress else None,
            },
        }

    def load_state_dict(self, state: dict):
        if state.get("mode") != self.source.mode:
            raise ValueError(
                "loader state has mode %r but the source is %r"
                % (state.get("mode"), self.source.mode))
        self._abort_iteration()
        self._epoch = int(state["epoch"])
        self._pos = int(state["pos"])
        self._offset = int(state["offset"])
        self._inflight = (dict(state["inflight"])
                          if state.get("inflight") else None)
        self._records_epoch = int(state.get("records_epoch", 0))
        self._batches_total = int(state.get("batches_total", 0))
        pending = state.get("pending") or {}
        self._pending_finish = list(pending.get("finish") or [])
        self._pending_progress = (dict(pending["progress"])
                                  if pending.get("progress") else None)
        self._batches_since_load = 0
        self._lease_lost = False
        self._exhausted = False

    # --- iteration -----------------------------------------------------
    def __iter__(self):
        self._abort_iteration()
        self._exhausted = False
        self._start_iteration()
        return self

    def _start_iteration(self):
        epoch, pos, offset = self._epoch, self._pos, self._offset
        inflight = dict(self._inflight) if self._inflight else None
        if self.num_workers == 0:
            self._gen = self._assemble(
                epoch, pos, offset,
                ((p, self._load_plan(p)) for p in self.source.plans(
                    self.dataset, epoch, pos, offset, inflight)
                 if p is not None))
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="ptpu-data")
        self._q = queue.Queue(maxsize=self.prefetch_batches)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce,
            args=(epoch, pos, offset, inflight, self._q, self._stop),
            daemon=True)
        self._thread.start()

    def _abort_iteration(self):
        if self._stop is not None:
            self._stop.set()
        if self._q is not None:
            try:  # unblock a producer parked in put()
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._gen = None
        self._q = None
        self._thread = None
        self._stop = None
        abort = getattr(self.source, "abort", None)
        if abort is not None:
            abort()

    def close(self):
        self._abort_iteration()
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _load_plan(self, plan: _Plan):
        return self.dataset.load_chunk(plan.chunk_index, epoch=plan.epoch,
                                       skip=plan.skip)

    def _pipelined_chunks(self, plans, stop):  # thread: producer
        """(plan, items) with up to ~2x num_workers chunk decodes in
        flight, results consumed strictly in plan order — parallel
        decode, deterministic delivery."""
        lookahead = max(2, self.num_workers * 2)
        pending = collections.deque()
        it = iter(plans)
        exhausted = False
        while True:
            while (not exhausted and len(pending) < lookahead
                   and not stop.is_set()):
                try:
                    p = next(it)
                except StopIteration:
                    exhausted = True
                    break
                if p is None:  # the source has no plan yet
                    if pending:
                        break  # deliver what is in flight meanwhile
                    continue
                pending.append((p, self._pool.submit(self._load_plan, p)))
            if not pending or stop.is_set():
                return
            p, fut = pending.popleft()
            yield p, fut.result()

    def _assemble(self, epoch, pos, offset, chunks):
        """Slice an in-order (plan, items) stream into batches, tracking
        the exact after-batch cursor. Yields ("batch", payload, meta)."""
        buf = []
        finished = []
        cur = None

        def emit():
            payload = self.collate_fn(list(buf))
            ready = None
            if self._h2d is not None:
                payload, ready = self._h2d.upload(payload)
            meta = {
                "pos": pos,
                "offset": offset,
                "finished": [[p.task_id, p.lease] for p in finished
                             if p.task_id is not None],
                "inflight": (
                    {"task_id": cur.task_id, "chunk": cur.chunk_index,
                     "epoch": cur.epoch, "offset": offset,
                     "lease": cur.lease}
                    if cur is not None and cur.task_id is not None
                    else None),
                "n": len(buf),
                "ready": ready,
            }
            del buf[:]
            del finished[:]
            return ("batch", payload, meta)

        for plan, items in chunks:
            cur = plan
            # sync the cursor to the chunk actually being consumed: a
            # resume whose offset landed exactly on a chunk boundary
            # starts at plan.pos > pos (the boundary chunk was skipped),
            # and stamping batches with the stale pos would make a
            # SECOND resume replay this chunk
            if plan.pos >= 0:
                pos = plan.pos
            offset = plan.skip
            for item in items:
                buf.append(item)
                offset += 1
                if len(buf) == self.batch_size:
                    yield emit()
            finished.append(plan)
            cur = None
            pos = plan.pos + 1 if plan.pos >= 0 else pos
            offset = 0
        if buf and not self.drop_last:
            yield emit()
        elif finished:
            # acks for trailing chunks whose records all landed in
            # already-emitted batches (or were dropped by drop_last)
            yield ("acks", None, {
                "pos": pos, "offset": 0,
                "finished": [[p.task_id, p.lease] for p in finished
                             if p.task_id is not None],
                "inflight": None, "n": 0})

    def _produce(self, epoch, pos, offset, inflight, q, stop):  # thread: producer
        try:
            plans = self.source.plans(self.dataset, epoch, pos, offset,
                                      inflight)
            for ev in self._assemble(
                    epoch, pos, offset,
                    self._pipelined_chunks(plans, stop)):
                if not _put_stoppable(q, ev, stop):
                    return
            _put_stoppable(q, ("end", None, None), stop)
        except BaseException as e:  # surfaced at the consumer
            _put_stoppable(q, ("error", e, None), stop)

    def __next__(self):
        if self._lease_lost:
            raise LeaseLost(
                "the in-flight chunk lease was lost; restart iteration "
                "from the last checkpoint")
        if self._exhausted:
            # an exhausted iterator stays exhausted (iterator protocol);
            # only iter() starts the next epoch
            raise StopIteration
        if self._gen is None and self._q is None:
            self._start_iteration()
        t0 = time.monotonic()
        while True:
            if self.num_workers == 0:
                try:
                    kind, payload, meta = next(self._gen)
                except StopIteration:
                    kind, payload, meta = "end", None, None
                except BaseException:
                    # mirror the threaded error path: abort so the dead
                    # generator cannot masquerade as a clean epoch end
                    # on a retried next() (cursor intact — a retry
                    # resumes from the last delivered batch)
                    self._abort_iteration()
                    raise
                depth = 0
            else:
                depth = self._q.qsize()
                kind, payload, meta = self._q.get()
            if kind == "error":
                self._abort_iteration()
                raise payload
            if kind == "end":
                self._end_epoch()
                raise StopIteration
            # batch or trailing acks: apply the cursor + pending acks
            self._pos = meta["pos"]
            self._offset = meta["offset"]
            self._inflight = meta["inflight"]
            self._pending_finish.extend(meta["finished"])
            self._pending_progress = (dict(meta["inflight"])
                                      if meta["inflight"] else None)
            if kind == "acks":
                if self.auto_commit:
                    self.commit()
                continue  # not a consumer-visible batch
            self._records_epoch += meta["n"]
            self._batches_total += 1
            self._batches_since_load += 1
            self.metrics.batch_delivered(
                meta["n"], time.monotonic() - t0, depth)
            if self.auto_commit:
                self.commit()
            if self._h2d is not None:
                payload = self._h2d.take(payload, meta["ready"])
            return payload

    def _end_epoch(self):
        # the producer ended the epoch; trailing acks (if any) were
        # delivered as an "acks" event before the end sentinel
        self._gen = None
        self._q = None
        self._thread = None
        self._stop = None
        self._epoch += 1
        self._pos = 0
        self._offset = 0
        self._inflight = None
        self._records_epoch = 0
        self._exhausted = True
        self.metrics.epoch_completed()

    # --- coordinator transaction boundary ------------------------------
    def commit(self) -> bool:
        """Flush buffered completion acks and offset progress to the
        chunk source. Call after the trainer's checkpoint commits (or
        leave auto_commit=True when there is no checkpoint to sync
        with). Returns False when the in-flight lease is gone — the
        loader drops it and aborts any running producer (which may have
        already reclaimed the lost lease's plan); if batches were
        already delivered this incarnation the iteration is poisoned
        (next() raises LeaseLost), otherwise (resume-time re-flush) the
        next iteration simply starts without the reclaimed chunk."""
        for tid, lease in self._pending_finish:
            self.source.finish(tid, lease)
        self._pending_finish = []
        prog = self._pending_progress
        self._pending_progress = None
        if prog is None:
            return True
        if self.source.progress(prog["task_id"], prog["offset"],
                                prog.get("lease")):
            return True
        self._inflight = None
        self._abort_iteration()  # the producer may hold the dead plan
        if self._batches_since_load > 0:
            self._lease_lost = True
        return False


def _put_stoppable(q, item, stop) -> bool:
    """put() that a consumer-side stop can always unblock."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False
