"""Supervised input-pipeline drill worker on the port (driven by
tests/test_torch_data_drill.py; the port's twin of tests/data_worker.py,
on the CPU, importing neither jax nor the JAX package).

Workers drain ONE coordinator chunk queue through the port's DataLoader
(CoordinatedChunkSource), recording every delivered record id. The
job-level deliverable is the multiset of record ids across all workers'
histories: it must equal the dataset exactly, whichever worker was
killed when.

Per batch (the fault injector ticks at the batch boundary, so kill@N
lands after batch N's delivery and before its checkpoint):

    next(loader) -> tick -> heartbeat -> accumulate history ->
    checkpoint (the loader cursor rides in `stateful`, the history in
    `extra`) -> loader.commit()  (acks flushed after the checkpoint)

Usage: torch_data_worker.py OUT_JSON CKPT_DIR COORD_ADDR SHARD_DIR
Env:   PADDLE_WORKER_ID   logical id (set by the Supervisor)
       PADDLE_FAULT       injected faults, e.g. kill@N
       DATA_BATCH         batch size (default 6)
       DATA_SEED          dataset shuffle seed (default 11)
       DATA_WORKERS       the loader's decode threads (default 2)
       DATA_IDLE_GRACE_S  loader idle grace (default 8; must exceed the
                          coordinator lease timeout)
       DATA_STEP_SLEEP    extra seconds per batch (default 0.02)
       DATA_PEERS         workers of the job: each waits until that many
                          have registered before it leases (default 1),
                          so a slow start cannot leave it no work
"""

import glob
import json
import os
import pickle
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from paddle_tpu_torch.data import (CoordinatedChunkSource, DataLoader,
                                   ShardedDataset)
from paddle_tpu_torch.distributed import (RemoteCoordinator,
                                          checkpoint as ckpt,
                                          fault_injection as fi)


class _Scope(dict):
    def get(self, name):
        return dict.get(self, name)

    def set(self, name, value):
        self[name] = value


def main():
    out_path, ckpt_dir, addr, shard_dir = sys.argv[1:5]
    wid = os.environ.get("PADDLE_WORKER_ID", "w?")
    batch = int(os.environ.get("DATA_BATCH", "6"))
    seed = int(os.environ.get("DATA_SEED", "11"))
    workers = int(os.environ.get("DATA_WORKERS", "2"))
    idle_grace = float(os.environ.get("DATA_IDLE_GRACE_S", "8.0"))
    step_sleep = float(os.environ.get("DATA_STEP_SLEEP", "0.02"))

    shard_paths = sorted(glob.glob(os.path.join(shard_dir, "*.rs")))
    dataset = ShardedDataset(shard_paths, decode_fn=pickle.loads, seed=seed)
    client = RemoteCoordinator(addr, retry_deadline_s=20.0,
                               backoff_base_s=0.05)
    client.register_worker(wid, meta={"restart_reason": os.environ.get(
        "PADDLE_RESTART_REASON", "none")})
    peers = int(os.environ.get("DATA_PEERS", "1"))
    while len(client.membership()) < peers:
        time.sleep(0.05)
    injector = fi.default_injector()
    loader = DataLoader(
        dataset, batch_size=batch,
        source=CoordinatedChunkSource(client, idle_grace_s=idle_grace,
                                      poll_s=0.1),
        num_workers=workers, auto_commit=False)

    scope = _Scope()
    meta = ckpt.resume_or_init(scope, ckpt_dir, stateful={"loader": loader})
    if meta is not None:
        resumed_from = step = int(meta["extra"]["step"])
        history = list(meta["extra"]["history"])
        loader.commit()  # re-flush acks the crash may have cut off
    else:
        resumed_from, step, history = None, 0, []
        scope.set("acc", np.zeros((1,), np.float64))

    for ids, _vals in loader:
        injector.tick()
        client.heartbeat(wid, step=step)
        if step_sleep:
            time.sleep(step_sleep)
        history.extend(int(i) for i in ids.tolist())
        step += 1
        scope.set("acc", scope.get("acc") + float(np.sum(ids)))
        ckpt.save_checkpoint(
            scope, ckpt_dir, step=step,
            extra={"step": step, "history": history, "worker": wid},
            stateful={"loader": loader}, keep_last=2)
        loader.commit()
    loader.commit()  # trailing completion acks surface at epoch end
    client.heartbeat(wid, step=step)
    loader.close()
    client.close()

    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"worker": wid, "resumed_from": resumed_from,
                   "steps_done": step, "history": history,
                   "restart_count": int(os.environ.get(
                       "PADDLE_RESTART_COUNT", "0")),
                   "modules": sorted(m for m in sys.modules
                                     if m.split(".")[0] in
                                     ("jax", "jaxlib", "paddle_tpu"))}, f)
    os.replace(tmp, out_path)


if __name__ == "__main__":
    main()
