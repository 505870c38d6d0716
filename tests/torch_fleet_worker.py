"""Supervised serving-fleet replica SUBPROCESS of the port (driven by
tests/test_torch_fleet.py through
paddle_tpu_torch.serving.fleet.run_fleet_subprocess; the counterpart of
tests/fleet_worker.py).

N of these processes drain a Coordinator queue whose tasks are serving
requests (journal-form specs). Each runs the port's `ServingEngine` on
the CPU over weights read from a `save_weights` checkpoint the test
wrote, so every process serves the same model; `engine.step()` ticks the
PADDLE_FAULT injector, so `kill@N` SIGKILLs this process mid-decode. A
killed worker's lease times out and requeues to a survivor (or to its
restarted incarnation); `task_finished` presents the lease generation,
so a zombie's late ack is refused; results are written atomically per
request id.

Usage: torch_fleet_worker.py OUT_DIR COORD_ADDR
Env:   PADDLE_WORKER_ID      logical id (set by the Supervisor)
       PADDLE_FAULT          injected faults (stripped on restart)
       FLEET_MODEL           json {vocab,dim,heads,layers,max_len,
                             max_slots}
       FLEET_WEIGHTS         json {"dir": ckpt_dir, "step": step}
       FLEET_IDLE_GRACE_S    keep polling an empty queue this long
                             before exiting 0; must exceed the lease
                             timeout
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from paddle_tpu_torch.distributed import RemoteCoordinator
from paddle_tpu_torch.models import transformer as tlm
from paddle_tpu_torch.serving import ServingEngine, load_weights


def main():
    out_dir, addr = sys.argv[1:3]
    wid = os.environ.get("PADDLE_WORKER_ID", "w?")
    m = json.loads(os.environ["FLEET_MODEL"])
    w = json.loads(os.environ["FLEET_WEIGHTS"])
    idle_grace = float(os.environ.get("FLEET_IDLE_GRACE_S", "20.0"))

    cfg = tlm.TransformerConfig(
        vocab=m["vocab"], dim=m["dim"], heads=m["heads"],
        layers=m["layers"], max_len=m["max_len"])
    # the tree's shapes and dtypes; the values come from the checkpoint
    like = tlm.init_params(cfg, torch.Generator(), device="cpu")
    params = load_weights(like, w["dir"], w["step"])
    engine = ServingEngine(params, cfg, max_slots=m.get("max_slots", 2),
                           device="cpu")

    client = RemoteCoordinator(addr, retry_deadline_s=20.0,
                               backoff_base_s=0.05)
    incarnation = client.register_worker(wid)["incarnation"]

    last_beat = 0.0
    idle_since = None
    while True:
        now = time.time()
        if now - last_beat > 0.5:
            client.heartbeat(wid)
            last_beat = now
        task = client.get_task()
        if task is None:
            if idle_since is None:
                idle_since = now
            if now - idle_since > idle_grace:
                break  # queue drained AND any dead peer's lease expired
            time.sleep(0.05)
            continue
        idle_since = None
        spec = task.payload
        h = engine.submit(
            np.asarray(spec["prompt"], np.int32),
            spec["max_new_tokens"], temperature=spec["temperature"],
            eos_id=spec["eos_id"], seed=spec["seed"])
        while not h.done:
            engine.step()  # ticks PADDLE_FAULT: kill@N lands mid-decode
            now = time.time()
            if now - last_beat > 0.5:
                client.heartbeat(wid)
                last_beat = now
        rec = {"rid": spec["rid"],
               "tokens": [int(t) for t in h.tokens],
               "worker": wid, "incarnation": incarnation,
               "lease": task.lease}
        # result BEFORE ack: a crash in between re-leases the request
        # and the survivor overwrites with an identical record
        tmp = os.path.join(out_dir, ".tmp_%s_%d" % (wid, spec["rid"]))
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, os.path.join(out_dir, "%d.json" % spec["rid"]))
        client.task_finished(task.task_id, lease=task.lease)
    sys.exit(0)


if __name__ == "__main__":
    main()
