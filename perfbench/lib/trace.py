"""The traced slice: torch.profiler over a steady stretch of a run, read
back from its Chrome trace. Device operations are the trace's kernels,
copies and sets; the slice is the benchmark's own `perfbench.slice`
range, which ends in a sync. From them: the seconds in which an
operation ran on the card (`busy_s`, the union of their intervals), the
slice's length (`window_s`), device time by kernel name, and the idle
gaps labelled by the innermost host operation running when each began
(under the innermost named range around it)."""

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SLICE = "perfbench.slice"


def profile_slice(run_slice):
    """Profile `run_slice()` (which ends in a sync) and return its
    `Trace`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(SLICE):
            run_slice()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)


class Trace(object):
    def __init__(self, events):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        span = [e for e in xs if e.get("name") == SLICE
                and e.get("cat") == "user_annotation"][0]
        self.t0 = float(span["ts"])
        self.t1 = self.t0 + float(span["dur"])
        self.device = []
        for e in xs:
            if e.get("cat") in DEVICE_CATS:
                a = max(float(e["ts"]), self.t0)
                b = min(float(e["ts"]) + float(e["dur"]), self.t1)
                if b > a:
                    self.device.append((a, b, e["name"]))
        self.device.sort()
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"],
             e.get("cat"))
            for e in xs if e.get("cat") in HOST_CATS and e["name"] != SLICE)

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    def _merged(self):
        out = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self):
        return sum(b - a for a, b in self._merged()) / 1e6

    def device_s(self, match=None):
        """Device seconds of the operations whose name `match(name)`
        accepts (all without `match`)."""
        return sum(b - a for a, b, n in self.device
                   if match is None or match(n)) / 1e6

    def count(self, match=None):
        return sum(1 for _, _, n in self.device if match is None or match(n))

    def device_ops(self, top=10):
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        by = {}
        for a, b, n in self.device:
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return [[n[:160], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """[[what the host was doing, idle seconds]]: the slice's idle
        time on the card, summed by the host operation that was running
        when each gap began, largest first."""
        by = {}
        t = self.t0
        host, p, active = self.host, 0, []
        for a, b in self._merged() + [[self.t1, self.t1]]:
            if a > t:
                # the host operations running at t: started, not ended
                while p < len(host) and host[p][0] <= t:
                    active.append(host[p])
                    p += 1
                active = [h for h in active if h[1] > t]
                ops = [h for h in active if h[3] != "user_annotation"]
                rngs = [h for h in active if h[3] == "user_annotation"]
                label = max(ops)[2] if ops else "host between operations"
                if rngs:
                    label = "%s > %s" % (max(rngs)[2], label)
                by[label] = by.get(label, 0.0) + (a - t) / 1e6
            t = max(t, b)
        return [[n[:160], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]
