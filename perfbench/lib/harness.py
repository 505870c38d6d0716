"""One run of one cell: find it by name, set it up, measure it, read its
trace, judge its output, print the result line.

Everything a cell is made of is found by name, so that a cell, a
configuration, a traffic mix or a metric is added by new files and
BENCHMARK.json entries alone:

  BENCHMARK.json             the cell -> its config and traffic names;
                             the metrics, and the cells each is read in
  perfbench/configs/<c>.json the configuration's sizes (the file named
                             by its BENCHMARK.json entry)
  perfbench/traffic/<t>.json the traffic mix: the driver that runs it
                             and its parameters
  perfbench/workloads/<w>.json
                             the cell's limits on the numbers compared,
                             with the readings they were set from
  perfbench/drivers/<d>.py   `setup(cell)` -> a run (see `drivers/`)
  perfbench/metrics/<m>.py   `read(ctx)` -> the per-layer metric, or
                             None where the run has nothing to read

A run that finds no card, fewer cards than the cell asks for, or a JAX
module loaded once the window has closed exits with a code other than 0
and prints no result."""

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "perfbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "paddle_tpu")


class Cell(object):
    """A cell as found by name: its BENCHMARK.json entry, its
    configuration and traffic, its limits, the run's seed and device, and
    for the readings script its mode ("program", "control" or "bf16") and a
    planted fault."""

    def __init__(self, name, bench=None, seed=0, device="cuda",
                 mode="program", fault=None, config=None, traffic=None):
        bench = bench or load_benchmark()
        entry = _named(bench["workloads"], name, "workload")
        self.name, self.entry = name, entry
        self.chips = entry["chips"]
        self.config_entry = _named(bench["configs"], entry["config"],
                                   "config")
        self.config = config or _load(os.path.join(
            ROOT, self.config_entry["file"]))
        self.traffic = traffic or _load(os.path.join(
            BENCH, "traffic", entry["traffic"] + ".json"))
        path = os.path.join(BENCH, "workloads", name + ".json")
        self.limits = _load(path)["limits"] if os.path.exists(path) else {}
        self.seed, self.device = int(seed), device
        self.mode, self.fault = mode, fault
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def load_benchmark():
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError("no %s named %r in BENCHMARK.json" % (what, name))


def driver(cell):
    return importlib.import_module("perfbench.drivers."
                                   + cell.traffic["driver"])


def metric_reader(name):
    """The `read` function of perfbench/metrics/<name>.py."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is a JAX one or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class MetricContext(object):
    """What a per-layer reader reads: the driver's counters (program
    counters and the window's host-clock totals), the traced slice, and
    the run's cell."""

    def __init__(self, cell, counters, trace):
        self.cell, self.counters, self.trace = cell, counters, trace


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _chips_ok(cell):
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < cell.chips:
        return "%d cards, the cell asks for %d" % (
            torch.cuda.device_count(), cell.chips)
    return None


def _num(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def main(argv=None, t0=None, cell=None, need_card=True, out=None):
    """Run one cell and print its result line; the exit code. Tests pass
    `cell` (a small copy on the CPU) and `need_card=False`."""
    import torch

    t0 = time.monotonic() if t0 is None else t0
    out = out or sys.stdout
    args = parse(argv)
    cell = cell or Cell(args.workload, seed=args.seed)
    if need_card:
        why = _chips_ok(cell)
        if why:
            print("perfbench: no run: %s" % why, file=sys.stderr)
            return 2
    run = driver(cell).setup(cell)
    run.sync()
    setup_s = time.monotonic() - t0

    window = run.window(args.seconds)
    metrics = {}
    trace = None
    if args.trace:
        from . import trace as tr

        trace = tr.profile_slice(run.slice)
        ctx = MetricContext(cell, run.counters, trace)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    cuda = torch.device(cell.device).type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                    if cuda else 0)}
    if trace is not None:
        device["busy_s"] = trace.busy_s
        device["window_s"] = trace.window_s
    run.release()
    if cuda:
        torch.cuda.empty_cache()

    from . import compare

    readings = run.check()
    correct, rows = compare.judge(readings, cell.limits)
    found = forbidden_modules()
    if found:
        print("perfbench: no result: loaded %s" % ", ".join(found),
              file=sys.stderr)
        return 3
    result = {"correct": bool(correct and window.get("failed", 0) == 0),
              "attempted": window["attempted"], "failed": window["failed"],
              "metrics": metrics, "device": device}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["checks"] = {name: {"value": _num(r), "limit": lim}
                        for name, r, lim in rows}
    for name, r, lim in rows:
        print("check %s %r limit %r" % (name, r, lim), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
