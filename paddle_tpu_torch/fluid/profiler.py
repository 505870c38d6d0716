"""Profiler (counterpart of paddle_tpu/fluid/profiler.py; reference
python/paddle/v2/fluid/profiler.py:33 cuda_profiler, :76 profiler; C++
platform/profiler.cc RecordEvent/EnableProfiler:142, ParseEvents:198).

* A per-op COST TABLE (reference ParseEvents parity): inside a
  ``with profiler(...)`` block every executor run times each op of the
  forward region — CUDA events around the op on the card, the host
  clock on the CPU — and a training program's backward and optimizer
  update as one row ("backward+update"), in the same run, so training
  semantics are unchanged. On exit the sorted table prints and is
  available through ``last_profile()``: rows {'Event', 'Calls',
  'Total', 'Min', 'Max', 'Ave'}, times in ms.
* ``trace_profile`` measures per-op device time with torch.profiler
  from the ``record_function("fluid/op/<type>")`` range every op runs
  in, and reconciles it with an attribution modelled from the bytes
  each op reads and writes (and the FLOPs of its convolutions and
  GEMMs); ``compiled_profile`` gives the table with a timed step split
  by that model.
* ``cuda_profiler`` drives ``torch.cuda.profiler`` (cudaProfilerStart /
  Stop) around the block; ``device_memory_stats`` reads
  ``torch.cuda.memory_stats``; ``OpCounter`` counts (and brackets) the
  calls of chosen op kernels.

The JAX package's HLO-text parsers (``parse_hlo_op_costs``,
``parse_hlo_instr_tags``, ``_instr_flops``) read XLA's scheduled HLO,
which an eager torch program does not have; the port has no
counterpart of them. Its model counts each op's tensors as they run.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch
from torch.profiler import record_function

from .core.lowering import BACKWARD_ROW

__all__ = [
    "cuda_profiler", "reset_profiler", "profiler", "record_event",
    "get_events", "last_profile", "active_op_collector",
    "device_memory_stats", "compiled_profile", "trace_profile",
    "OpCounter",
]

_events = []
_last_profile = []
_active_collector = None
_active_hook = None  # trace_profile's model or ranges hook, while it runs

RANGE_PREFIX = "fluid/op/"


class OpCostCollector(object):
    """op type -> (calls, total, min, max) seconds."""

    def __init__(self):
        self.rows = {}

    def record(self, op_type: str, seconds: float):
        row = self.rows.get(op_type)
        if row is None:
            self.rows[op_type] = [1, seconds, seconds, seconds]
        else:
            row[0] += 1
            row[1] += seconds
            row[2] = min(row[2], seconds)
            row[3] = max(row[3], seconds)

    def table(self, sorted_key=None):
        """[{Event, Calls, Total, Min, Max, Ave}] in ms, sorted like the
        reference (profiler.py sorted_key in calls/total/max/min/ave)."""
        out = [{"Event": op, "Calls": calls, "Total": total * 1e3,
                "Min": mn * 1e3, "Max": mx * 1e3,
                "Ave": total / calls * 1e3}
               for op, (calls, total, mn, mx) in self.rows.items()]
        key = {"calls": "Calls", "total": "Total", "max": "Max",
               "min": "Min", "ave": "Ave"}.get(sorted_key)
        if key:
            out.sort(key=lambda r: r[key], reverse=True)
        return out


class _OpTimer(object):
    """The executor's per-op hook inside `profiler()`: each call brackets
    one op (or the backward+update row) with a profiler range and, on
    the card, a pair of CUDA events on the current stream, read at
    `flush()` after the run; on the CPU with the host clock."""

    def __init__(self, collector, device):
        self.collector = collector
        self.cuda = torch.device(device).type == "cuda"
        self.pending = []

    @contextlib.contextmanager
    def __call__(self, name, op=None, env=None):
        with record_function(RANGE_PREFIX + name):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                try:
                    yield
                finally:
                    end.record()
                    self.pending.append((name, start, end))
            else:
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    self.collector.record(name, time.perf_counter() - t0)

    def flush(self):
        if self.pending:
            self.pending[-1][2].synchronize()
        for name, start, end in self.pending:
            self.collector.record(name, start.elapsed_time(end) / 1e3)
        self.pending = []


def active_hook(device):
    """The per-op hook the executor passes to the lowering for one run:
    the op timer while `profiler()` is active, trace_profile's hook
    while it runs, else None."""
    if _active_collector is not None:
        return _OpTimer(_active_collector, device)
    return _active_hook


@contextlib.contextmanager
def _hooked(hook):
    """Every executor run in the block passes `hook` to the lowering."""
    global _active_collector, _active_hook
    prev = _active_collector, _active_hook
    _active_collector, _active_hook = None, hook
    try:
        yield hook
    finally:
        _active_collector, _active_hook = prev


def active_op_collector():
    """The executor checks this each run; non-None makes it time its
    ops into the collector."""
    return _active_collector


def last_profile():
    """The table from the most recent profiler() block."""
    return list(_last_profile)


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """Reference fluid.profiler.cuda_profiler: brackets the block with
    torch.cuda.profiler (cudaProfilerStart / Stop, for an external
    profiler attached to the process) and prints the per-op table as
    `profiler()` does. `output_file`, `output_mode` and `config`
    configured nvprof in the reference; an attached profiler takes its
    own settings."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.profiler.start()
    try:
        with profiler("All"):
            yield
    finally:
        if cuda:
            torch.cuda.profiler.stop()


def reset_profiler():
    _events.clear()
    del _last_profile[:]


def _print_table(table, elapsed, place):
    print("\n------------------------->     Profiling Report     "
          "<-------------------------\n")
    print("Place: %s    Total time span: %.4fs" % (place, elapsed))
    print("%-32s %8s %12s %12s %12s %12s" % (
        "Event", "Calls", "Total(ms)", "Min(ms)", "Max(ms)", "Ave(ms)"))
    for r in table:
        print("%-32s %8d %12.4f %12.4f %12.4f %12.4f" % (
            r["Event"][:32], r["Calls"], r["Total"], r["Min"], r["Max"],
            r["Ave"]))


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path=None):
    """Reference fluid.profiler.profiler parity: times every executor run
    in the block per op and prints the sorted cost table on exit.
    `profile_path` is accepted for the API's sake; the port writes no
    trace there (`trace_profile` reads a device trace)."""
    global _active_collector
    if state not in ["CPU", "GPU", "All", "TPU"]:
        raise ValueError("state must be 'CPU', 'GPU', 'TPU' or 'All'")
    if sorted_key not in (None, "default", "calls", "total", "max", "min",
                          "ave"):
        raise ValueError("unsupported sorted_key %r" % sorted_key)
    prev = _active_collector
    collector = OpCostCollector()
    _active_collector = collector
    t0 = time.time()
    try:
        yield
    finally:
        elapsed = time.time() - t0
        _active_collector = prev
        _events.append(("profiler_span", elapsed))
        table = collector.table(
            sorted_key if sorted_key != "default" else None)
        del _last_profile[:]
        _last_profile.extend(table)
        _print_table(table, elapsed,
                     "GPU" if torch.cuda.is_available() else "CPU")


@contextlib.contextmanager
def record_event(name):
    """RAII timing (reference platform/profiler.h RecordEvent); also a
    torch.profiler range of that name."""
    t0 = time.time()
    try:
        with record_function(name):
            yield
    finally:
        _events.append((name, time.time() - t0))


def get_events():
    return list(_events)


def device_memory_stats(device=None):
    """The card's allocator counters (torch.cuda.memory_stats: bytes in
    use, peaks, allocation counts, ...) — the observability the
    reference exposed through its allocator stats. {} on the CPU, as
    the JAX package returns on its CPU fixture."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return {}
    if dev is None and not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(dev))


class OpCounter(object):
    """Counts the calls of some op kernels (and, with `ranges`, wraps
    each in a torch.profiler range "fluid/op/<type>") while active::

        with OpCounter(["lrn"]) as c:
            exe.run(...)
        c.counts["lrn"]
    """

    def __init__(self, types, ranges=False):
        from .core import registry

        self.registry, self.types, self.ranges = registry, types, ranges
        self.counts = dict.fromkeys(types, 0)

    def __enter__(self):
        self.saved = {t: self.registry._KERNELS[t] for t in self.types}
        for t, fn in self.saved.items():
            def wrapped(ctx, ins, attrs, _t=t, _fn=fn):
                self.counts[_t] += 1
                if not self.ranges:
                    return _fn(ctx, ins, attrs)
                with record_function(RANGE_PREFIX + _t):
                    return _fn(ctx, ins, attrs)
            self.registry._KERNELS[t] = wrapped
        return self

    def __exit__(self, *exc):
        self.registry._KERNELS.update(self.saved)


# ---------------------------------------------------------------------
# the traffic model: bytes each op reads and writes, and the FLOPs of
# its convolutions and GEMMs, weighted by the card's roofline
# ---------------------------------------------------------------------

# H100 SXM: dense bf16 989 TFLOP/s, f32 (no TF32) 67 TFLOP/s, HBM3
# 3.35 TB/s — FLOPs per byte at the ridge; only the ratios enter the
# modelled shares
RIDGE_FLOPS_PER_BYTE = {torch.bfloat16: 989e12 / 3.35e12,
                        torch.float16: 989e12 / 3.35e12}
RIDGE_F32 = 67e12 / 3.35e12

_CONVS = ("conv2d", "depthwise_conv2d", "conv3d")
_CONV_T = ("conv2d_transpose", "conv3d_transpose")


def _tensors(env, names):
    return [v for v in (env.get(n) for n in names)
            if isinstance(v, torch.Tensor)]


def _flops(op, env):
    """FLOPs of one convolution or GEMM op (0 for the others)."""
    if op.type in _CONVS + _CONV_T:
        x, w = env.get(op.input("Input")[0]), env.get(op.input("Filter")[0])
        out = env.get(op.output("Output")[0])
        if not all(isinstance(t, torch.Tensor) for t in (x, w, out)):
            return 0.0
        per = math.prod(w.shape[1:])
        return 2.0 * (x.numel() if op.type in _CONV_T else out.numel()) * per
    if op.type in ("mul", "matmul"):
        x, y = env.get(op.input("X")[0]), env.get(op.input("Y")[0])
        out = env.get(op.output("Out")[0])
        if not all(isinstance(t, torch.Tensor) for t in (x, y, out)):
            return 0.0
        if op.type == "mul":
            k = math.prod(y.shape[:int(op.attrs.get("y_num_col_dims", 1))])
        else:
            k = x.shape[-2] if op.attrs.get("transpose_X") else x.shape[-1]
        return 2.0 * out.numel() * k
    return 0.0


class _TrafficModel(object):
    """A lowering hook (the op timer's interface) that records, per op
    type of the forward region: calls, bytes read and written, FLOPs and
    the roofline weight teq = max(bytes, FLOPs / ridge) in
    byte-equivalents. The backward+update row is modelled as twice the
    forward's weight (a backward pass computes the gradients of the
    inputs and of the weights)."""

    def __init__(self):
        self.rows = {}

    @contextlib.contextmanager
    def __call__(self, name, op=None, env=None):
        if op is None:  # the backward+update row: modelled, not counted
            yield
            return
        read = sum(t.numel() * t.element_size()
                   for t in _tensors(env, op.input_arg_names))
        yield
        outs = _tensors(env, op.output_arg_names)
        wrote = sum(t.numel() * t.element_size() for t in outs)
        flops = _flops(op, env)
        ridge = RIDGE_FLOPS_PER_BYTE.get(outs[0].dtype, RIDGE_F32) \
            if outs else RIDGE_F32
        row = self.rows.setdefault(name, {"calls": 0, "bytes": 0,
                                          "flops": 0.0, "teq": 0.0})
        row["calls"] += 1
        row["bytes"] += read + wrote
        row["flops"] += flops
        row["teq"] += max(read + wrote, flops / ridge)

    def flush(self):
        pass

    def finish(self, training):
        """The rows, with the modelled backward+update row."""
        rows = dict(self.rows)
        if training:
            rows[BACKWARD_ROW] = {
                "calls": 1,
                "bytes": 2 * sum(r["bytes"] for r in self.rows.values()),
                "flops": 2 * sum(r["flops"] for r in self.rows.values()),
                "teq": 2 * sum(r["teq"] for r in self.rows.values())}
        return rows


def _is_training(program):
    return any(op.type == "autodiff" for op in program.global_block().ops)


def _modelled_rows(exe, program, feed, fetch_list):
    """One executor run under the traffic model (it trains one step)."""
    with _hooked(_TrafficModel()) as model:
        exe.run(program, feed=feed, fetch_list=fetch_list)
    return model.finish(_is_training(program))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def compiled_profile(exe, program, feed, fetch_list, runs=3,
                     sorted_key="total"):
    """Per-op cost table of a training step, modelled: one run warms up,
    one records each op's traffic (bytes read and written, FLOPs of its
    convolutions and GEMMs), then `runs` timed steps (ending in a
    device sync) give the step time, split over the op rows by their
    roofline weight. Returns (table, meta): rows {'Event', 'Calls',
    'Total', 'Min', 'Max', 'Ave', 'Bytes', 'Flops'} (Total in ms), and
    meta with the step time and the bytes and FLOPs attributed. The
    port runs eagerly: there is no separate compiled artifact, so the
    step time is end to end (timing_mode "e2e")."""
    exe.run(program, feed=feed, fetch_list=fetch_list)
    rows = _modelled_rows(exe, program, feed, fetch_list)
    _sync()
    t0 = time.perf_counter()
    for _ in range(runs):
        exe.run(program, feed=feed, fetch_list=fetch_list,
                return_numpy=False)
    _sync()
    step_s = (time.perf_counter() - t0) / runs
    total_teq = sum(r["teq"] for r in rows.values()) or 1.0
    table = [{"Event": tag, "Calls": r["calls"],
              "Total": step_s * 1e3 * r["teq"] / total_teq,
              "Min": 0.0, "Max": 0.0,
              "Ave": step_s * 1e3 * r["teq"] / total_teq
              / max(r["calls"], 1),
              "Bytes": r["bytes"], "Flops": r["flops"]}
             for tag, r in rows.items()]
    key = {"calls": "Calls", "total": "Total", "ave": "Ave"}.get(
        sorted_key, "Total")
    table.sort(key=lambda r: r[key], reverse=True)
    meta = {"step_seconds": step_s, "e2e_seconds": step_s,
            "host_overhead_seconds": None, "timing_mode": "e2e",
            "flops": sum(r["flops"] for r in rows.values()),
            "bytes_attributed": sum(r["bytes"] for r in rows.values()),
            "teq_attributed": total_teq}
    _print_table(table, step_s * runs,
                 "GPU" if torch.cuda.is_available() else "CPU")
    return table, meta


def _row_of(name):
    """The row a profiler range belongs to, or None."""
    if name.startswith(RANGE_PREFIX):
        tag = name[len(RANGE_PREFIX):]
        return None if tag == BACKWARD_ROW else tag
    if name == "fluid/optimizer" or name.startswith(
            "autograd::engine::evaluate_function"):
        return BACKWARD_ROW
    return None


def _device_rows(prof):
    """({row: device ms}, total device ms) of a CUDA trace: every kernel
    goes to the row of the nearest range around the op that launched it
    (a forward op's "fluid/op/<type>", the optimizer region, or one of
    autograd's backward functions, whichever thread ran it); a kernel
    under none of them is left unmatched."""
    from torch.autograd import DeviceType

    rows, total = {}, 0.0
    for e in prof.events():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            # a record_function range also shows on the device's timeline
            # as a span (a user annotation), not a kernel
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("fluid/")):
                total += e.self_device_time_total / 1e3
            continue
        if not e.kernels:
            continue
        row, up = None, e
        while up is not None and row is None:
            row = _row_of(up.name)
            up = up.cpu_parent
        if row is not None:
            rows[row] = rows.get(row, 0.0) + sum(
                k.duration for k in e.kernels) / 1e3
    return rows, total


def _host_rows(prof):
    """({row: host ms}, total host ms of the runs) of a CPU trace."""
    rows, total = {}, 0.0
    for e in prof.key_averages():
        if e.key == "fluid/step":
            total += e.cpu_time_total / 1e3
            continue
        row = _row_of(e.key)
        if row is not None:
            rows[row] = rows.get(row, 0.0) + e.cpu_time_total / 1e3
    return rows, total


def trace_profile(exe, program, feed, fetch_list, runs=3):
    """Reconcile the traffic-MODELLED per-op attribution against MEASURED
    per-op times from a torch.profiler trace of `runs` executor runs
    (the reference measured per-op times with CUDA events,
    platform/profiler.cc:142,198).

    Measured rows: each forward op type, the device time of the kernels
    launched inside its "fluid/op/<type>" ranges; backward+update, that
    of the kernels autograd's backward and the optimizer region launch.
    `measured_total_ms` is all kernel time on the device per run, and
    `unmatched_ms` the part no row holds (feed and fetch copies, the key
    upload), signed: a negative value means the rows counted more than
    the device ran. On the CPU the same rows read host time.

    Returns (table, meta): rows {'Event', 'measured_ms',
    'measured_share', 'modeled_share', 'disagreement'} sorted by measured
    time; meta['top5_max_disagreement'] is the largest share
    disagreement over the five biggest measured rows."""
    from torch.profiler import ProfilerActivity, profile

    cuda = exe.device.type == "cuda"
    exe.run(program, feed=feed, fetch_list=fetch_list)
    model_rows = _modelled_rows(exe, program, feed, fetch_list)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    _sync()
    with profile(activities=acts) as prof:
        with _hooked(_Ranges()):
            for _ in range(runs):
                with record_function("fluid/step"):
                    out = exe.run(program, feed=feed,
                                  fetch_list=fetch_list,
                                  return_numpy=False)
        _sync()
    del out
    measured, total = (_device_rows(prof) if cuda else _host_rows(prof))
    total_meas = sum(measured.values()) or 1.0
    total_teq = sum(r["teq"] for r in model_rows.values()) or 1.0
    table = []
    for tag in sorted(set(measured) | set(model_rows)):
        m = measured.get(tag, 0.0)
        meas_share = m / total_meas
        model_share = model_rows.get(tag, {}).get("teq", 0.0) / total_teq
        table.append({"Event": tag, "measured_ms": m / runs,
                      "measured_share": meas_share,
                      "modeled_share": model_share,
                      "disagreement": abs(meas_share - model_share)})
    table.sort(key=lambda r: -r["measured_ms"])
    meta = {"runs": runs,
            "measured_total_ms": total / runs,
            "matched_ms": sum(measured.values()) / runs,
            "unmatched_ms": (total - sum(measured.values())) / runs,
            "top5_max_disagreement": max(
                (r["disagreement"] for r in table[:5]), default=0.0),
            "backend": exe.device.type}
    return table, meta


class _Ranges(object):
    """A lowering hook that brackets each forward op in a
    "fluid/op/<type>" range (and the backward+update in one) with no
    timing of its own: what trace_profile reads."""

    @contextlib.contextmanager
    def __call__(self, name, op=None, env=None):
        with record_function(RANGE_PREFIX + name):
            yield

    def flush(self):
        pass
