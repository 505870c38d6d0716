"""Small copies of the benchmark's cells for CPU rehearsals: the same
drivers, references and comparisons at widths a test can hold."""

import io
import json
import os

from perfbench.lib import harness

HELD_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "held_out.json")


def bench():
    """BENCHMARK.json with the entries of the cells held out of it (a cell
    whose program is at fault), so that their drivers are still
    rehearsed here and can return by data alone."""
    b = harness.load_benchmark()
    with open(HELD_OUT) as fh:
        held = json.load(fh)
    return {k: (v + held.get(k, []) if isinstance(v, list) else v)
            for k, v in b.items()}

SMALL = {
    "gpt2m.train": (dict(n_embd=32, n_layer=2, n_head=4, vocab_size=64,
                         n_positions=32),
                    dict(batch=4, seq=16, reference_rows=2)),
    "resnet50.train": (dict(image_shape=[3, 32, 32], num_classes=10),
                       dict(batch=8)),
    "gpt2m.serve": (dict(n_embd=32, n_layer=2, n_head=4, vocab_size=64,
                         n_positions=64),
                    dict(rate=20.0, max_slots=3, prefill_chunk_tokens=16,
                         requests=32, warm_s=0.2, slice_s=0.3,
                         check_requests=3,
                         prompt={"median": 12, "sigma": 0.5, "min": 6,
                                 "max": 24},
                         output={"min": 3, "max": 8})),
}


def small_cell(name, seed=5, fault=None, mode="program", limits=None,
               device="cpu"):
    cell = harness.Cell(name, bench=bench(), seed=seed, device=device,
                        fault=fault, mode=mode)
    conf, traffic = SMALL[name]
    cell.config = dict(cell.config, **conf)
    cell.traffic = dict(cell.traffic, **traffic)
    if limits is not None:
        cell.limits = limits
    return cell


def run_small(name, seconds=0.3, trace=0, **kw):
    """(exit code, the result line as a dict, the output's last line)."""
    cell = small_cell(name, **kw)
    out = io.StringIO()
    rc = harness.main(["--workload", name, "--seed", str(cell.seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      cell=cell, need_card=False, out=out)
    last = out.getvalue().strip().splitlines()[-1]
    return rc, json.loads(last), last
