"""The controls on the card, at the training cells' own sizes: the
reference in fp8 (e4m3 forward, e5m2 gradients, stored activations
rounded the same) put in the program's place reads at least three times
what the program reads, on a number the cell compares, on three seeds.
The benchmark's own runs never run the controls; perfbench/readings.py
runs them over more seeds."""

import gc

import pytest

from perfbench.lib import harness
from perfbench.tests.small import bench


def _readings(name, seed, mode, device):
    cell = harness.Cell(name, bench=bench(), seed=seed, mode=mode,
                        device=device)
    run = harness.driver(cell).setup(cell)
    run.release()
    out = run.check()
    del run
    gc.collect()
    return out


@pytest.mark.card
@pytest.mark.parametrize("name", ["gpt2m.train", "resnet50.train"])
def test_the_control_reads_far_above_the_program(card, name):
    import torch

    limits = harness.Cell(name, bench=bench(), device=card).limits
    for seed in (11, 12, 13):
        prog = _readings(name, seed, "program", card)
        ctrl = _readings(name, seed, "control", card)
        torch.cuda.empty_cache()
        assert all(prog[k] <= limits[k] for k in limits), (seed, prog)
        assert any(ctrl[k] > limits[k] and ctrl[k] > 3 * prog[k]
                   for k in limits), (seed, prog, ctrl)
