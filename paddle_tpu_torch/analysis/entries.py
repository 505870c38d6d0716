"""Built-in program entries for `python -m paddle_tpu_torch.analysis --all`
(the port's copy of paddle_tpu/analysis/entries.py, built through the
port's `fluid`).

The reference validated every ProgramDesc a trainer submitted; our
equivalent of "the programs the repo ships" is a small set of
representative graphs built through the real layer stack — a regression
net and a classification net, each with a full backward + optimizer
region. `--all` (and the tier-1 self-check) verifies these end to end,
so a regression in the layer helpers, `append_backward`, or an
optimizer's op emission that produces malformed IR fails the lint gate
even if no runtime test happens to execute that path.

Each entry builds fresh `Program`s under `program_guard` (no global
default-program pollution) and returns (main, startup, feeds, fetches).
"""

from __future__ import annotations

from typing import Callable, Dict, List

__all__ = ["ENTRIES", "build_entry", "verify_entries"]


def _fit_a_line():
    from .. import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[13], dtype="float32")
        y = fluid.layers.data("y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return main, startup, [], [loss.name]


def _recognize_digits_mlp():
    from .. import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", shape=[784], dtype="float32")
        label = fluid.layers.data("label", shape=[1], dtype="int64")
        hidden = fluid.layers.fc(input=img, size=32, act="relu")
        logits = fluid.layers.fc(input=hidden, size=10, act="softmax")
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=logits, label=label))
        acc = fluid.layers.accuracy(input=logits, label=label)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return main, startup, [], [loss.name, acc.name]


ENTRIES: Dict[str, Callable] = {
    "fit_a_line": _fit_a_line,
    "recognize_digits_mlp": _recognize_digits_mlp,
}


def build_entry(name: str):
    return ENTRIES[name]()


def verify_entries(names=None) -> List:
    """Verify every built-in entry's main AND startup program."""
    from .program_lint import verify_program

    diags = []
    for name in names or sorted(ENTRIES):
        main, startup, feeds, fetches = build_entry(name)
        diags.extend(verify_program(
            main, feeds=feeds, fetches=fetches, label="<%s>" % name))
        diags.extend(verify_program(
            startup, label="<%s:startup>" % name))
    return diags
