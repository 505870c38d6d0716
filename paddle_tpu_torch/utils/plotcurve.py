"""Plot training curves from trainer logs (reference
python/paddle/utils/plotcurve.py). Parses `Pass=N ... Key=V` lines the
CLI emits, one curve per requested key; test-pass lines (`Test
samples=...`) plot as companion curves. matplotlib is imported inside
`plot_paddle_curve` only: `parse_log` runs where it is missing."""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np

__all__ = ["plot_paddle_curve", "parse_log", "main"]


def parse_log(keys, inputfile):
    """Extract ([pass, key1, key2...] rows, test rows) from a log
    stream."""
    pass_pat = r"Pass=([0-9]*)"
    test_pat = r"Test samples=([0-9]*)"
    for k in keys:
        pass_pat += r".*?%s=([0-9e\-\.]*)" % re.escape(k)
        test_pat += r".*?%s=([0-9e\-\.]*)" % re.escape(k)
    cp, ct = re.compile(pass_pat), re.compile(test_pat)
    data, test_data = [], []
    for line in inputfile:
        m = cp.search(line)
        if m:
            data.append([float(x) for x in m.groups()])
        mt = ct.search(line)
        if mt:
            test_data.append([float(x) for x in mt.groups()])
    return np.asarray(data), np.asarray(test_data)


def plot_paddle_curve(keys, inputfile, outputfile, format="png",
                      show_fig=False):
    """Plot the requested keys over passes; writes `outputfile`."""
    keys = list(keys) or ["AvgCost"]
    x, x_test = parse_log(keys, inputfile)
    if x.shape[0] <= 0:
        sys.stderr.write("No data to plot. Exiting!\n")
        return
    import matplotlib

    matplotlib.use("Agg")  # headless-safe
    import matplotlib.pyplot as pyplot
    from matplotlib import cm

    m = len(keys) + 1
    # test lines are one per pass while train lines come every
    # log_period batches, so test curves get their own x coordinates
    if x_test.shape[0] == x.shape[0]:
        xs_test = x[:, 0]
    else:
        # one test line per pass vs several train lines per pass: align
        # test points to the actual pass ids
        passes = np.unique(x[:, 0])
        xs_test = (
            passes[: x_test.shape[0]]
            if x_test.shape[0] <= passes.shape[0]
            else np.arange(x_test.shape[0])
        )
    for i in range(1, m):
        pyplot.plot(
            x[:, 0], x[:, i],
            color=cm.jet(1.0 * (i - 1) / (2 * m)), label=keys[i - 1],
        )
        if x_test.shape[0] > 0:
            pyplot.plot(
                xs_test, x_test[:, i],
                color=cm.jet(1.0 - 1.0 * (i - 1) / (2 * m)),
                label="Test " + keys[i - 1],
            )
    pyplot.xlabel("number of epoch")
    pyplot.legend(loc="best")
    if show_fig:
        pyplot.show()
    pyplot.savefig(outputfile, format=format, bbox_inches="tight")
    pyplot.clf()


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Plot curves from a trainer log."
    )
    parser.add_argument("-i", "--input", default=None,
                        help="log file (default stdin)")
    parser.add_argument("-o", "--output", default=None,
                        help="figure file (default stdout)")
    parser.add_argument("--format", default="png")
    parser.add_argument("key", nargs="*", help="score keys (default AvgCost)")
    args = parser.parse_args(argv)
    inp = open(args.input) if args.input else sys.stdin
    out = args.output or sys.stdout.buffer
    try:
        plot_paddle_curve(args.key, inp, out, format=args.format)
    finally:
        if args.input:
            inp.close()


if __name__ == "__main__":
    main()
