"""The comparisons that decide `correct`.

Training: the gap between the program's and the reference's loss at
each step (as a share of the reference's), and, leaf by leaf, the gap
between the two norms of the first gradient and of the parameters'
change over the steps, each measured against the reference's norm of
that leaf or of the median leaf, whichever is larger, and taken at the
worst leaf (`grad_gap`, `change_gap`) and at the median leaf (`.median`).
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out (`keep`); the gradient
is the reference's own before it is stored (`keep_norms`, where the
reference stores rounded parameters), so a leaf whose update rounds away
on both sides is compared, and reads 0. A cell's
limits file names the readings it compares.

Serving: the widest gap by which a served token's logit lies below the
reference's best at its position."""

import math

import torch

SMALL_LEAF = 1e-3


def _leaf_gaps(prog, ref, keep):
    prog, ref = prog.detach().double().cpu(), ref.detach().double().cpu()
    med = ref[keep].median()
    den = torch.maximum(ref, med)
    return ((prog - ref).abs() / den)[keep]


def _keep(ref):
    g = ref.get("keep_norms")
    g = (ref["grad_norms"] if g is None else g).detach().double().cpu()
    return g >= SMALL_LEAF * g.median()


def train_gaps(prog, ref):
    """{name: reading} between two `train_readings`-shaped dicts."""
    out = {}
    for k, (a, b) in enumerate(zip(prog["loss"], ref["loss"])):
        out["loss_gap.%d" % (k + 1)] = (abs(a - b) / abs(b)
                                        if math.isfinite(a) else math.inf)
    keep = _keep(ref)
    for name in ("grad_norms", "change_norms"):
        p = prog[name].detach().double().cpu()
        key = name.replace("_norms", "_gap")
        if bool(torch.isfinite(p).all()):
            gaps = _leaf_gaps(p, ref[name], keep)
            out[key] = float(gaps.max())
            out[key + ".median"] = float(gaps.median())
        else:
            out[key] = out[key + ".median"] = math.inf
    return out


def worst_leaves(prog, ref, top=5):
    """{name: [(leaf index, program norm, reference norm, gap)]} of the
    leaves that read worst, for the readings script."""
    keep = _keep(ref)
    out = {"kept": int(keep.sum()), "leaves": int(keep.numel())}
    for name in ("grad_norms", "change_norms"):
        p = prog[name].detach().double().cpu()
        r = ref[name].detach().double().cpu()
        gap = (p - r).abs() / torch.maximum(r, r[keep].median())
        gap[~keep] = -1
        idx = gap.argsort(descending=True)[:top]
        out[name] = [(int(i), float(p[i]), float(r[i]), float(gap[i]))
                     for i in idx]
    return out


def token_gap(logits, served):
    """The widest gap, over the positions of logits [T, vocab] (the
    reference's), between the best logit and the served token's."""
    z = logits.float()
    got = z.gather(-1, served.long().view(-1, 1))[:, 0]
    return float((z.max(-1).values - got).max())


def judge(readings, limits):
    """(correct, [(name, reading, limit)]) over the limits' names: every
    reading finite and at or under its limit; a limit without a reading,
    or no limits at all, is not correct."""
    rows = []
    ok = bool(limits)
    for name in sorted(limits):
        r, lim = readings.get(name), limits.get(name)
        rows.append((name, r, lim))
        if r is None or lim is None or not math.isfinite(r) or r > lim:
            ok = False
    return ok, rows
