"""CLI for paddle_tpu_torch.analysis (the port's copy of the JAX
package's CLI, with its exit codes and refusals).

    python -m paddle_tpu_torch.analysis --all
    python -m paddle_tpu_torch.analysis program path/to/entry.py [--fetch NAME]
    python -m paddle_tpu_torch.analysis trace [files...]
    python -m paddle_tpu_torch.analysis locks [files-or-dirs...]
    python -m paddle_tpu_torch.analysis bands [files...]
    python -m paddle_tpu_torch.analysis shard [files-or-dirs...]
    python -m paddle_tpu_torch.analysis journal <journal.jsonl> [--expect-closed]
    python -m paddle_tpu_torch.analysis explore [--scenario NAME]
                    [--preemptions K] [--max-schedules N] [--replay CSV]

Exit status: 0 when every finding is covered by the baseline
(`paddle_tpu_torch/analysis/baseline.txt` unless --baseline overrides) and
no baseline entry is stale, 1 on a NEW finding or a stale entry
(the tier-1 self-check rejects both), 2 on usage errors.
`--write-baseline` rewrites the baseline to accept the current
findings (each entry still needs a hand-written justification —
the tool writes a TODO marker you must replace).

`program <entry.py>` executes the file (it is expected to build into
`fluid.default_main_program()` — the normal shape of a model script)
and verifies the resulting program; feeds are the program's `is_data`
vars, fetches default to the last op's outputs or --fetch names.
"""

from __future__ import annotations

import argparse
import os
import runpy
import sys
from typing import List

from . import diagnostics
from .diagnostics import Diagnostic, format_diag, load_baseline, split_new


def _report(diags: List[Diagnostic], baseline_path, write_baseline,
            scope=None, out=None, hygiene=True) -> int:
    """`scope` limits STALE detection to the given code prefixes
    ("P"/"T"/"L"): a partial run (one analyzer) must not read the other
    analyzers' baseline entries as stale. `hygiene=False` skips the
    TODO-justification audit of the baseline file — an ad-hoc target
    (a journal file) must answer for ITS findings only, not for repo
    baseline debt."""
    out = out or sys.stdout  # read at call time: a caller may redirect it
    baseline = load_baseline(baseline_path)
    new, old, stale = split_new(diags, baseline)
    # a TODO/empty justification is a defect of the baseline FILE, not
    # of this run's findings — checked unscoped on every non-write run
    unjustified = [fp for fp, why in baseline.items()
                   if not why or "TODO" in why] if hygiene else []
    if scope is not None:
        stale = [fp for fp in stale if fp[:1] in scope]
    for d in old:
        out.write(format_diag(d, baselined=True) + "\n")
    for d in new:
        out.write(format_diag(d) + "\n")
    for fp in stale:
        out.write("stale baseline entry (fix landed? remove it): %s\n"
                  % fp)
    if not write_baseline:
        for fp in unjustified:
            out.write("unjustified baseline entry (replace the TODO "
                      "with a real reason): %s\n" % fp)
    out.write("%d finding%s (%d new, %d baselined, %d stale baseline "
              "entr%s)\n"
              % (len(diags), "" if len(diags) == 1 else "s", len(new),
                 len(old), len(stale), "y" if len(stale) == 1 else "ies"))
    if write_baseline:
        path = baseline_path or diagnostics.default_baseline_path()
        with open(path, "w") as f:
            f.write("# paddle_tpu_torch.analysis baseline — accepted "
                    "findings."
                    "\n# Every entry MUST carry a one-line justification"
                    " after '  #'.\n# Format: <CODE> <path>::<symbol>::"
                    "<detail>  # <why this is accepted>\n")
            written = set()
            for d in sorted(diags, key=lambda d: d.fingerprint):
                if d.fingerprint in written:
                    continue  # one entry per fingerprint, not per site
                written.add(d.fingerprint)
                why = baseline.get(d.fingerprint,
                                   "TODO: justify or fix")
                f.write("%s  # %s\n" % (d.fingerprint, why))
        out.write("baseline written: %s (%d entries)\n"
                  % (path, len(written)))
        return 0
    # stale and TODO-justified entries fail too: the tier-1 self-check
    # rejects both, so a green lint.sh must imply a green tier-1 gate
    return 1 if (new or stale or unjustified) else 0


def _cmd_program(args, baseline, write_baseline) -> int:
    # the entry script either builds into the default programs (bare
    # layer calls) or builds its own Program objects (the program_guard
    # idiom) — verify BOTH: the guarded default pair and every Program
    # left in the script's globals. An entry that built nothing is a
    # usage error, never a silent '0 findings'.
    sys.path.insert(0, os.path.dirname(os.path.abspath(args.entry)) or ".")
    from .. import fluid
    from .program_lint import verify_program

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        mod = runpy.run_path(args.entry, run_name="__analysis__")
    base = os.path.basename(args.entry)
    programs = []
    if main.global_block().ops:
        programs.append(("<%s>" % base, main))
    if startup.global_block().ops:
        programs.append(("<%s:startup>" % base, startup))
    seen = {id(p) for _, p in programs}
    for name in sorted(mod):
        val = mod[name]
        if (isinstance(val, fluid.Program) and id(val) not in seen
                and val.global_block().ops):
            seen.add(id(val))
            programs.append(("<%s:%s>" % (base, name), val))
    if not programs:
        sys.stderr.write(
            "error: %s built no non-empty Program — build into the "
            "default programs or leave your Program objects in module "
            "globals\n" % args.entry)
        return 2
    diags = []
    for label, prog in programs:
        diags.extend(verify_program(prog, fetches=args.fetch or (),
                                    label=label))
    # an ad-hoc entry cannot assess baseline staleness at all
    return _report(diags, baseline, write_baseline, scope=())


def _lint_args_paths(lint_paths, paths):
    """Run an AST linter over CLI paths; a typo'd path is a usage
    error (exit 2), not a finding and not a traceback."""
    try:
        return lint_paths(paths or None)
    except (FileNotFoundError, SyntaxError, ValueError) as e:
        # SyntaxError: a non-parseable target file is equally a usage
        # error, not "a new finding" and not a traceback
        sys.stderr.write("error: %s\n" % e)
        return None


def _cmd_trace(args, baseline, write_baseline) -> int:
    from .trace_lint import lint_paths

    diags = _lint_args_paths(lint_paths, args.paths)
    if diags is None:
        return 2
    # explicit paths lint a SUBSET of files: entries for unlinted files
    # are out of scope, not stale — only the default full-scope run can
    # judge staleness for its analyzer
    return _report(diags, baseline, write_baseline,
                   scope=() if args.paths else ("T",))


def _cmd_locks(args, baseline, write_baseline) -> int:
    from .lock_lint import lint_paths

    diags = _lint_args_paths(lint_paths, args.paths)
    if diags is None:
        return 2
    return _report(diags, baseline, write_baseline,
                   scope=() if args.paths else ("L",))


def _cmd_bands(args, baseline, write_baseline) -> int:
    from .band_lint import lint_paths

    diags = _lint_args_paths(lint_paths, args.paths)
    if diags is None:
        return 2
    return _report(diags, baseline, write_baseline,
                   scope=() if args.paths else ("B",))


def _cmd_shard(args, baseline, write_baseline) -> int:
    from .shard_lint import lint_paths

    diags = _lint_args_paths(lint_paths, args.paths)
    if diags is None:
        return 2
    return _report(diags, baseline, write_baseline,
                   scope=() if args.paths else ("S",))


def _cmd_all(args, baseline, write_baseline) -> int:
    from . import collect_diagnostics
    from .diagnostics import REPO_SCOPE_CODES

    # --all runs the repo-scope analyzers; J-code entries (journal
    # files are runtime artifacts) are out of scope, never stale here
    return _report(collect_diagnostics(), baseline, write_baseline,
                   scope=REPO_SCOPE_CODES)


def _cmd_journal(args, baseline, write_baseline) -> int:
    from .protocol_lint import verify_journal

    try:
        diags = verify_journal(args.path,
                               expect_closed=args.expect_closed)
    except FileNotFoundError as e:
        sys.stderr.write("error: %s\n" % e)
        return 2
    # a journal is an ad-hoc target like `program`: no staleness scope,
    # and repo-baseline hygiene (TODO entries) is not ITS failure
    return _report(diags, baseline, write_baseline, scope=(),
                   hygiene=False)


def _cmd_explore(args, baseline, write_baseline) -> int:
    import tempfile

    from .sched_explore import SCENARIOS

    names = sorted(SCENARIOS) if args.scenario == "all" \
        else [args.scenario]
    for name in names:
        if name not in SCENARIOS:
            sys.stderr.write("error: unknown scenario %r (have: %s)\n"
                             % (name, ", ".join(sorted(SCENARIOS))))
            return 2
    if args.journal_dir:
        # keep the run's journals where the caller (tools/lint.sh's
        # protocol gate) can re-verify each with `analysis journal`
        tmp = args.journal_dir
        os.makedirs(tmp, exist_ok=True)
        cleanup = None
    else:
        tmp = tempfile.mkdtemp(prefix="paddle_tpu_torch_explore_")
        cleanup = tmp
    try:
        return _run_explore(args, names, tmp)
    finally:
        if cleanup is not None:
            import shutil

            shutil.rmtree(cleanup, ignore_errors=True)


def _run_explore(args, names, tmp) -> int:
    from .sched_explore import (SCENARIOS, explore, format_schedule,
                                run_schedule)

    rc = 0
    if args.replay is not None:
        decisions = [c for c in args.replay.split(",") if c]
        name = names[0]
        result = run_schedule(SCENARIOS[name](), decisions,
                              os.path.join(tmp, "replay.jsonl"),
                              max_steps=args.max_steps)
        sys.stdout.write("replay %s: %d steps, %d violation(s)\n"
                         % (name, len(result.trace),
                            len(result.violations)))
        for v in result.violations:
            sys.stdout.write("  violation: %s\n" % v)
        return 1 if result.violations else 0
    for name in names:
        report = explore(SCENARIOS[name], tmp,
                         max_preemptions=args.preemptions,
                         max_schedules=args.max_schedules,
                         max_steps=args.max_steps)
        if report.ok:
            sys.stdout.write(
                "%s: %d schedule(s) explored, no violation\n"
                % (name, report.runs))
        else:
            rc = 1
            sys.stdout.write(
                "%s: VIOLATION after %d schedule(s)\n"
                % (name, report.runs))
            for v in report.violation.violations:
                sys.stdout.write("  violation: %s\n" % v)
            sys.stdout.write(
                "  replay with: python -m paddle_tpu_torch.analysis explore "
                "--scenario %s --replay '%s'\n"
                % (name, format_schedule(report.violation.schedule)))
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.analysis")
    p.add_argument("--all", action="store_true",
                   help="run every analyzer over the repo")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: packaged baseline.txt)")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept current findings into the baseline")
    sub = p.add_subparsers(dest="cmd")
    sp = sub.add_parser("program", help="verify a program-building script")
    sp.add_argument("entry")
    sp.add_argument("--fetch", action="append", default=[])
    st = sub.add_parser("trace", help="sync-free hot-path lint (T-codes)")
    st.add_argument("paths", nargs="*")
    sl = sub.add_parser("locks", help="lock-discipline lint")
    sl.add_argument("paths", nargs="*")
    sb = sub.add_parser("bands", help="band-lifecycle verify (B-codes)")
    sb.add_argument("paths", nargs="*")
    ss = sub.add_parser("shard", help="mesh sharding-spec lint (S-codes)")
    ss.add_argument("paths", nargs="*")
    sj = sub.add_parser("journal",
                        help="verify a RequestJournal file (J-codes)")
    sj.add_argument("path")
    sj.add_argument("--expect-closed", action="store_true",
                    help="also require every rid to have a terminal "
                         "record (the post-close() invariant)")
    se = sub.add_parser("explore",
                        help="deterministic fleet schedule exploration")
    se.add_argument("--scenario", default="all",
                    help="scenario name, or 'all' (default)")
    se.add_argument("--preemptions", type=int, default=1)
    se.add_argument("--max-schedules", type=int, default=200)
    se.add_argument("--max-steps", type=int, default=400)
    se.add_argument("--replay", default=None,
                    help="comma-separated schedule to replay verbatim "
                         "(requires a single --scenario)")
    se.add_argument("--journal-dir", default=None,
                    help="write per-schedule journals here (kept) "
                         "instead of a throwaway temp dir")
    args = p.parse_args(argv)

    if args.write_baseline and not args.all and args.baseline is None:
        # a partial run sees only its own analyzer's findings; writing
        # the SHARED baseline from it would silently delete every other
        # analyzer's justified entries
        p.error("--write-baseline without --all would clobber the "
                "shared baseline with a partial view; pass --all or an "
                "explicit --baseline path")
    # NO blanket try/except here: an entry script failing under
    # `program` must surface its full traceback, not masquerade as a
    # usage error (path typos are handled inside _cmd_trace/_cmd_locks)
    if args.all:
        return _cmd_all(args, args.baseline, args.write_baseline)
    if args.cmd == "program":
        return _cmd_program(args, args.baseline, args.write_baseline)
    if args.cmd == "trace":
        return _cmd_trace(args, args.baseline, args.write_baseline)
    if args.cmd == "locks":
        return _cmd_locks(args, args.baseline, args.write_baseline)
    if args.cmd == "bands":
        return _cmd_bands(args, args.baseline, args.write_baseline)
    if args.cmd == "shard":
        return _cmd_shard(args, args.baseline, args.write_baseline)
    if args.cmd == "journal":
        return _cmd_journal(args, args.baseline, args.write_baseline)
    if args.cmd == "explore":
        if args.replay is not None and args.scenario == "all":
            p.error("--replay needs a single --scenario (a schedule "
                    "only means anything against the scenario that "
                    "recorded it)")
        return _cmd_explore(args, args.baseline, args.write_baseline)
    p.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
