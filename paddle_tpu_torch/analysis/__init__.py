"""paddle_tpu_torch.analysis — the port's static analyzers (counterpart
of paddle_tpu/analysis/), over one shared diagnostic framework (stable
codes, file:line anchors, a checked-in baseline in `baseline.txt`):

  * program verifier  (`program_lint`)  P001-P006 — validates
    Program/Block/Operator IR before the executor lowers it; the
    Executor's `preflight` (`run(validate=True)`)
  * sync-free linter  (`trace_lint`)  T001-T003, T005 — AST pass over
    the functions annotated `# sync-free` (the ones `chip_smoke.py` runs
    under `torch.cuda.set_sync_debug_mode("error")`) for host syncs,
    unseeded draws and tensor branches, and torch device calls from
    host-side scheduler threads
  * lock-discipline linter (`lock_lint`) L001-L004 — learns guarded
    attributes from `# guarded-by:` annotations and checks mutations,
    lock-acquisition ordering, and `threading.Condition` discipline
  * journal verifier (`protocol_lint`) J001-J011 — a per-rid DFA over
    `RequestJournal` files
  * schedule explorer (`sched_explore`) — deterministic interleaving
    enumeration over the fleet's SchedulerHook seam
  * band-lifecycle verifier (`band_lint`) B001-B004 — derives the band
    registry from the port's `engine._BANDS` / `_DEVICE_ADVANCED` and
    paged-cache side-bands, then checks every `# band-verb:` annotated
    lifecycle function propagates every band, `_mark_dirty` coverage,
    wire schema symmetry and `_DEVICE_ADVANCED` drift
  * mesh sharding-spec lint (`shard_lint`) S001, S003, S004 — unbound
    axis names, host materialization of device band state from
    scheduler threads, spec-rank overruns

T004 and S002 have no counterpart in an eager torch program
(`diagnostics.NO_COUNTERPART`).

Run everything:  python -m paddle_tpu_torch.analysis --all
One analyzer:    python -m paddle_tpu_torch.analysis program <entry.py>
                 python -m paddle_tpu_torch.analysis trace [files...]
                 python -m paddle_tpu_torch.analysis locks [paths...]
                 python -m paddle_tpu_torch.analysis bands [files...]
                 python -m paddle_tpu_torch.analysis shard [paths...]
                 python -m paddle_tpu_torch.analysis journal <journal.jsonl>
                 python -m paddle_tpu_torch.analysis explore [--scenario X]

The tier-1 test `tests/test_torch_static_analysis.py` asserts `run_all()`
reports nothing beyond the port's baseline — new code cannot merge with
a fresh finding.

The AST linters are pure AST and import nothing of the port they lint;
the built-in program entries build through the port's fluid, imported
when they run.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .diagnostics import (  # noqa: F401
    CODES,
    Diagnostic,
    ProgramVerifyError,
    default_baseline_path,
    format_diag,
    load_baseline,
    split_new,
)
from .program_lint import preflight, verify_program  # noqa: F401

__all__ = [
    "Diagnostic", "ProgramVerifyError", "CODES", "run_all",
    "collect_diagnostics", "load_baseline", "split_new", "format_diag",
    "default_baseline_path", "verify_journal", "preflight",
    "verify_program",
]


def verify_journal(path, expect_closed=False):
    """Re-export of `protocol_lint.verify_journal` (lazy, to keep the
    package's import-light rule)."""
    from .protocol_lint import verify_journal as _vj

    return _vj(path, expect_closed=expect_closed)


def collect_diagnostics(with_programs: bool = True) -> List[Diagnostic]:
    """Run every analyzer over the port and return the raw findings —
    the ONE assembly point shared by run_all() and the CLI's --all, so
    the tier-1 self-check and the lint gate cannot diverge."""
    from . import band_lint, lock_lint, shard_lint, trace_lint

    diags: List[Diagnostic] = []
    if with_programs:
        from .entries import verify_entries

        diags.extend(verify_entries())
    diags.extend(trace_lint.lint_paths())
    diags.extend(lock_lint.lint_paths())
    diags.extend(band_lint.lint_paths())
    diags.extend(shard_lint.lint_paths())
    return diags


def run_all(baseline_path: Optional[str] = None,
            with_programs: bool = True,
            ) -> Tuple[List[Diagnostic], List[Diagnostic], List[str]]:
    """Run every analyzer over the port; returns (new, baselined,
    stale_baseline_entries). `with_programs=False` skips the built-in
    program entries (they import torch via fluid)."""
    from .diagnostics import REPO_SCOPE_CODES

    diags = collect_diagnostics(with_programs)
    baseline = load_baseline(baseline_path)
    new, old, stale = split_new(diags, baseline)
    # journal (J) entries verify runtime artifacts — out of run_all's
    # scope, never stale here; without programs the P entries are out
    # of scope too (same scoping the CLI applies)
    scope = ("T", "L", "B", "S") if not with_programs \
        else REPO_SCOPE_CODES
    stale = [fp for fp in stale if fp[:1] in scope]
    return new, old, stale
