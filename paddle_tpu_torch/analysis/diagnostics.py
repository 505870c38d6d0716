"""Shared diagnostic framework for the port's static analyzers (the
port's own copy of paddle_tpu/analysis/diagnostics.py).

The reference Fluid stack validated a ProgramDesc op-by-op in C++
(framework/op_desc.cc CheckAttrs / InferShape, operator.cc:484 runtime
re-check) and surfaced violations as PADDLE_ENFORCE failures with a code
location. Here every analyzer — the program verifier, the journal
verifier and the AST linters (trace, lock, band, shard) — emits the same
`Diagnostic` record: a stable code (P/T/L/B/S/J + number), a severity, a
file:line anchor, and a *fingerprint* that survives unrelated edits (no
line numbers in it), so a checked-in baseline can accept pre-existing
findings without blocking the gate on new ones.

Baseline file format (one finding per line, `#` comments allowed):

    <CODE> <path>::<symbol>::<detail>  # one-line justification

The fingerprint is exactly the part before the justification comment.
An entry with no matching finding is reported as *stale* and FAILS the
full-scope gate (CLI and tier-1 self-check alike) so the baseline
shrinks as fixes land; an entry with a missing or TODO justification
fails the same way. The port's baseline is its own
(`paddle_tpu_torch/analysis/baseline.txt`), over the port's files.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Diagnostic", "ProgramVerifyError", "CODES", "REPO_SCOPE_CODES",
    "NO_COUNTERPART", "make", "load_baseline", "split_new", "format_diag",
    "repo_root", "rel_path", "default_baseline_path", "walk_python_files",
]

# code -> (short name, severity). Severity is informational: the CLI
# fails on ANY non-baselined finding, error or warning.
CODES: Dict[str, Tuple[str, str]] = {
    # program verifier (program_lint.py)
    "P001": ("dangling-input", "error"),
    "P002": ("dead-write", "warning"),
    "P003": ("dtype-mismatch", "error"),
    "P004": ("shape-mismatch", "error"),
    "P005": ("duplicate-parameter", "error"),
    "P006": ("unpaired-grad", "error"),
    # sync-free hot-path linter (trace_lint.py)
    "T001": ("host-sync-in-sync-free", "error"),
    "T002": ("unseeded-draw-in-sync-free", "error"),
    "T003": ("tensor-branch", "warning"),
    "T004": ("unhashable-static-arg", "warning"),
    "T005": ("device-dispatch-in-scheduler", "error"),
    # lock-discipline linter (lock_lint.py)
    "L001": ("unguarded-mutation", "error"),
    "L002": ("lock-order-inversion", "error"),
    "L003": ("wait-outside-while", "warning"),
    "L004": ("notify-outside-lock", "error"),
    # band-lifecycle verifier (band_lint.py)
    "B001": ("band-not-propagated", "error"),
    "B002": ("dirty-flag-gap", "error"),
    "B003": ("wire-schema-asymmetry", "error"),
    "B004": ("device-adoption-drift", "error"),
    # mesh sharding-spec lint (shard_lint.py)
    "S001": ("unbound-axis-name", "error"),
    "S002": ("shard-spec-arity", "error"),
    "S003": ("host-sync-on-sharded", "error"),
    "S004": ("spec-rank-mismatch", "error"),
    # journal state-machine verifier (protocol_lint.py) — runs over
    # RequestJournal FILES (runtime artifacts), never in --all
    "J001": ("orphan-record", "error"),
    "J002": ("duplicate-terminal", "error"),
    "J003": ("record-after-terminal", "error"),
    "J004": ("stale-fence", "error"),
    "J005": ("progress-terminal-mismatch", "error"),
    "J006": ("unassigned-progress", "error"),
    "J007": ("open-at-close", "error"),
    "J008": ("malformed-journal", "error"),
    "J009": ("version-fence", "error"),
    "J010": ("taint-fence", "error"),
    "J011": ("handoff-fence", "error"),
}

# codes the JAX package checks that have no counterpart in an eager
# torch program, and why: no analyzer of the port emits them
NO_COUNTERPART: Dict[str, str] = {
    "T004": "the port has no jit cache: a static argument that misses it "
            "has nothing to miss (as the HLO parsers of the JAX profiler "
            "have no counterpart)",
    "S002": "the port has no shard_map: the mesh bodies take a MeshAxis "
            "and whole tensors, so there is no in_specs/out_specs tuple "
            "to drift from a signature",
}

# codes whose analyzer runs inside `--all` / `run_all()` — the only
# scope whose baseline entries a full-scope run may judge stale. The
# J-codes verify journal FILES the CLI is pointed at explicitly, so a
# J baseline entry is never stale from --all's point of view.
REPO_SCOPE_CODES = ("P", "T", "L", "B", "S")


@dataclass
class Diagnostic:
    code: str       # stable code, e.g. "P001"
    path: str       # repo-relative file, or a program label like "<fit_a_line>"
    line: int       # 1-based anchor (0 = whole file/program)
    symbol: str     # enclosing scope: "Class.method", "func", or "block0"
    detail: str     # stable anchor inside the scope (var/attr/call name)
    message: str    # human-readable one-liner
    name: str = field(default="")
    severity: str = field(default="error")

    def __post_init__(self):
        if not self.name:
            self.name, self.severity = CODES.get(
                self.code, (self.code, "error"))

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used for baseline matching."""
        return "%s %s::%s::%s" % (self.code, self.path, self.symbol,
                                  self.detail)


class ProgramVerifyError(ValueError):
    """Raised by the Executor's pre-flight when the program verifier
    reports error-severity findings. Carries the diagnostics."""

    def __init__(self, diagnostics: List[Diagnostic]):
        self.diagnostics = list(diagnostics)
        super().__init__(
            "program verification failed (%d finding%s):\n  %s"
            % (len(self.diagnostics),
               "" if len(self.diagnostics) == 1 else "s",
               "\n  ".join(format_diag(d) for d in self.diagnostics)))


def make(code: str, path: str, line: int, symbol: str, detail: str,
         message: str) -> Diagnostic:
    return Diagnostic(code=code, path=path, line=int(line), symbol=symbol,
                      detail=detail, message=message)


def format_diag(d: Diagnostic, baselined: bool = False) -> str:
    tail = "  [baselined]" if baselined else ""
    return "%s:%d: %s %s (%s) %s: %s%s" % (
        d.path, d.line, d.code, d.name, d.severity, d.symbol, d.message,
        tail)


# --- repo anchoring ----------------------------------------------------

def repo_root() -> str:
    """The checkout holding the port (the parent of paddle_tpu_torch/)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def rel_path(path: str) -> str:
    """Repo-relative, forward-slash path for stable fingerprints; paths
    outside the repo (test corpora and journals in temporary
    directories) pass through as given."""
    root = repo_root()
    ap = os.path.abspath(path)
    if ap.startswith(root + os.sep):
        return os.path.relpath(ap, root).replace(os.sep, "/")
    return path.replace(os.sep, "/")


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.txt")


def walk_python_files(paths, default_paths):
    """Yield .py files from `paths` (files or dirs, recursively; falls
    back to `default_paths` resolved against the repo root). The ONE
    file-scope definition shared by the AST linters, so their walkers
    cannot drift. A typo'd explicit path is a usage error (the CLI
    turns it into exit 2), never a traceback or a phantom-clean run."""
    root = repo_root()
    if not paths:
        paths = [os.path.join(root, p) for p in default_paths]
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, files in os.walk(p):
                dirnames.sort()  # deterministic traversal everywhere
                for fname in sorted(files):
                    if fname.endswith(".py"):
                        yield os.path.join(dirpath, fname)
        elif not os.path.exists(p):
            raise FileNotFoundError("no such file or directory: %r" % p)
        elif not p.endswith(".py"):
            raise ValueError("not a python file: %r" % p)
        else:
            yield p


# --- baseline ----------------------------------------------------------

def load_baseline(path: Optional[str] = None) -> Dict[str, str]:
    """fingerprint -> justification. Missing file = empty baseline."""
    path = path or default_baseline_path()
    out: Dict[str, str] = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            # any run of whitespace before '#' separates fingerprint
            # from justification — a hand-edit that normalises the
            # canonical two spaces to one must not corrupt the entry
            parts = re.split(r"\s+#", line, maxsplit=1)
            why = parts[1].strip() if len(parts) > 1 else ""
            out[parts[0].strip()] = why
    return out


def split_new(diags: Iterable[Diagnostic], baseline: Dict[str, str]):
    """Partition findings into (new, baselined) and compute the stale
    baseline entries (accepted findings that no longer occur)."""
    new: List[Diagnostic] = []
    old: List[Diagnostic] = []
    seen = set()
    for d in diags:
        if d.fingerprint in baseline:
            old.append(d)
            seen.add(d.fingerprint)
        else:
            new.append(d)
    stale = [fp for fp in baseline if fp not in seen]
    return new, old, stale
