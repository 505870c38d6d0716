"""The diagnostic record of the program verifier and the journal
verifier (the port's own copy of the part of
paddle_tpu/analysis/diagnostics.py that program_lint.py and
protocol_lint.py use: `Diagnostic`, `ProgramVerifyError`, the P- and
J-codes, `make`, `format_diag`, `rel_path`; the JAX package's AST
linters and their baseline files are not part of the port).

The reference Fluid stack validated a ProgramDesc op-by-op in C++
(framework/op_desc.cc CheckAttrs / InferShape, operator.cc:484 runtime
re-check) and surfaced violations as PADDLE_ENFORCE failures. Here the
verifier emits `Diagnostic` records: a stable code (P + number), a
severity, an anchor, and a *fingerprint* without line numbers.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

__all__ = ["Diagnostic", "ProgramVerifyError", "CODES", "make",
           "format_diag", "repo_root", "rel_path"]

# code -> (short name, severity)
CODES: Dict[str, Tuple[str, str]] = {
    "P001": ("dangling-input", "error"),
    "P002": ("dead-write", "warning"),
    "P003": ("dtype-mismatch", "error"),
    "P004": ("shape-mismatch", "error"),
    "P005": ("duplicate-parameter", "error"),
    "P006": ("unpaired-grad", "error"),
    # journal state-machine verifier (protocol_lint.py), over
    # RequestJournal files
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


@dataclass
class Diagnostic:
    code: str       # stable code, e.g. "P001"
    path: str       # a program label like "<program uid=3>"
    line: int       # 1-based anchor (0 = whole program)
    symbol: str     # enclosing scope: "block0"
    detail: str     # stable anchor inside the scope (op:var)
    message: str    # human-readable one-liner
    name: str = field(default="")
    severity: str = field(default="error")

    def __post_init__(self):
        if not self.name:
            self.name, self.severity = CODES.get(
                self.code, (self.code, "error"))

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity of a finding."""
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


def format_diag(d: Diagnostic) -> str:
    return "%s:%d: %s %s (%s) %s: %s" % (
        d.path, d.line, d.code, d.name, d.severity, d.symbol, d.message)


def repo_root() -> str:
    """The checkout holding the port (the parent of paddle_tpu_torch/)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


def rel_path(path: str) -> str:
    """Repo-relative, forward-slash path for stable fingerprints; paths
    outside the repo (journals in temporary directories) pass through as
    given."""
    root = repo_root()
    ap = os.path.abspath(path)
    if ap.startswith(root + os.sep):
        return os.path.relpath(ap, root).replace(os.sep, "/")
    return path.replace(os.sep, "/")
