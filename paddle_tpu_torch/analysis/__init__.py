"""Static analysis of Fluid programs (counterpart of the program-verifier
part of paddle_tpu/analysis/): `verify_program` and the Executor's
`preflight` (`run(validate=True)`, PADDLE_TPU_VALIDATE=1), with the JAX
package's P-codes."""

from .diagnostics import Diagnostic, ProgramVerifyError  # noqa: F401
from .program_lint import preflight, verify_program  # noqa: F401

__all__ = ["Diagnostic", "ProgramVerifyError", "preflight",
           "verify_program"]
