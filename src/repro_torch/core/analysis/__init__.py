"""Static analysis over the port's BuffetFS core (`repro_torch.core`).

The BuffetFS thesis is that correctness-critical checks can be evaluated
locally instead of paid for at runtime — this package applies the same
idea to the codebase's own invariants.  `buffetlint` is an AST-based
analyzer with three passes (lock discipline, wire contract, counter
hygiene), run as ``python -m repro_torch.core.analysis --check``;
`lockrec` is the runtime lock-order recorder that cross-validates the
static acquisition order against orders actually observed under load.
Both are the port's own copies of `repro.core.analysis` and import
nothing of it.
"""
from .buffetlint import LOCK_REGISTRY, Finding, lint_paths, main
from .lockrec import LockOrderRecorder

__all__ = ["LOCK_REGISTRY", "Finding", "lint_paths", "main",
           "LockOrderRecorder"]
