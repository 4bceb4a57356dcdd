"""keplint: project-native static analysis for the attribution stack.

The port's copy of the reference package's analysis, pointed at
``kepler_tpu_torch``. Run as ``python -m kepler_tpu_torch.analysis
[paths]``. The engine lives in :mod:`kepler_tpu_torch.analysis.engine`,
the domain rules in :mod:`kepler_tpu_torch.analysis.rules`, the protocol
tier in :mod:`kepler_tpu_torch.analysis.protocol` and the device tier in
:mod:`kepler_tpu_torch.analysis.device`.
"""

from kepler_tpu_torch.analysis.engine import (
    Baseline,
    Diagnostic,
    FileContext,
    LintResult,
    ProjectRule,
    REGISTRY,
    Rule,
    all_rules,
    find_repo_root,
    lint_paths,
    register,
)
from kepler_tpu_torch.analysis import rules as _rules  # noqa: F401  (registers)

__all__ = [
    "Baseline",
    "Diagnostic",
    "FileContext",
    "LintResult",
    "ProjectRule",
    "REGISTRY",
    "Rule",
    "all_rules",
    "find_repo_root",
    "lint_paths",
    "register",
]
