"""KTL107 — kernel wrappers and their plain versions are side-effect-free."""

from __future__ import annotations

import ast
from typing import Iterable

from kepler_tpu_torch.analysis.engine import Diagnostic, FileContext, Rule, register
from kepler_tpu_torch.analysis.rules.common import (
    call_canonical,
    imports_for,
    jitted_functions,
)

_IMPURE_ROOTS = {"random", "time", "datetime"}
_IMPURE_BARE = {"print", "open", "input"}


@register
class JitPureRule(Rule):
    id = "KTL107"
    name = "jit-pure"
    summary = ("no Python side effects (print, wall clock, host RNG, "
               "global state) inside kernel wrappers, their plain "
               "versions or autograd Functions")
    rationale = (
        "A hand kernel's plain PyTorch version (`*_ref`) is its parity "
        "target: the card's result is held against it bit for bit, so it "
        "must be a pure function of its tensors — a `time.time()`, "
        "`np.random` draw or global mutation there makes the CPU answer "
        "a moving target. The wrapper that launches the kernel (it calls "
        "a `kt_*` symbol of the built library) runs once per window on "
        "the main path and takes the plain version for CPU tensors, so "
        "the same holds for it, and for the `forward`/`backward` of a "
        "`torch.autograd.Function`, which autograd may replay. Kernels "
        "in kepler_tpu_torch/ops/ stay pure functions of their tensors. "
        "Functions under a `jit` decorator and kernels passed to "
        "`pallas_call` are covered as in the reference package.")

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        imports = imports_for(ctx)
        for fn in jitted_functions(ctx):
            for node in ast.walk(fn):
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    yield ctx.diag(
                        self, node,
                        f"{type(node).__name__.lower()} statement inside "
                        f"kernel function {fn.name}(); kernel code must "
                        "not mutate enclosing scopes")
                    continue
                if not isinstance(node, ast.Call):
                    continue
                canon = call_canonical(node, imports) or ""
                root = canon.split(".")[0]
                impure = (
                    canon in _IMPURE_BARE
                    or root in _IMPURE_ROOTS
                    or canon.startswith("numpy.random")
                )
                if impure:
                    yield ctx.diag(
                        self, node,
                        f"impure call {canon}() inside kernel function "
                        f"{fn.name}(); kernels must be side-effect-free "
                        "(take a seeded torch.Generator as an argument "
                        "if needed)")
