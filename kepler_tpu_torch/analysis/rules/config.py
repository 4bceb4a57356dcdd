"""KTL104 — config reads must be declared (and documented)."""

from __future__ import annotations

import ast
import os
from typing import Iterable, Iterator

from kepler_tpu_torch.analysis.engine import Diagnostic, FileContext, Rule, register
from kepler_tpu_torch.analysis.rules.common import qualname, terminal

_CONFIG_PY = "kepler_tpu_torch/config/config.py"
_GEN_CONFIG_DOCS = "hack/gen_config_docs.py"

_schema_cache: dict[str, dict | None] = {}


def _dataclass_classes(tree: ast.Module) -> dict[str, ast.ClassDef]:
    out: dict[str, ast.ClassDef] = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        for deco in node.decorator_list:
            name = qualname(deco if not isinstance(deco, ast.Call)
                            else deco.func)
            if name and name.split(".")[-1] == "dataclass":
                out[node.name] = node
                break
    return out


def _class_schema(cls: ast.ClassDef, classes: dict[str, ast.ClassDef],
                  stack: tuple[str, ...] = ()) -> dict:
    """{'fields': {name: sub-schema|None}, 'extras': {methods/classvars}}"""
    fields: dict[str, dict | None] = {}
    extras: set[str] = set()
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(
                stmt.target, ast.Name):
            sub = None
            ann = qualname(stmt.annotation) or ""
            target_cls = ann.split(".")[-1]
            if target_cls not in classes and isinstance(
                    stmt.value, ast.Call):
                for kw in stmt.value.keywords:
                    if kw.arg == "default_factory":
                        target_cls = terminal(qualname(kw.value))
            if (target_cls in classes and target_cls != cls.name
                    and target_cls not in stack):
                sub = _class_schema(classes[target_cls], classes,
                                    stack + (cls.name,))
            fields[stmt.target.id] = sub
        elif isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    extras.add(t.id)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            extras.add(stmt.name)
    return {"fields": fields, "extras": extras}


def _config_schema_for(ctx: FileContext) -> dict | None:
    """Schema of the repo's Config tree, parsed statically from
    kepler_tpu_torch/config/config.py under the lint root (fixture-friendly:
    a tmp tree with its own config.py gets its own schema)."""
    cache_key = ctx.root
    if cache_key in _schema_cache:
        return _schema_cache[cache_key]
    schema: dict | None = None
    cfg_path = os.path.join(ctx.root, *_CONFIG_PY.split("/"))
    try:
        with open(cfg_path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        classes = _dataclass_classes(tree)
        if "Config" in classes:
            schema = _class_schema(classes["Config"], classes)
    except (OSError, SyntaxError):
        schema = None
    _schema_cache[cache_key] = schema
    return schema


def _documented_config_keys(ctx: FileContext) -> set[str] | None:
    """Keys of DESCRIPTIONS in hack/gen_config_docs.py, or None when the
    generator is absent (fixtures without a hack/ tree)."""
    gen_path = os.path.join(ctx.root, *_GEN_CONFIG_DOCS.split("/"))
    try:
        with open(gen_path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return None
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == "DESCRIPTIONS"
                        for t in node.targets)
                and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
    return None


def _schema_leaves(schema: dict, prefix: str = "") -> Iterator[str]:
    for name, sub in schema["fields"].items():
        path = f"{prefix}{name}"
        if sub is None:
            yield path
        else:
            yield from _schema_leaves(sub, f"{path}.")


@register
class ConfigDeclaredRule(Rule):
    id = "KTL104"
    name = "config-declared"
    summary = ("every `cfg.*` attribute read must exist in config.py and "
               "be documented in hack/gen_config_docs.py")
    rationale = (
        "Config is a plain dataclass tree: reading `cfg.monitor.intervall` "
        "raises AttributeError only on the code path that reaches it — in "
        "production, at 3am. Statically resolving every `cfg.`-rooted "
        "attribute chain against the declared schema turns that into a "
        "lint failure; requiring a DESCRIPTIONS entry per leaf keeps "
        "`docs/user/configuration.md` complete (the generator's teeth, "
        "enforced at lint time too).")

    def check(self, ctx: FileContext) -> Iterable[Diagnostic]:
        schema = _config_schema_for(ctx)
        if schema is None:
            return
        # part 1: cfg.<...> reads anywhere resolve against the schema
        for node in ctx.walk_nodes:
            if not isinstance(node, ast.Attribute):
                continue
            qual = qualname(node)
            if not qual:
                continue
            parts = qual.split(".")
            # depth >= 3 (`cfg.section.field`) so a local named `cfg`
            # that is a *section* config (FaultConfig, a dict, …) with
            # depth-1 reads never false-positives; depth-1 reads on the
            # real Config resolve at import time anyway
            if parts[0] != "cfg" or len(parts) < 3:
                continue
            # validate the LONGEST chain only (an Attribute node's value
            # chain is itself an Attribute; skip inner nodes)
            parent = getattr(node, "_keplint_parent_checked", False)
            if parent:
                continue
            cur = schema
            for i, attr in enumerate(parts[1:], start=1):
                if attr in cur["fields"]:
                    sub = cur["fields"][attr]
                    if sub is None:
                        break  # reached a leaf; trailing attrs are on
                        # the leaf value (str/int/...), not config keys
                    cur = sub
                elif attr in cur["extras"]:
                    break  # method / classvar on the section
                else:
                    yield ctx.diag(
                        self, node,
                        f"config attribute {'.'.join(parts[:i + 1])!r} is "
                        "not declared in kepler_tpu_torch/config/config.py")
                    break
            for sub_node in ast.walk(node):
                if isinstance(sub_node, ast.Attribute):
                    sub_node._keplint_parent_checked = True  # type: ignore
        # part 2: on config.py itself, every leaf must be documented
        if ctx.rel_path.endswith(_CONFIG_PY):
            documented = _documented_config_keys(ctx)
            if documented is not None:
                for leaf in _schema_leaves(schema):
                    if leaf not in documented:
                        yield Diagnostic(
                            path=ctx.rel_path, line=1, col=1,
                            rule_id=self.id, severity=self.severity,
                            message=(
                                f"config leaf {leaf!r} has no DESCRIPTIONS "
                                f"entry in {_GEN_CONFIG_DOCS} — document "
                                "the knob"))
