"""FBK001 — a fallback that hides the device or the kernel.

The port's founding rule: a kernel wrapper runs its plain PyTorch
version only for tensors on the CPU, and on a CUDA tensor launches its
kernel or raises; entry points run on the card unless the caller asks
for the CPU, and raise without a GPU.  A silent fallback turns a kernel
that does not build, or a card that is missing, into a run that passes
on the wrong device or through the wrong code — and every number it
reports is then about something else.  Flagged, in ``src/repro_torch/``,
``examples_torch/`` and ``chip_smoke.py``:

* an ``except`` handler around a kernel launch (a ctypes library call),
  ``build.load`` / ``build_all`` or ``torch.ops.repro_torch.*`` that
  neither re-raises nor keeps the error for a raise later in the same
  function (``build.build_all`` collects the compilers' errors and
  raises after its loop: clean);
* a device choice that yields ``"cpu"`` when ``torch.cuda.is_available()``
  is false (``"cuda" if torch.cuda.is_available() else "cpu"``);
* in a kernel wrapper (``src/repro_torch/kernels/``, not ``ref.py``), a
  call of a ``*_ref`` plain version outside a branch on
  ``<tensor>.device.type == "cpu"``.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, Optional

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       dotted_name, register)
from repro_torch.analysis.rules.krn001 import Libraries, op_of, scopes

SCOPES = ("src/repro_torch/", "examples_torch/", "chip_smoke.py")
WRAPPERS = "src/repro_torch/kernels/"
_NOT_WRAPPERS = ("src/repro_torch/kernels/ref.py",
                 "src/repro_torch/kernels/build.py",
                 "src/repro_torch/kernels/__init__.py")
_IS_AVAILABLE = "torch.cuda.is_available"


def _risky(ctx: ModuleContext, libs: Libraries, call: ast.Call,
           fn: Optional[ast.AST]) -> Optional[str]:
    full = ctx.resolve(call.func) or ""
    leaf = full.rsplit(".", 1)[-1]
    if (op_of(full) or "").startswith("repro_torch::"):
        return full
    if leaf == "build_all" or full == "build.load" \
            or full.endswith("kernels.build.load"):
        return full
    if isinstance(call.func, ast.Attribute) \
            and libs.is_lib(call.func.value, fn):
        return f"the kernel library's {call.func.attr}"
    return None


def _cpu_value(ctx: ModuleContext, node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call)
            and (ctx.resolve(node.func) or "") == "torch.device"
            and bool(node.args) and _cpu_value(ctx, node.args[0]))


def _asks_availability(ctx: ModuleContext, node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call)
               and (ctx.resolve(n.func) or "") == _IS_AVAILABLE
               for n in ast.walk(node))


def _on_cpu_test(node: ast.AST) -> Optional[bool]:
    """For ``<x>.device.type == "cpu"`` True (the body is the CPU branch),
    for ``!= "cpu"`` False (the orelse is), else None."""
    if not (isinstance(node, ast.Compare) and len(node.ops) == 1):
        return None
    sides = [node.left, node.comparators[0]]
    if not any(isinstance(s, ast.Constant) and s.value == "cpu"
               for s in sides):
        return None
    if not any((dotted_name(s) or "").endswith("device.type")
               for s in sides):
        return None
    if isinstance(node.ops[0], ast.Eq):
        return True
    return False if isinstance(node.ops[0], ast.NotEq) else None


@register
class Fbk001(Rule):
    rule_id = "FBK001"
    title = "fallback that hides the device or the kernel"
    motivation = ("the port's founding rule: on a CUDA tensor a wrapper "
                  "launches its kernel or raises, and an entry point "
                  "without a GPU raises unless asked for the CPU; a "
                  "silent fallback makes a failed build or a missing card "
                  "a passing run on the wrong path")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not ctx.rel.startswith(SCOPES):
            return
        libs = Libraries(ctx)
        parents: Dict[int, ast.AST] = {}
        for node in ast.walk(ctx.tree):
            for child in ast.iter_child_nodes(node):
                parents[id(child)] = node
        for node, fn in scopes(ctx.tree):
            if isinstance(node, ast.Try):
                yield from self._handlers(ctx, libs, node, fn)
            elif isinstance(node, ast.IfExp) \
                    and _asks_availability(ctx, node.test) \
                    and (_cpu_value(ctx, node.body)
                         or _cpu_value(ctx, node.orelse)):
                yield self.finding(
                    ctx, node,
                    "device choice falls back to the CPU when "
                    "torch.cuda.is_available() is false — run on cuda by "
                    "default and raise without a GPU (resolve_device)")
            elif isinstance(node, ast.If) \
                    and _asks_availability(ctx, node.test):
                for stmt in node.body + node.orelse:
                    value = getattr(stmt, "value", None)
                    if isinstance(stmt, (ast.Assign, ast.Return)) \
                            and value is not None \
                            and _cpu_value(ctx, value):
                        yield self.finding(
                            ctx, stmt,
                            "device choice falls back to the CPU when "
                            "torch.cuda.is_available() is false — run on "
                            "cuda by default and raise without a GPU "
                            "(resolve_device)")
            elif isinstance(node, ast.Call) \
                    and ctx.rel.startswith(WRAPPERS) \
                    and ctx.rel not in _NOT_WRAPPERS \
                    and (dotted_name(node.func) or "").endswith("_ref") \
                    and not self._in_cpu_branch(node, parents):
                yield self.finding(
                    ctx, node,
                    f"kernel wrapper calls the plain version "
                    f"`{dotted_name(node.func)}` outside a branch on "
                    f"`<tensor>.device.type == \"cpu\"` — on a CUDA "
                    f"tensor it must launch the kernel or raise")

    @staticmethod
    def _in_cpu_branch(node: ast.AST, parents: Dict[int, ast.AST]) -> bool:
        child, parent = node, parents.get(id(node))
        while parent is not None:
            if isinstance(parent, ast.If):
                cpu = _on_cpu_test(parent.test)
                if (cpu is True and child in parent.body) \
                        or (cpu is False and child in parent.orelse):
                    return True
            child, parent = parent, parents.get(id(parent))
        return False

    def _handlers(self, ctx, libs, node: ast.Try, fn):
        risky = [r for r in (_risky(ctx, libs, c, fn)
                             for stmt in node.body for c in ast.walk(stmt)
                             if isinstance(c, ast.Call)) if r]
        if not risky:
            return
        raises_later = fn is not None and any(
            isinstance(n, ast.Raise) and n.lineno > node.end_lineno
            for n in ast.walk(fn))
        for h in node.handlers:
            if any(isinstance(n, ast.Raise) for n in ast.walk(h)):
                continue
            kept = h.name is not None and any(
                isinstance(n, ast.Name) and n.id == h.name
                and isinstance(n.ctx, ast.Load) for n in ast.walk(h))
            if kept and raises_later:
                continue
            yield self.finding(
                ctx, h,
                f"handler swallows a failure of `{risky[0]}` — re-raise, "
                f"or keep the error and raise it later in this function "
                f"(a kernel that fails to build or launch must fail the "
                f"run, not fall back)")
