"""GRAD001 — a kernel launch that autograd can reach without a node.

A ctypes launch records nothing on the autograd tape: its output has no
``grad_fn``, so under grad mode every input's gradient through it is
silently cut.  The CPU tests never see it — there the wrappers run the
differentiable plain versions — so the cut shows only on the card, as a
wrong gradient.  The trainer once reached the forward-only scan kernels
that way; their wrappers now call ``kernels.refuse_autograd`` first.

A launch is a call of ``torch.ops.repro_torch.<op>`` (unless that op has
a ``register_autograd``) or a call of a ctypes kernel library's function
(``_lib().<fn>(...)``, ``lib.<fn>(...)`` with ``lib`` from
``build.load``) that hands the kernel device memory (a ``.data_ptr()``
argument; the library's host-side queries pass none).  In
``src/repro_torch/`` each launch must be one of:

* in ``forward`` / ``backward`` of a ``torch.autograd.Function``;
* in the body of a ``torch.library.custom_op`` (the op is the boundary:
  its call sites are checked as launches);
* after a ``refuse_autograd(...)`` statement that every path to it
  passes (in the same block or an enclosing one, before it);
* under ``with torch.no_grad():`` / ``torch.inference_mode()``, or in a
  function decorated with either.
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator, List, Set

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       dotted_name, register)
from repro_torch.analysis.rules.krn001 import (Libraries, custom_ops,
                                               op_of, registered)

SCOPES = ("src/repro_torch/",)
_NO_GRAD = {"torch.no_grad", "torch.inference_mode",
            "torch.autograd.no_grad", "torch.autograd.inference_mode"}


def _is_no_grad(ctx: ModuleContext, node: ast.AST) -> bool:
    target = node.func if isinstance(node, ast.Call) else node
    return (ctx.resolve(target) or "") in _NO_GRAD


def _is_guard(stmt: ast.stmt) -> bool:
    return (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
            and (dotted_name(stmt.value.func) or "").split(".")[-1]
            == "refuse_autograd")


def _own_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """The parts of a statement that run before or instead of its
    nested blocks."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, (ast.Try, ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)) or type(stmt).__name__ == "TryStar":
        return []
    return [stmt]


def _blocks(stmt: ast.stmt) -> Iterator[List[ast.stmt]]:
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return                       # a scope of its own
    for name in ("body", "orelse", "finalbody"):
        block = getattr(stmt, name, None)
        if block:
            yield block
    for h in getattr(stmt, "handlers", ()):
        yield h.body


def _calls(nodes: List[ast.AST]) -> Iterator[ast.Call]:
    for root in nodes:
        for node in ast.walk(root):
            if isinstance(node, ast.Call):
                yield node


def _autograd_function_methods(ctx: ModuleContext) -> Set[int]:
    """ids of ``forward`` / ``backward`` defs of autograd Functions."""
    out = set()
    for cls in ast.walk(ctx.tree):
        if isinstance(cls, ast.ClassDef) and any(
                (ctx.resolve(b) or "").endswith("autograd.Function")
                for b in cls.bases):
            for fn in cls.body:
                if isinstance(fn, ast.FunctionDef) \
                        and fn.name in ("forward", "backward"):
                    out.add(id(fn))
    return out


@register
class Grad001(Rule):
    rule_id = "GRAD001"
    title = "kernel launch reachable under autograd without a node"
    motivation = ("the trainer reached the forward-only scan kernels under "
                  "autograd and cut their gradients on the card while the "
                  "CPU tests ran the differentiable plain versions; a "
                  "ctypes launch leaves no graph node, so every launch "
                  "path needs a Function, an op's register_autograd, a "
                  "refuse_autograd guard or no_grad")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not ctx.rel.startswith(SCOPES):
            return
        libs = Libraries(ctx)
        ops = custom_ops(ctx)
        with_autograd = registered(ctx, "register_autograd")
        exempt = _autograd_function_methods(ctx) | {
            id(fn) for _, fn in ops.values()}
        for fn in ctx.functions():
            if id(fn) in exempt \
                    or any(_is_no_grad(ctx, d) for d in fn.decorator_list):
                continue
            yield from self._walk(ctx, libs, with_autograd, fn, fn.body,
                                  guarded=False)

    def _launch(self, ctx: ModuleContext, libs: Libraries,
                with_autograd: Set[str], fn: ast.AST, call: ast.Call):
        """What the call launches (a name for the message), or None."""
        op = op_of(ctx.resolve(call.func))
        if op is not None and op.startswith("repro_torch::"):
            return (None if op in with_autograd
                    else f"torch.ops.{op.replace('::', '.')}")
        if isinstance(call.func, ast.Attribute) \
                and libs.is_lib(call.func.value, fn) \
                and any(isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "data_ptr"
                        for a in call.args for n in ast.walk(a)):
            return f"ctypes {call.func.attr}"
        return None

    def _walk(self, ctx, libs, with_autograd, fn, stmts, guarded):
        for stmt in stmts:
            if _is_guard(stmt):
                guarded = True
                continue
            if not guarded:
                for call in _calls(_own_exprs(stmt)):
                    what = self._launch(ctx, libs, with_autograd, fn, call)
                    if what is not None:
                        yield self.finding(
                            ctx, call,
                            f"`{what}` launches a kernel that leaves no "
                            f"autograd node: under grad mode it silently "
                            f"cuts the gradient of every input on the card "
                            f"— call kernels.refuse_autograd(...) before "
                            f"it, or launch from a torch.autograd.Function "
                            f"/ an op with register_autograd / under "
                            f"torch.no_grad()")
            if guarded or (isinstance(stmt, (ast.With, ast.AsyncWith))
                           and any(_is_no_grad(ctx, item.context_expr)
                                   for item in stmt.items)):
                continue             # everything below is covered
            for block in _blocks(stmt):
                yield from self._walk(ctx, libs, with_autograd, fn, block,
                                      guarded)
