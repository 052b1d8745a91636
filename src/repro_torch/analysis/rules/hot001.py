"""HOT001 — per-element device dispatch inside host-side Python loops.

The JAX package's lesson, in torch terms: one tensor op per slot inside
a Python ``for`` costs a dispatch (and, for a tensor built from host
data, a host-to-device upload) per iteration, turning an O(1) tick into
O(slots).  The fix is always the same — assemble operands on the host
inside the loop, convert and upload once outside it.  This rule flags
``torch.*`` calls, ``.to(...)``, ``.cuda()`` and ``.copy_(...)``
lexically inside ``for`` / ``while`` bodies in host-side ``serve/``
code (the engine / router plane).  Model and kernel code is out of
scope: its Python loops run over layers and tiles, once a step.  Calls
that dispatch nothing (``torch.no_grad()``, ``torch.device(...)``, ...)
are not flagged, and a call inside nested loops is reported once.
"""
from __future__ import annotations

import ast
from typing import Iterable, Iterator, Set

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       register)

SCOPES = ("src/repro_torch/serve/",)

_METHODS = {"to", "cuda", "copy_"}
# torch calls that launch and upload nothing
_HOST_ONLY = {"torch.no_grad", "torch.inference_mode", "torch.enable_grad",
              "torch.set_grad_enabled", "torch.is_grad_enabled",
              "torch.device", "torch.Size", "torch.is_tensor",
              "torch.is_floating_point", "torch.get_default_dtype",
              "torch.finfo", "torch.iinfo"}


def _loop_bodies(loop: ast.AST) -> Iterator[ast.AST]:
    """What runs once per iteration: the body (and a while's test)."""
    if isinstance(loop, ast.While):
        yield loop.test
    yield from loop.body


def _root(node: ast.AST) -> str:
    """The leftmost name of an attribute chain ('' if none)."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else ""


@register
class Hot001(Rule):
    rule_id = "HOT001"
    title = "per-element device dispatch in a host loop"
    motivation = ("the JAX engine's decode-path optimisation: per-slot "
                  "device ops in the admission loop made tick cost "
                  "O(slots); batching to one conversion per tick was the "
                  "whole win — in torch a per-iteration "
                  "torch.as_tensor(..., device=) is one dispatch and one "
                  "host-to-device upload each")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not ctx.rel.startswith(SCOPES):
            return
        torch_roots = {name for name, full in ctx.imports.names.items()
                       if full == "torch" or full.startswith("torch.")}
        seen: Set[int] = set()
        for loop in ast.walk(ctx.tree):
            if not isinstance(loop, (ast.For, ast.AsyncFor, ast.While)):
                continue
            for part in _loop_bodies(loop):
                for node in ast.walk(part):
                    if not isinstance(node, ast.Call) or id(node) in seen:
                        continue
                    full = ctx.resolve(node.func) or ""
                    # only names that came through an import of torch
                    if full.startswith("torch.") \
                            and _root(node.func) in torch_roots \
                            and full not in _HOST_ONLY:
                        seen.add(id(node))
                        yield self.finding(
                            ctx, node,
                            f"`{full}(...)` inside a host-side Python loop "
                            f"dispatches one device op (or upload) per "
                            f"iteration — build the operand on the host "
                            f"inside the loop and convert once after it "
                            f"(O(slots) tick regression)")
                    elif isinstance(node.func, ast.Attribute) \
                            and node.func.attr in _METHODS:
                        seen.add(id(node))
                        yield self.finding(
                            ctx, node,
                            f"`.{node.func.attr}(...)` inside a host-side "
                            f"Python loop copies or moves a tensor per "
                            f"iteration — gather the rows and move them "
                            f"once, outside the loop")
