"""SYNC001 — a host sync in per-layer code.

A CUDA launch returns before the device finishes; any call that needs a
device value on the host waits for every launch before it.  In the
per-layer code of ``models/`` and ``kernels/`` such a wait stalls the
launch queue once a layer, and it is exactly what a CUDA graph over the
decode step cannot hold and what a grouped MoE GEMM "sized without a
host sync" must avoid.  Flagged: ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``torch.cuda.synchronize()``, ``.nonzero()`` /
``torch.nonzero`` (with or without ``as_tuple=``: its output size is
data-dependent either way; ``torch.nonzero_static(size=)`` is not),
one-argument ``torch.where(cond)``, ``torch.unique`` / ``.unique()``,
and ``int(...)`` / ``float(...)`` / ``bool(...)`` of a torch reduction
(``int(x.sum())``).  Host-side shapes and Python numbers are not
flagged: only these calls read device memory.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       dotted_name, register)

SCOPES = ("src/repro_torch/models/", "src/repro_torch/kernels/")

_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero", "unique"}
_FUNCS = {"torch.cuda.synchronize", "torch.nonzero", "torch.unique",
          "torch.unique_consecutive"}
_REDUCTIONS = {"sum", "mean", "max", "min", "amax", "amin", "any", "all",
               "prod", "norm", "std", "var", "argmax", "argmin",
               "count_nonzero", "logsumexp"}
_CASTS = {"int", "float", "bool"}


def _is_reduction(ctx: ModuleContext, node: ast.AST) -> bool:
    """A call of a reduction method, or of ``torch.<reduction>``."""
    if not isinstance(node, ast.Call) \
            or not isinstance(node.func, ast.Attribute) \
            or node.func.attr not in _REDUCTIONS:
        return False
    raw = dotted_name(node.func) or ""
    if raw.split(".")[0] in ctx.imports.names:
        # a module's function: torch.sum(x), not numpy's or math's
        return (ctx.imports.resolve(raw) or "").startswith("torch.")
    return True                      # a method: x.sum()


@register
class Sync001(Rule):
    rule_id = "SYNC001"
    title = "host sync in per-layer code"
    motivation = ("CUDA graphs over the decode step and a grouped MoE GEMM "
                  "sized on the device both assume the per-layer code "
                  "never waits for the device; a grep finds no such wait "
                  "today and nothing else keeps it that way")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not ctx.rel.startswith(SCOPES):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            full = ctx.resolve(node.func) or ""
            if full in _FUNCS or (full == "torch.where"
                                  and len(node.args) == 1
                                  and not node.keywords):
                yield self.finding(
                    ctx, node,
                    f"`{full}(...)` waits for the device (its result is "
                    f"sized or read on the host) — keep per-layer code "
                    f"free of host syncs (CUDA graphs, device-sized "
                    f"dispatch)")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _METHODS \
                    and not full.startswith(("numpy.", "math.")):
                yield self.finding(
                    ctx, node,
                    f"`.{node.func.attr}()` copies a device value to the "
                    f"host and waits for every launch before it — keep "
                    f"per-layer code free of host syncs")
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in _CASTS \
                    and node.func.id not in ctx.imports.names \
                    and len(node.args) == 1 \
                    and _is_reduction(ctx, node.args[0]):
                yield self.finding(
                    ctx, node,
                    f"`{node.func.id}(<reduction>)` reads a device "
                    f"reduction on the host — keep the value on the "
                    f"device, or compute it from shapes")
