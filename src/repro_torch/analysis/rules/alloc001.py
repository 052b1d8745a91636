"""ALLOC001 — ignored return of BlockAllocator.free().

The JAX package's rule, unchanged (same heuristic, same message): the
port's engine (``repro_torch.serve.engine``) keeps the same refcounted
allocator and the same contract.

Since prefix sharing with copy-on-write pages, ``free()`` returns the
sublist of blocks whose refcount actually hit zero — shared pages stay
alive.  Callers that drop the return can't scrub or recycle the right
pages: the engine zeroes exactly the physically-freed blocks before
reuse, and the fleet's page accounting reconciles against that list.
A bare ``allocator.free(blocks)`` statement is therefore either a
leak-adjacent bug or (in tests that only exercise refcounts) needs an
explicit suppression.

Heuristic: any expression-statement call whose callee leaf is ``free``
on a receiver whose name suggests the block allocator (``alloc`` /
``allocator`` stem, or a bare ``a``/``ba`` in tests constructed from
``BlockAllocator``).  We keep it name-based — static typing isn't
available — but require the module to reference ``BlockAllocator``
somewhere, so unrelated ``free()`` APIs don't trip it.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import Finding, ModuleContext, Rule, register


def _mentions_block_allocator(ctx: ModuleContext) -> bool:
    if "BlockAllocator" in ctx.text:
        return True
    return any(full.endswith("BlockAllocator")
               for full in ctx.imports.names.values())


@register
class Alloc001(Rule):
    rule_id = "ALLOC001"
    title = "BlockAllocator.free() return value ignored"
    motivation = ("copy-on-write pages of prefix sharing: free() returns "
                  "only the physically-freed sublist (shared pages "
                  "survive); the engine scrubs exactly that list before "
                  "reuse, so dropping it desyncs page scrubbing from the "
                  "refcount ledger")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not _mentions_block_allocator(ctx):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Expr) \
                    or not isinstance(node.value, ast.Call):
                continue
            call = node.value
            if not (isinstance(call.func, ast.Attribute)
                    and call.func.attr == "free"):
                continue
            yield self.finding(
                ctx, call,
                "return value of BlockAllocator.free() ignored — it is "
                "the physically-freed sublist (refcounted pages may "
                "survive); consume it to scrub/recycle the right pages, "
                "or suppress if only refcounts are under test")
