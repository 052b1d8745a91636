"""DET001 — unseeded nondeterminism in replay-critical code.

The JAX package's checks — a module-level ``numpy.random`` draw, a
stdlib ``random`` draw, a wall-clock read — over the port's
replay-critical trees (``core/``, ``serve/``, ``models/``,
``kernels/``), plus torch's hidden global generator: ``torch.rand`` /
``randn`` / ``randint`` / ``randperm`` / ``normal`` / ``bernoulli`` /
``multinomial`` / ``poisson`` (and their ``*_like`` forms) without
``generator=``, in-place draws (``x.normal_()``, ``x.uniform_()``, ...)
without ``generator=``, and any reseeding of the global generators
(``torch.manual_seed``, ``torch.cuda.manual_seed[_all]``,
``torch.seed``).  The port's failover and fleet tests hold survivors
bit for bit to a calm run, and its engine's sampling draws JAX's
threefry bits from explicit keys; every weight and noise draw takes a
seeded ``torch.Generator``.

Allowed: constructing seeded generators (``RandomState``,
``default_rng``, ``random.Random``, ``torch.Generator``) and any draw
that passes ``generator=``.
"""
from __future__ import annotations

import ast
from typing import Iterable

from repro_torch.analysis.core import (Finding, ModuleContext, Rule,
                                       dotted_name, register)

SCOPES = ("src/repro_torch/core/", "src/repro_torch/serve/",
          "src/repro_torch/models/", "src/repro_torch/kernels/")

# numpy.random names that construct SEEDED generators (allowed)
_SEEDED = {"RandomState", "default_rng", "Generator", "SeedSequence",
           "BitGenerator", "PCG64", "PCG64DXSM", "Philox", "MT19937",
           "SFC64"}
# stdlib random names that construct seedable generators (allowed)
_RANDOM_OK = {"Random", "SystemRandom", "getstate", "setstate"}
# wall-clock reads (each one a replay divergence)
_CLOCKS = {"time.time", "time.time_ns", "time.monotonic",
           "time.monotonic_ns", "time.perf_counter",
           "time.perf_counter_ns", "datetime.datetime.now",
           "datetime.datetime.utcnow", "datetime.datetime.today",
           "datetime.date.today"}
# torch draws that take generator= (without it: the global generator)
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial", "poisson", "rand_like",
                "randn_like", "randint_like"}
# in-place draws on a tensor (any receiver)
_INPLACE_DRAWS = {"normal_", "uniform_", "random_", "bernoulli_",
                  "exponential_", "geometric_", "cauchy_", "log_normal_"}
# reseeding the global generators
_RESEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
            "torch.random.seed", "torch.cuda.manual_seed",
            "torch.cuda.manual_seed_all", "torch.cuda.seed",
            "torch.cuda.seed_all"}


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


@register
class Det001(Rule):
    rule_id = "DET001"
    title = "unseeded nondeterminism in replay-critical code"
    motivation = ("bitwise-deterministic replay: the failover, fleet and "
                  "chaos tests assert survivors are bitwise-equal to a "
                  "calm run, and sampled tokens equal the JAX engine's "
                  "threefry draws — one hidden-state draw (numpy, stdlib "
                  "or torch's global generator) breaks the assert "
                  "fleet-wide")

    def check(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not ctx.rel.startswith(SCOPES):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _INPLACE_DRAWS \
                    and not _has_generator(node):
                yield self.finding(
                    ctx, node,
                    f"in-place draw `.{node.func.attr}(...)` without "
                    f"generator= uses torch's hidden global generator — "
                    f"pass a seeded torch.Generator so replay stays "
                    f"bitwise-deterministic")
                continue
            raw = dotted_name(node.func)
            # only trust names that actually came through an import —
            # a local variable that happens to be called `random` is not
            # the stdlib module
            if not raw or raw.split(".")[0] not in ctx.imports.names:
                continue
            full = ctx.imports.resolve(raw)
            leaf = full.rsplit(".", 1)[-1]
            if full.startswith("numpy.random.") and leaf not in _SEEDED:
                yield self.finding(
                    ctx, node,
                    f"module-level numpy.random call `{full}` draws from "
                    f"hidden global state — use a seeded "
                    f"np.random.RandomState/default_rng so replay stays "
                    f"bitwise-deterministic")
            elif full.startswith("random.") and full.count(".") == 1 \
                    and leaf not in _RANDOM_OK:
                yield self.finding(
                    ctx, node,
                    f"stdlib `{full}` draws from hidden global state — "
                    f"use a seeded random.Random(seed) (or numpy "
                    f"RandomState) so replay stays bitwise-deterministic")
            elif full in _CLOCKS:
                yield self.finding(
                    ctx, node,
                    f"wall-clock read `{full}()` in replay-critical code "
                    f"— thread a tick counter / seeded schedule through "
                    f"instead (calm-vs-fault replay must not depend on "
                    f"real time)")
            elif full in _RESEEDS:
                yield self.finding(
                    ctx, node,
                    f"`{full}(...)` reseeds torch's global generator, "
                    f"which every caller in the process shares — draw "
                    f"from a torch.Generator seeded for this use instead")
            elif full.count(".") == 1 and full.startswith("torch.") \
                    and leaf in _TORCH_DRAWS and not _has_generator(node):
                yield self.finding(
                    ctx, node,
                    f"`{full}(...)` without generator= draws from torch's "
                    f"hidden global generator — pass a seeded "
                    f"torch.Generator so replay stays "
                    f"bitwise-deterministic")
