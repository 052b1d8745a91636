"""repro_torch.analysis — the port's static checker.

Parity with the JAX package's ``repro.analysis`` on the same inputs (the
shared helpers over every file of ``src/`` and ``tests/``, ALLOC001's
findings, DET001 on the JAX file's own fixtures, the baseline file and
the reports), flagged and clean fixtures for each of the eight rules
(with suppression and path scoping), drift caught in mutated copies of
the real kernel sources, and the CLI on the shipped tree.

Fixture sources are analyzed in memory with a fake repo-relative path;
fixtures that show a bare ``.free(...)`` are strings, never code, so the
JAX package's own lint (which scans this file) stays clean.
"""
import ast
import io
import json
import re
import shutil
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.analysis as JA  # noqa: E402
from repro.analysis import baseline as jbaseline  # noqa: E402
from repro.analysis import core as jcore  # noqa: E402
from repro.analysis import reporters as jreporters  # noqa: E402
from repro_torch import analysis as TA  # noqa: E402
from repro_torch.analysis import baseline as tbaseline  # noqa: E402
from repro_torch.analysis import core as tcore  # noqa: E402
from repro_torch.analysis import reporters as treporters  # noqa: E402
from repro_torch.analysis.rules import krn001  # noqa: E402

ROOT = TA.repo_root()
SERVE = "src/repro_torch/serve/mod.py"
KERN = "src/repro_torch/kernels/mod.py"
MODELS = "src/repro_torch/models/mod.py"
RULE_IDS = ("ALLOC001", "DET001", "FBK001", "GRAD001", "HOT001", "KRN001",
            "KRN002", "SYNC001")


def lint(src, rel=SERVE, only=None, root=None):
    return TA.analyze_source(src, rel, only=only, root=root)


def rules_of(findings):
    return [f.rule for f in findings]


def fields(findings):
    return [(f.rule, f.path, f.line, f.col, f.symbol, f.message)
            for f in findings]


def to_port(text):
    """A source as the port's checker reads it: each package honours its
    own suppression comment."""
    return text.replace("repro-lint:", "repro-torch-lint:")


# ---------------------------------------------------------------------------
# parity with repro.analysis
# ---------------------------------------------------------------------------

SHARED = [p for p in jcore.iter_py_files(ROOT, ["src", "tests"])]


def test_shared_helpers_equal_jax_on_every_file():
    """symbol_at (every line), ImportMap.names and int_env of every .py
    under src/ and tests/ equal the JAX package's."""
    assert len(SHARED) > 200
    for path in SHARED:
        text = path.read_text()
        rel = path.relative_to(ROOT).as_posix()
        jc = jcore.ModuleContext(text, rel)
        tc = tcore.ModuleContext(text, rel)
        assert tc.imports.names == jc.imports.names, rel
        assert tc.module_ints == jc.module_ints == jcore.int_env(jc.tree), rel
        assert tcore.int_env(tc.tree) == jc.module_ints, rel
        assert tc._symbols == jc._symbols, rel
        for line in range(1, len(tc.lines) + 2):
            assert tc.symbol_at(line) == jc.symbol_at(line), (rel, line)


def test_alloc001_findings_equal_jax_over_src_and_tests():
    jrep = jcore.run_analysis(ROOT, paths=["src", "tests"], only=["ALLOC001"])
    port, n_sup = [], 0
    for path in SHARED:
        rel = path.relative_to(ROOT).as_posix()
        sup = []
        port += TA.analyze_source(to_port(path.read_text()), rel,
                                  only=["ALLOC001"], count_suppressed=sup)
        n_sup += sup[0]
    assert jrep.findings, "no ALLOC001 finding left to compare"
    assert fields(port) == fields(jrep.findings)
    assert n_sup == jrep.suppressed >= 1


def _jax_det001_cases():
    """(source, rel) pairs of the DET001 tests of tests/test_analysis.py:
    every multi-line string in them, at every path those tests use."""
    tree = ast.parse((ROOT / "tests" / "test_analysis.py").read_text())
    sources = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "DET_TP"
                for t in node.targets):
            sources.append(node.value.value)
        elif isinstance(node, ast.FunctionDef) and (
                node.name.startswith("test_det001")
                or node.name == "test_inline_suppression_by_rule_and_all"):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                        and "\n" in sub.value:
                    sources.append(sub.value)
    base = next(s for s in sources if "{comment}" in s)
    sources = [s for s in sources if s is not base] + [
        base.format(comment=c) for c in (
            "", "  # repro-lint: disable=DET001", "  # repro-lint: disable=all",
            "  # repro-lint: disable=HOT001")]
    rels = ["src/repro/serve/mod.py", "src/repro/train/mod.py",
            "tests/test_mod.py", "src/repro/core/mod.py",
            "src/repro/models/mod.py", "src/repro/kernels/mod.py"]
    return [(s, r) for s in sources for r in rels]


DET_CASES = _jax_det001_cases()


def test_det001_jax_fixtures_found_and_relocated():
    assert len(DET_CASES) >= 6 * 6
    assert any(jcore.analyze_source(s, r, only=["DET001"])
               for s, r in DET_CASES)


@pytest.mark.parametrize("i", range(len(DET_CASES)))
def test_det001_same_lines_as_jax_on_its_fixtures(i):
    src, rel = DET_CASES[i]
    port_rel = rel.replace("src/repro/", "src/repro_torch/")
    jf = jcore.analyze_source(src, rel, only=["DET001"])
    tf = TA.analyze_source(to_port(src), port_rel, only=["DET001"])
    assert [(f.line, f.col, f.symbol, f.message) for f in tf] \
        == [(f.line, f.col, f.symbol, f.message) for f in jf]


DET_TP = """
import random
import time
import numpy as np

def pick(xs):
    if np.random.rand() > 0.5:          # hidden global numpy state
        return random.choice(xs)        # hidden global stdlib state
    return time.time()                  # wall clock
"""


def _twin_findings():
    jf = jcore.analyze_source(DET_TP, "src/repro/serve/mod.py",
                              only=["DET001"])
    tf = [tcore.Finding(**asdict(f)) for f in jf]
    return jf, tf


def test_write_baseline_json_equals_jax(tmp_path):
    jf, tf = _twin_findings()
    extra = jf + [jcore.Finding("HOT001", "src/x.py", 3, 1, "m", "f")]
    textra = [tcore.Finding(**asdict(f)) for f in extra]
    jp, tp = tmp_path / "j.json", tmp_path / "t.json"
    for jfind, tfind in ((jf, tf), (extra, textra), ([], [])):
        old_j = jbaseline.write_baseline(jp, jf)
        old_t = tbaseline.write_baseline(tp, tf)
        old_j.entries[0].justification = old_t.entries[0].justification = "ok"
        jbaseline.write_baseline(jp, jfind, old_j)
        tbaseline.write_baseline(tp, tfind, old_t)
        # byte for byte, but for the comment naming the program
        assert tp.read_text() == jp.read_text().replace(
            "repro-lint findings; see src/repro/analysis",
            "repro-torch-lint findings; see src/repro_torch/analysis")
    assert tbaseline.BASELINE_NAME == ".repro-torch-lint-baseline.json"


def test_apply_baseline_split_equals_jax(tmp_path):
    jf, tf = _twin_findings()
    jbl = jbaseline.write_baseline(tmp_path / "j.json", jf)
    tbl = tbaseline.write_baseline(tmp_path / "t.json", tf)
    more_j = jcore.analyze_source(
        DET_TP + "\n\ndef more():\n    return time.time()\n",
        "src/repro/serve/mod.py", only=["DET001"])
    more_t = [tcore.Finding(**asdict(f)) for f in more_j]
    for jfind, tfind in ((jf, tf), (more_j, more_t), ([], []), (jf[:1],
                                                              tf[:1])):
        jnew, jold, jstale = jbaseline.apply_baseline(jfind, jbl)
        tnew, told, tstale = tbaseline.apply_baseline(tfind, tbl)
        assert fields(tnew) == fields(jnew)
        assert fields(told) == fields(jold)
        assert [asdict(e) for e in tstale] == [asdict(e) for e in jstale]


def _reports():
    import repro.analysis.rules  # noqa: F401  (registers the JAX rules)
    import repro_torch.analysis.rules  # noqa: F401
    jf, tf = _twin_findings()
    jrep = jcore.Report(root="/a", files_scanned=7, findings=list(jf),
                        suppressed=2, parse_errors=["x.py: bad"])
    trep = tcore.Report(root="/b", files_scanned=7, findings=list(tf),
                        suppressed=2, parse_errors=["x.py: bad"])
    jstale = [jbaseline.BaselineEntry("HOT001", "a.py", "f", 2, "why")]
    tstale = [tbaseline.BaselineEntry("HOT001", "a.py", "f", 2, "why")]
    return (jrep, jf[:1], jf[1:], jstale), (trep, tf[:1], tf[1:], tstale)


def test_text_report_equals_jax_but_the_program_name():
    (j, t) = _reports()
    jo, to = io.StringIO(), io.StringIO()
    jreporters.render("text", *j, jo)
    treporters.render("text", *t, to)
    assert "repro-lint:" in jo.getvalue()
    assert to.getvalue() == jo.getvalue().replace("repro-lint:",
                                                  "repro-torch-lint:")


def test_json_report_equals_jax_but_rules_and_root():
    (j, t) = _reports()
    jo, to = io.StringIO(), io.StringIO()
    jreporters.render("json", *j, jo)
    treporters.render("json", *t, to)
    jb, tb = json.loads(jo.getvalue()), json.loads(to.getvalue())
    assert set(tb["rules"]) == set(RULE_IDS)
    for b in (jb, tb):
        del b["rules"], b["root"]
    assert tb == jb


def test_public_names_mirror_jax():
    assert TA.__all__ == JA.__all__
    assert TA.DEFAULT_CONFIG == {}       # no VMEM budget, no knob


# ---------------------------------------------------------------------------
# ALLOC001
# ---------------------------------------------------------------------------

ALLOC_SRC = """
from repro_torch.serve.engine import BlockAllocator

def release(a, blocks):
    a.free(blocks){suffix}
"""


def test_alloc001_bare_free_and_suppression():
    found = lint(ALLOC_SRC.format(suffix=""), only=["ALLOC001"])
    assert rules_of(found) == ["ALLOC001"]
    assert "physically-freed" in found[0].message
    assert lint(ALLOC_SRC.format(
        suffix="  # repro-torch-lint: disable=ALLOC001"),
        only=["ALLOC001"]) == []
    # the JAX package's comment does not silence the port's checker
    assert len(lint(ALLOC_SRC.format(
        suffix="  # repro-lint: disable=ALLOC001"), only=["ALLOC001"])) == 1


def test_alloc001_consumed_or_unrelated_free_is_clean():
    src = """
from repro_torch.serve.engine import BlockAllocator

def release(a, blocks, pool):
    for b in a.free(blocks):
        pool[b] = 0
"""
    assert lint(src, only=["ALLOC001"]) == []
    assert lint("def close(h):\n    h.free()\n", only=["ALLOC001"]) == []


# ---------------------------------------------------------------------------
# DET001 — the torch additions
# ---------------------------------------------------------------------------

DET_TORCH = """
import torch

def init(shape, w, gen):
    a = torch.randn(shape)                      # global generator
    b = torch.rand(shape, generator=gen)        # seeded
    w.normal_(0.0, 0.02)                        # in place, global
    w.uniform_(generator=gen)                   # seeded
    torch.manual_seed(0)                        # reseeds the global one
    torch.cuda.manual_seed_all(0)
    idx = torch.randperm(8, generator=gen)
    return a, b, idx, torch.multinomial(w, 1)
"""


def test_det001_flags_torch_global_generator():
    found = lint(DET_TORCH, rel=MODELS, only=["DET001"])
    assert [f.line for f in found] == [5, 7, 9, 10, 12]
    assert all(f.symbol == "init" for f in found)


def test_det001_scoped_to_the_ports_replay_critical_trees():
    for rel in ("src/repro_torch/core/m.py", SERVE, MODELS, KERN):
        assert lint(DET_TORCH, rel=rel, only=["DET001"]) != []
    for rel in ("src/repro_torch/launch/m.py", "src/repro_torch/train/m.py",
                "src/repro/models/m.py", "tests/test_torch_m.py",
                "chip_smoke.py"):
        assert lint(DET_TORCH, rel=rel, only=["DET001"]) == []


# ---------------------------------------------------------------------------
# HOT001
# ---------------------------------------------------------------------------

HOT_SRC = """
import torch

def scrub(leaves, ids, slots):
    for leaf in leaves:
        idx = torch.as_tensor(ids, device=leaf.device)     # upload a leaf
        leaf[idx] = 0
        for s in slots:
            leaf[s] = leaf[s].to(leaf.dtype)               # once, not twice
    with torch.no_grad():
        pass
    while slots:
        with torch.no_grad():                              # dispatches nothing
            slots.pop()
    return torch.as_tensor(ids)                            # outside: fine
"""


def test_hot001_torch_calls_and_moves_in_loops():
    found = lint(HOT_SRC, only=["HOT001"])
    assert [f.line for f in found] == [6, 9]
    assert "torch.as_tensor" in found[0].message
    assert "`.to(...)`" in found[1].message


def test_hot001_only_in_serve_tree():
    assert lint(HOT_SRC, rel=MODELS, only=["HOT001"]) == []
    assert lint(HOT_SRC, rel="src/repro/serve/m.py", only=["HOT001"]) == []


# ---------------------------------------------------------------------------
# SYNC001
# ---------------------------------------------------------------------------

SYNC_SRC = """
import numpy as np
import torch

def layer(x, mask, n):
    a = x.sum().item()
    b = mask.nonzero()
    c = torch.nonzero(mask, as_tuple=True)
    d = torch.where(mask)
    e = torch.where(mask, x, 0.0)            # three arguments: on device
    f = int(x.amax())
    g = int(np.sum([1, 2]))                  # host numbers
    h = int(max(n, 2))
    torch.cuda.synchronize()
    i = torch.unique(mask)
    j = torch.nonzero_static(mask, size=4)   # sized: no sync
    return x.cpu(), x.tolist(), x.numpy()
"""


def test_sync001_flags_host_syncs_in_layer_code():
    found = lint(SYNC_SRC, rel=MODELS, only=["SYNC001"])
    assert [f.line for f in found] == [6, 7, 8, 9, 11, 14, 15, 17, 17, 17]


def test_sync001_scoped_to_models_and_kernels():
    assert lint(SYNC_SRC, rel=KERN, only=["SYNC001"]) != []
    for rel in (SERVE, "src/repro_torch/launch/m.py", "chip_smoke.py"):
        assert lint(SYNC_SRC, rel=rel, only=["SYNC001"]) == []


# ---------------------------------------------------------------------------
# FBK001
# ---------------------------------------------------------------------------

FBK_SRC = """
import torch
from repro_torch.kernels import build

def pick_device():
    return "cuda" if torch.cuda.is_available() else "cpu"

def pick_device2():
    if not torch.cuda.is_available():
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda")
    return dev

def load_or_plain(x):
    try:
        lib = build.load("quantize")
    except RuntimeError:
        return None                      # swallowed: the plain path runs
    return lib

def load_or_raise():
    try:
        return build.load("quantize")
    except RuntimeError as e:
        raise RuntimeError("no kernel") from e

def build_every(names):
    errors = []
    for n in names:
        try:
            build.build_all()
        except RuntimeError as e:
            errors.append(str(e))        # kept, raised after the loop
    if errors:
        raise RuntimeError("; ".join(errors))

def op(x):
    try:
        return torch.ops.repro_torch.paged_attention(x)
    except Exception:
        return x
"""


def test_fbk001_flags_silent_fallbacks():
    found = lint(FBK_SRC, rel="src/repro_torch/launch/m.py", only=["FBK001"])
    assert [(f.line, f.symbol) for f in found] == [
        (6, "pick_device"), (10, "pick_device2"), (18, "load_or_plain"),
        (41, "op")]
    assert lint(FBK_SRC, rel="chip_smoke.py", only=["FBK001"]) != []
    assert lint(FBK_SRC, rel="examples_torch/m.py", only=["FBK001"]) != []
    assert lint(FBK_SRC, rel="tests/test_torch_m.py", only=["FBK001"]) == []


WRAPPER = """
import torch
from repro_torch.kernels.ref import thing_ref

def thing_fwd(x):
    if x.device.type == "cpu":
        return thing_ref(x)
    if x.device.type != "cpu":
        pass
    else:
        y = thing_ref(x)
    return thing_ref(x)                  # a CUDA tensor reaches the plain path
"""


def test_fbk001_plain_version_only_in_the_cpu_branch():
    found = lint(WRAPPER, rel=KERN, only=["FBK001"])
    assert [f.line for f in found] == [12]
    assert lint(WRAPPER, rel="src/repro_torch/kernels/ref.py",
                only=["FBK001"]) == []
    assert lint(WRAPPER, rel=MODELS, only=["FBK001"]) == []


# ---------------------------------------------------------------------------
# GRAD001
# ---------------------------------------------------------------------------

GRAD_SRC = """
import ctypes
import torch
from repro_torch.kernels import build, refuse_autograd

def _lib():
    return build.load("quantize")

def bare(x, q):
    return _lib().int8_quantize_fwd(x.data_ptr(), q.data_ptr())

def guarded(x, q):
    if x.device.type == "cpu":
        return x
    refuse_autograd("k", x)
    return _lib().int8_quantize_fwd(x.data_ptr(), q.data_ptr())

def guard_in_branch(x, q, check):
    if check:
        refuse_autograd("k", x)          # not on every path
    lib = _lib()
    return lib.int8_quantize_fwd(x.data_ptr(), q.data_ptr())

def under_no_grad(x, q):
    with torch.no_grad():
        return _lib().int8_quantize_fwd(x.data_ptr(), q.data_ptr())

@torch.no_grad()
def decorated(x, q):
    return _lib().int8_quantize_fwd(x.data_ptr(), q.data_ptr())

def host_query(n):
    return _lib().int8_quantize_fwd(n, n)      # no device memory handed over

def via_op(x):
    return torch.ops.repro_torch.mine(x)

def via_diff_op(x):
    return torch.ops.repro_torch.diff(x)

class K(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q):
        return _lib().int8_quantize_fwd(x.data_ptr(), q.data_ptr())

@torch.library.custom_op("repro_torch::mine", mutates_args=())
def _mine(x: torch.Tensor) -> torch.Tensor:
    return _lib().int8_quantize_fwd(x.data_ptr(), x.data_ptr())

@torch.library.custom_op("repro_torch::diff", mutates_args=())
def _diff(x: torch.Tensor) -> torch.Tensor:
    return _lib().int8_quantize_fwd(x.data_ptr(), x.data_ptr())

_diff.register_autograd(lambda ctx, g: g)
"""


def test_grad001_flags_unguarded_launches():
    found = lint(GRAD_SRC, rel=KERN, only=["GRAD001"])
    assert [(f.line, f.symbol) for f in found] == [
        (10, "bare"), (22, "guard_in_branch"), (36, "via_op")]
    assert "torch.ops.repro_torch.mine" in found[2].message


def test_grad001_scope_and_suppression():
    assert lint(GRAD_SRC, rel="src/repro_torch/core/m.py",
                only=["GRAD001"]) != []
    assert lint(GRAD_SRC, rel="chip_smoke.py", only=["GRAD001"]) == []
    src = GRAD_SRC.replace(
        "    return _lib().int8_quantize_fwd(x.data_ptr(), q.data_ptr())\n\n"
        "def guarded",
        "    return _lib().int8_quantize_fwd(x.data_ptr(), q.data_ptr())"
        "  # repro-torch-lint: disable=GRAD001\n\ndef guarded")
    assert [f.symbol for f in lint(src, rel=KERN, only=["GRAD001"])] == [
        "guard_in_branch", "via_op"]


# ---------------------------------------------------------------------------
# KRN001 / KRN002 on fixtures
# ---------------------------------------------------------------------------

FIXTURE_CU = """
// a comment with an apostrophe's quote and extern "C" { not a block }
#include <cstdint>
__global__ void k(const float* x) { if (x) { asm volatile("{ .reg .b32 r; }"); } }
extern "C" {
int f_fwd(const void* x, void* y, int64_t n, int block, float s,
          void* stream) {
  char c = '}';
  return n > 0 ? 0 : 1;
}
long long f_bytes(int a, int b) { return (long long)a * b; }
int f_none(void) { return 3; }
}  // extern "C"
extern "C" double f_single(unsigned long long n);
"""

FIXTURE_PY = """
import ctypes
from repro_torch.kernels import build


def _lib():
    lib = build.load("fixture")
    if not getattr(lib, "_typed", False):
        p, i, f, i64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                        ctypes.c_int64)
        lib.f_fwd.argtypes = [p] * 2 + [i64, i, f] + [p]
        lib.f_fwd.restype = ctypes.c_int
        lib.f_bytes.argtypes = [i] * 2
        lib.f_bytes.restype = ctypes.c_longlong
        lib.f_none.argtypes = []
        lib.f_none.restype = ctypes.c_int
        for fn in ("f_single",):
            getattr(lib, fn).argtypes = [i]          # dynamic: skipped
        lib._typed = True
    return lib


def run(x, y, n):
    return _lib().f_fwd(x, y, n, 256, 1.0, None)
"""


def _fixture_root(tmp_path, cu=FIXTURE_CU, py=FIXTURE_PY):
    kern = tmp_path / "src" / "repro_torch" / "kernels"
    (kern / "csrc").mkdir(parents=True)
    (kern / "csrc" / "fixture.cu").write_text(cu)
    (kern / "fixture.py").write_text(py)
    return tmp_path


def test_parse_exports_reads_blocks_and_single_declarations():
    ex = krn001.parse_exports(FIXTURE_CU, "fixture.cu")
    assert sorted(ex) == ["f_bytes", "f_fwd", "f_none", "f_single"]
    assert ex["f_fwd"].param_kinds == ("ptr", "ptr", "i64", "i32", "f32",
                                       "ptr")
    assert ex["f_fwd"].line == 6 and ex["f_fwd"].ret_kind == "i32"
    assert ex["f_bytes"].ret_kind == "i64"
    assert ex["f_none"].params == ()
    assert ex["f_single"].ret_kind == "f64"
    assert ex["f_single"].param_kinds == ("u64",)
    assert krn001.ctype_kind("c_long") == krn001.ctype_kind("c_longlong") \
        == "i64"
    assert krn001.ctype_kind(None) == "void"
    assert krn001.ctype_kind("LP_c_float") == "ptr"


def _krn001(root):
    rep = TA.run_analysis(root, paths=["src/repro_torch/kernels"],
                          only=["KRN001"])
    assert rep.parse_errors == []
    return rep.findings


def test_krn001_fixture_clean(tmp_path):
    assert _krn001(_fixture_root(tmp_path)) == []


@pytest.mark.parametrize("old,new,where,what", [
    ("[p] * 2 + [i64, i, f] + [p]", "[p] * 2 + [i, i, f] + [p]", "py",
     "argtypes[2] of `f_fwd` is 32-bit int"),
    ("[p] * 2 + [i64, i, f] + [p]", "[p] * 2 + [i64, i] + [p]", "py",
     "argtypes of `f_fwd` has 5 entries; csrc/fixture.cu:6 declares 6"),
    ("        lib.f_bytes.restype = ctypes.c_longlong\n", "", "py",
     "`f_bytes` has argtypes but no restype"),
    ("lib.f_bytes.restype = ctypes.c_longlong", "lib.f_bytes.restype = "
     "ctypes.c_int", "py", "restype of `f_bytes` is 32-bit int"),
    ("1.0, None)", "1.0, None, 0)", "py", "called with 7 arguments"),
    ("lib.f_none.argtypes", "lib.f_gone.argtypes", "py",
     "`f_gone` is bound but fixture.cu declares no"),
    ("int block, float s", "int block, double s", "cu",
     "argtypes[4] of `f_fwd` is 32-bit float"),
])
def test_krn001_fixture_drift(tmp_path, old, new, where, what):
    cu, py = FIXTURE_CU, FIXTURE_PY
    if where == "py":
        assert old in py
        py = py.replace(old, new)
    else:
        assert old in cu
        cu = cu.replace(old, new)
    found = _krn001(_fixture_root(tmp_path, cu, py))
    assert found and what in found[0].message, fields(found)
    # a dropped entry also shows at the call, which passes the C count
    assert len(found) == 1 + ("has 5 entries" in what), fields(found)


KRN2_SRC = """
import torch
from torch.utils.flop_counter import register_flop_formula

@torch.library.custom_op("repro_torch::thing", mutates_args=(),
                         device_types="cuda")
def _thing_cuda(x: torch.Tensor) -> torch.Tensor:
    return x

@_thing_cuda.register_fake
def _(x):
    return x.new_empty(x.shape)

@register_flop_formula(torch.ops.repro_torch.thing)
def _(x_shape, *args, out_shape=None, **kwargs) -> int:
    return 2
"""


def test_krn002_fixture_clean_and_each_half_missing():
    assert lint(KRN2_SRC, rel=KERN, only=["KRN002"]) == []
    no_fake = KRN2_SRC.replace("@_thing_cuda.register_fake", "")
    found = lint(no_fake, rel=KERN, only=["KRN002"])
    assert len(found) == 1 and "register_fake" in found[0].message
    assert found[0].symbol == "_thing_cuda"
    no_flop = KRN2_SRC.replace(
        "@register_flop_formula(torch.ops.repro_torch.thing)", "")
    found = lint(no_flop, rel=KERN, only=["KRN002"])
    assert len(found) == 1 and "register_flop_formula" in found[0].message
    assert lint(no_flop, rel=MODELS, only=["KRN002"]) == []


# ---------------------------------------------------------------------------
# drift on the real kernel sources
# ---------------------------------------------------------------------------

KERNELS = ROOT / "src" / "repro_torch" / "kernels"


def _kernel_copy(tmp_path):
    dst = tmp_path / "src" / "repro_torch" / "kernels"
    shutil.copytree(KERNELS, dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _mutate(path, old, new):
    text = path.read_text()
    assert text.count(old) == 1, f"fixture out of date: {old!r}"
    path.write_text(text.replace(old, new))


def test_real_kernels_clean_under_krn_and_grad_rules():
    rep = TA.run_analysis(ROOT, paths=["src/repro_torch/kernels"],
                          only=["KRN001", "KRN002", "GRAD001"])
    assert rep.files_scanned >= 8 and rep.parse_errors == []
    assert rep.findings == [], "\n".join(f.format() for f in rep.findings)
    exports = krn001.load_exports(KERNELS / "csrc")
    assert len(exports) == 17
    assert {f.source for f in exports.values()} == {
        f"{s}.cu" for s in ("flash_attention", "mamba_scan",
                            "paged_attention", "quantize", "rwkv_scan")}


@pytest.mark.parametrize("file,old,new,what", [
    ("quantize.py", "[p, p, p, i64, i64, i, i, i, p]",
     "[p, p, p, i64, i, i, i, p]",
     "argtypes of `int8_quantize_fwd` has 8 entries"),
    ("csrc/quantize.cu", "int64_t rows, int block,", "int64_t rows, "
     "int64_t block,", "argtypes[5] of `int8_quantize_fwd` is 32-bit int"),
    ("quantize.py", "_DTYPES[x.dtype], vec_ok,\n", "_DTYPES[x.dtype], vec_ok, "
     "0,\n", "`int8_quantize_fwd(...)` is called with 10 arguments"),
])
def test_krn001_catches_drift_in_real_kernel_copies(tmp_path, file, old, new,
                                                    what):
    kern = _kernel_copy(tmp_path)
    assert _krn001(tmp_path) == []
    _mutate(kern / file, old, new)
    found = _krn001(tmp_path)
    assert found and what in found[0].message, fields(found)
    assert len(found) == 1 + ("has 8 entries" in what), fields(found)


def test_krn002_catches_a_missing_flop_formula_in_a_real_copy(tmp_path):
    kern = _kernel_copy(tmp_path)
    _mutate(kern / "mamba_scan.py",
            "@register_flop_formula(torch.ops.repro_torch.mamba_scan)\n", "")
    found = TA.run_analysis(tmp_path, paths=["src/repro_torch/kernels"],
                            only=["KRN002"]).findings
    assert [(f.path, f.symbol) for f in found] == [
        ("src/repro_torch/kernels/mamba_scan.py", "_mamba_scan_cuda")]


@pytest.mark.parametrize("file,guard,symbol", [
    ("paged_attention.py",
     '    refuse_autograd("paged_attention", q, k, v, q_extra, k_extra)\n',
     "paged_attention_fwd"),
    ("flash_attention.py", '    refuse_autograd("flash_attention", q, k, v)\n',
     "flash_attention_fwd"),
    ("quantize.py", '    refuse_autograd("int8_quantize", x)\n',
     "int8_quantize_fwd"),
    ("quantize.py", '    refuse_autograd("int8_dequantize", scales)\n',
     "int8_dequantize_fwd"),
])
def test_grad001_catches_a_wrapper_without_its_guard(tmp_path, file, guard,
                                                     symbol):
    kern = _kernel_copy(tmp_path)
    _mutate(kern / file, guard, "")
    found = TA.run_analysis(tmp_path, paths=["src/repro_torch/kernels"],
                            only=["GRAD001"]).findings
    assert [(f.path, f.symbol) for f in found] == [
        (f"src/repro_torch/kernels/{file}", symbol)]


# ---------------------------------------------------------------------------
# the shipped tree and the CLI
# ---------------------------------------------------------------------------

def _cli(*args, cwd=None):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd or str(ROOT), timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": "/tmp"})


def test_cli_strict_exits_zero_on_shipped_tree():
    proc = _cli("--strict")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new finding(s)" in proc.stdout
    m = re.search(r"repro-torch-lint: (\d+) file\(s\)", proc.stdout)
    assert m and int(m.group(1)) > 100
    baseline = TA.load_baseline(ROOT / tbaseline.BASELINE_NAME)
    assert baseline.entries
    assert all(e.justification and not e.justification.startswith("TODO")
               for e in baseline.entries)
    # KRN001, KRN002 and GRAD001 hold with no grandfathered entry
    assert not {e.rule for e in baseline.entries} & {"KRN001", "KRN002",
                                                      "GRAD001"}


def test_default_paths_are_the_ports_files():
    files = {p.relative_to(ROOT).as_posix()
             for p in TA.iter_py_files(ROOT)}
    assert "chip_smoke.py" in files
    assert "tests/test_torch_analysis.py" in files
    assert "tests/_torch_cpu.py" in files
    assert any(f.startswith("examples_torch/") for f in files)
    assert not any(f.startswith(("src/repro/", "tests/test_analysis"))
                   for f in files)


def test_cli_unknown_rule_is_usage_error():
    proc = _cli("--only", "NOPE999")
    assert proc.returncode == 2
    assert "unknown rule" in proc.stderr


def test_cli_list_rules_names_all_eight():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    listed = re.findall(r"^([A-Z]+\d{3})  ", proc.stdout, flags=re.M)
    assert listed == sorted(RULE_IDS)
    assert proc.stdout.count("why: ") == 8


def _bad_root(tmp_path):
    pkg = tmp_path / "src" / "repro_torch" / "serve"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text(
        "import time\n\n\ndef stamp():\n    return time.time()\n")
    return tmp_path


def test_cli_json_report_and_only_filter(tmp_path):
    root = _bad_root(tmp_path)
    out = tmp_path / "report.json"
    proc = _cli("--root", str(root), "--only", "DET001,HOT001",
                "--format", "json", "--output", str(out))
    assert proc.returncode == 1
    blob = json.loads(out.read_text())
    assert blob["summary"]["new"] == 1
    assert blob["summary"]["by_rule"] == {"DET001": 1}
    assert blob["files_scanned"] == 1


def test_cli_baseline_write_then_strict_then_expiry(tmp_path):
    root = _bad_root(tmp_path)
    bad = root / "src" / "repro_torch" / "serve" / "bad.py"
    assert _cli("--root", str(root)).returncode == 1
    proc = _cli("--root", str(root), "--write-baseline")
    assert proc.returncode == 0 and "1 baseline entry" in proc.stdout
    assert "justification" in proc.stdout
    assert (root / ".repro-torch-lint-baseline.json").exists()
    assert _cli("--root", str(root), "--strict").returncode == 0
    bad.write_text("def stamp(tick):\n    return tick\n")
    assert _cli("--root", str(root)).returncode == 0
    proc = _cli("--root", str(root), "--strict")
    assert proc.returncode == 1 and "stale" in proc.stdout
