"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (compared whole: ``repro_torch`` is the
program), the plain references nothing of the program either, and a
checkout holding only the benchmark gives no result."""
import json
import os
import shutil
import subprocess
import sys

from cardbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

WALK = r"""
import json, sys
sys.path.insert(0, "src")
from cardbench import manifest, run, calibrate, testing, check, flops, model, trace, traffic
m = manifest.load_manifest()
for w in m["workloads"]:
    c = manifest.cell(m, w["name"])
    manifest.load_module("drivers", c.driver)
    manifest.load_module("reference", c.config["reference"])
for p in m["per_layer"]:
    manifest.load_module("metrics", p["name"])
testing.run_tiny(testing.tiny_cell(testing.TRAIN), seed=3)
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""

REF_ONLY = r"""
import json, sys
from cardbench import manifest
m = manifest.load_manifest()
for c in m["configs"]:
    data = json.loads((manifest.ROOT / c["file"]).read_text())
    manifest.load_module("reference", data["reference"])
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def _modules(code):
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    mods = _modules(WALK)
    assert "repro_torch" in mods and "torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN
    assert run_forbidden_names() == FORBIDDEN


def run_forbidden_names():
    from cardbench import run
    return set(run.FORBIDDEN)


def test_references_import_nothing_of_the_program():
    mods = _modules(REF_ONLY)
    assert not mods & (FORBIDDEN | {"repro_torch"})


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from cardbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert run.forbidden_modules() == sorted(
        {k.split(".")[0] for k in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.PACKAGE, tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(
        [sys.executable, "-m", "cardbench", "--workload",
         "qwen3-8b-8l.train", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
