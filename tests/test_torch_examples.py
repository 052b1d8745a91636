"""The port's examples (``examples_torch/*.py``) run on the CPU with
``--device cpu`` at their smallest settings, each as a subprocess, with
their own self-checks as assertions: a failed check exits non-zero.

- ``train_e2e --preset 3m`` for 6 steps, then ``--resume`` from its
  checkpoint in ``tmp_path`` to step 9;
- ``serve_batched --kernel`` for qwen3-8b (paged decode) and rwkv6-7b
  (the RWKV scan): paged == dense, kernel path == scan path, a late
  arrival == ``generate()``;
- ``serve_fleet``: every request completes, a replica's failure and a
  degraded run leave every output bitwise equal to the calm run;
- ``quickstart``: the trained model's generation follows the hash rule;
- ``decentralized_pipeline``: every task is remapped after the failure,
  and ``spmd_pipeline`` in 4 spawned gloo processes equals the
  sequential path;
- ``estimate_cluster`` (analytic): the printed lines equal the JAX
  example's, line for line, for two fleet / model / link triples;
- without ``--device`` the examples ask for the card, and raise on a
  machine without one.

Each subprocess gets one intra-op thread (``OMP_NUM_THREADS=1``), as the
port's test workers do.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(script, *args, package="examples_torch", timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, str(ROOT / package / script),
                           *args], capture_output=True, text=True, env=env,
                          timeout=timeout, cwd=ROOT)


def _ok(proc):
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


def test_train_e2e_trains_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _ok(_run("train_e2e.py", "--preset", "3m", "--steps", "6",
                     "--ckpt-dir", ckpt, "--device", "cpu"))
    assert "e2e-3m" in first and "final loss" in first
    assert sorted(os.listdir(ckpt))          # checkpoints were written
    again = _ok(_run("train_e2e.py", "--preset", "3m", "--steps", "9",
                     "--ckpt-dir", ckpt, "--resume", "--device", "cpu"))
    assert "resumed at step 6" in again
    assert "step     6" in again and "step     5" not in again


@pytest.mark.parametrize("arch", ["qwen3-8b", "rwkv6-7b"])
def test_serve_batched_self_checks(arch):
    out = _ok(_run("serve_batched.py", "--arch", arch, "--kernel",
                   "--device", "cpu"))
    for check in ("late-arrival decode == fresh generate() ✓",
                  "paged decode == dense decode ✓",
                  "kernel decode == scan-path decode ✓"):
        assert check in out, out


def test_serve_fleet_self_checks():
    out = _ok(_run("serve_fleet.py", "--device", "cpu"))
    assert "outputs bitwise-equal to the no-failure run ✓" in out
    assert "straggler drained, partition healed, outputs bitwise-equal ✓" \
        in out


def test_quickstart_learns_the_hash_rule():
    out = _ok(_run("quickstart.py", "--device", "cpu"))
    assert "hash-rule hits in generation:" in out


def test_decentralized_pipeline_with_its_spawned_tail():
    out = _ok(_run("decentralized_pipeline.py", "--device", "cpu"))
    assert "all tasks remapped to online nodes ✓" in out
    assert ("spmd_pipeline over 4 gloo processes on cpu (point-to-point "
            "GPipe, direct): max err vs sequential 0.00e+00") in out


@pytest.mark.parametrize("args", [
    ("--fleet", "rtx3080:50", "--model", "bert-large", "--link",
     "wan_1gbps"),
    ("--fleet", "h100:4,rtx4090:2", "--model", "gpt3-24l", "--link",
     "nvlink", "--batch", "8", "--seq", "256"),
])
def test_estimate_cluster_prints_the_jax_example_line_for_line(args):
    port = _ok(_run("estimate_cluster.py", *args, "--device", "cpu"))
    ref = _ok(_run("estimate_cluster.py", *args, package="examples"))
    assert port.splitlines() == ref.splitlines()
    assert "single-batch latency" in port


def test_examples_ask_for_the_card_by_default():
    """This torch has no CUDA: without ``--device cpu`` an example raises
    before it computes anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    proc = _run("estimate_cluster.py")
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
