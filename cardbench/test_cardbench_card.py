"""Runs of the benchmark on the card (marked ``card``; they skip inside
their fixture where torch sees no CUDA device): one short run of each
cell, its result line and its check."""
import json
import os
import subprocess
import sys

import pytest

from cardbench import manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "cardbench", "--workload", cell, "--seed",
         "4000000001", "--seconds", "10", "--trace", "0"],
        cwd=manifest.ROOT, env=dict(os.environ), capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu"
