"""A traced run of the training cell on the card (marked ``card``; it skips
inside its fixture where torch sees no CUDA device): the program's spans
give the three span metrics, each read and at most 100 %, and the
attention forward's share read from its spans sits within 1.5 points of
``flash_roofline.train``, read from the flash kernels by name."""
import json
import os
import subprocess
import sys

import pytest

from cardbench import manifest, testing

SPAN_METRICS = ("attn_fwd_roofline.train", "attn_bwd_roofline.train",
                "adamw_roofline.train")


@pytest.mark.card
def test_traced_train_run_reads_the_span_metrics(card):
    out = subprocess.run(
        [sys.executable, "-m", "cardbench", "--workload", testing.TRAIN,
         "--seed", "4000000002", "--seconds", "10", "--trace", "1"],
        cwd=manifest.ROOT, env=dict(os.environ), capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    got = {k: m["value"] for k, m in line["metrics"].items()}
    for name in SPAN_METRICS:
        assert name in got, sorted(got)
        assert 0 < got[name] <= 100, (name, got[name])
    assert abs(got["attn_fwd_roofline.train"]
               - got["flash_roofline.train"]) <= 1.5, got
