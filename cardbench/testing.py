"""Tiny copies of the cells for the CPU tests: the same files, drivers and
checks, with each configuration cut to a few hundred thousand parameters
and each mix to a few short rows, run on the CPU (the kernels' plain
versions)."""
from __future__ import annotations

import copy
import sys

from cardbench import manifest

TRAIN = "qwen3-8b-8l.train"


def _program_on_path() -> None:
    src = str(manifest.ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def tiny_cell(name: str) -> manifest.Cell:
    _program_on_path()
    c = manifest.cell(manifest.load_manifest(), name)
    c.config = copy.deepcopy(c.config)
    c.workload = copy.deepcopy(c.workload)
    c.config["port"].update(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, d_ff=128, vocab_size=512)
    c.mix = dict(c.mix, batch=2, seq_len=32, pool=4)
    return c


def run_tiny(c: manifest.Cell, seed: int, fault: str = "",
             seconds: float = 0.5) -> dict:
    import time
    driver = manifest.load_module("drivers", c.driver)
    return driver.run(c, seed=seed, seconds=seconds, trace_on=False,
                      device="cpu", t_start=time.time(), fault=fault)
