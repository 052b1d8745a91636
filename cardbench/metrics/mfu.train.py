"""mfu.train: model FLOPs of the window's training steps (a frozen copy of
``chip_smoke.py::train_flops``: 6 x matmul parameters x tokens + 3 x the
causal attention forward, recompute not counted) over the window's
host-clock time, as a percent of the card's bf16 peak."""
from cardbench import flops


def read(run):
    if run.get("kind") != "train" or not run["steps"]:
        return None
    per_step = flops.train_flops(run["port"], run["batch"], run["seq_len"])
    return (100.0 * per_step * run["steps"] / run["window_s"]
            / flops.BF16_FLOPS)
