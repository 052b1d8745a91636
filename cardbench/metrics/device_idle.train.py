"""device_idle.train: percent of the traced training steps' wall time in
which no kernel ran (the union of the kernels' intervals on the
profiler's timeline, not a sum of kernel times)."""
from cardbench import trace


def read(run):
    return trace.idle_share(run.get("trace")) if run.get("kind") == "train" else None
