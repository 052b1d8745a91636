"""adamw_roofline.train: the optimizer's share of its roofline in the
traced steps, read from the program's own ``train.optimizer`` spans
(around ``optimizer.update`` in ``train_step``).  The least time of one
update is its elements x 28 bytes over HBM bandwidth: the gradient read
once in bf16 (2), the float32 master weights, first and second moments
each read and written (24), the bf16 weight written (2).  Elements are
the model's parameters (``model.param_specs``).  The clip norm's read of
the gradients is not counted, so the bound is a floor."""
import math

from cardbench import flops, model, spans

BYTES_PER_ELEMENT = 28


def bound_s(port: dict) -> float:
    n = sum(math.prod(s.shape) for s in model.param_specs(port))
    return n * BYTES_PER_ELEMENT / flops.HBM_BYTES_PER_S


def read(run):
    if run.get("kind") != "train":
        return None
    t = bound_s(run["port"])
    return spans.share(spans.timed("train.optimizer"), lambda a: t)
