"""flash_roofline.train: the flash forward's share of its roofline in the
traced steps: launches x the least time of one launch at the cell's
shape (``flops.flash_bound``: causal, B x Hq x S x D of the batch and
model) over the device time of the kernels named ``flash_fwd*`` (flash
has no op range of its own yet, so its kernels are matched by name)."""
from cardbench import flops


def read(run):
    tr = run.get("trace")
    if run.get("kind") != "train" or not tr:
        return None
    ks = [(a, b) for name, a, b in tr["kernels"] if "flash_fwd" in name]
    if not ks:
        return None
    p, S = run["port"], run["seq_len"]
    bound, _, _ = flops.flash_bound(run["batch"], p["n_heads"],
                                    p["n_kv_heads"], S, S, p["head_dim"])
    return 100.0 * len(ks) * bound / (sum(b - a for a, b in ks) * 1e-6)
