"""attn_fwd_roofline.train: the attention forward's share of its roofline
in the traced steps, read from the program's own ``attn.forward`` spans
(one per call of ``FlashAttention.forward``, the remat's recompute
included): the least time of each call at its own shape
(``flops.flash_bound``) over the spans' device time, both summed.  It
reads whatever implements the forward, not kernels found by name."""
from cardbench import spans


def read(run):
    if run.get("kind") != "train":
        return None
    return spans.share(spans.timed("attn.forward"),
                       lambda a: spans.attn_fwd(a)[0])
