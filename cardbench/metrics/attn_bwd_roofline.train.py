"""attn_bwd_roofline.train: the attention backward's share of its roofline
in the traced steps, read from the program's own ``attn.backward`` spans
(one per call of ``FlashAttention.backward``).  The least time of a call
is the larger of

* bytes / HBM bandwidth: q, o, dO read and dq written (B Hq S D each),
  k and v read and dk and dv written (B Hkv T D each), all at the input
  dtype's size, and the logsumexp read in float32;
* 2.5 x the forward's flops at the dtype's peak: five products (S, dV,
  dP, dQ, dK) against the forward's two.

Summed over the spans, over their device time summed."""
from cardbench import flops, spans


def bound(a: dict) -> float:
    B, Hq, Hkv, S, T, D = (a[k] for k in ("B", "Hq", "Hkv", "S", "T", "D"))
    isz = spans.itemsize(a)
    byts = (4 * B * Hq * S * D + 4 * B * Hkv * T * D) * isz + B * Hq * S * 4
    peak = flops.BF16_FLOPS if isz == 2 else flops.F32_FLOPS
    return max(byts / flops.HBM_BYTES_PER_S,
               2.5 * spans.attn_fwd(a)[2] / peak)


def read(run):
    if run.get("kind") != "train":
        return None
    return spans.share(spans.timed("attn.backward"), bound)
