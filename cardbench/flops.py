"""The yardstick's arithmetic: the card's peaks, a training step's model
FLOPs, and the least time of a kernel launch from its shape.

Frozen copies of ``chip_smoke.py``'s ``train_flops`` and ``flash_bound``.
"""
from __future__ import annotations

from typing import Tuple

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core peak, same source
F32_FLOPS = 67e12                  # float32 outside the tensor cores, same


def causal_pairs(S: int, T: int, window: int = 0) -> float:
    """(query, key) pairs a causal mask keeps when S queries end at key
    T - 1 (S <= T), optionally cut by a window."""
    total = 0.0
    off = T - S
    # query i sees keys 0 .. off + i: min(off + i + 1, window or inf)
    if window <= 0:
        return S * (off + 1) + S * (S - 1) / 2
    for i in range(S):
        total += min(off + i + 1, window)
    return total


def train_flops(port: dict, B: int, S: int) -> float:
    """Model flops of one training step: 6 x the matmul parameters (the
    layers and the head; the embedding is a lookup) x tokens, plus 3 x the
    causal attention forward's two products over the (query, key) pairs
    the masks keep.  Dense GQA layers only (the train cell's model)."""
    d, hd = port["d_model"], port["head_dim"]
    per_layer = (d * hd * (2 * port["n_heads"] + 2 * port["n_kv_heads"])
                 + 3 * d * port["d_ff"])
    matmul_params = port["n_layers"] * per_layer + d * port["vocab_size"]
    pairs = port["n_layers"] * B * port["n_heads"] * causal_pairs(S, S)
    return 6 * matmul_params * B * S + 3 * pairs * 2 * 2 * hd


def flash_bound(B: int, Hq: int, Hkv: int, S: int, T: int, D: int,
                window: int = 0, isz: int = 2) -> Tuple[float, float, float]:
    """Least seconds of one flash forward launch: q, k, v read once, out
    written once (input dtype), lse written once (f32); two products of D
    multiply-adds over every (q, k) pair the masks keep, at the bf16
    tensor-core peak.  Returns (seconds, bytes, flops)."""
    keys = causal_pairs(S, T, window)
    byts = (2 * B * Hq * S * D + 2 * B * Hkv * T * D) * isz + B * Hq * S * 4
    flops = B * Hq * keys * 2 * 2 * D
    peak = BF16_FLOPS if isz == 2 else F32_FLOPS
    return max(byts / HBM_BYTES_PER_S, flops / peak), byts, flops

