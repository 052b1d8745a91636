"""Loss functions.  Cross entropy is computed chunked over the tokens
with a recomputed body, so the (B, S, vocab) float32 logits are never
alive at once — the counterpart of ``repro.train.loss``.  At qwen3-8b's
vocabulary (151,936) one 1,024-row chunk's float32 logits take 622 MB.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IGNORE = -1


def _ce_of_logits(logits: torch.Tensor, labels: torch.Tensor,
                  z_coef: float):
    """logits (N,V) f32, labels (N,).  Returns (sum_nll, sum_z, n_valid)."""
    valid = labels != IGNORE
    lbl = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, 1, lbl[:, None])[:, 0]
    nll = (lse - picked) * valid
    z = lse.square() * valid
    return nll.sum(), z_coef * z.sum(), valid.sum()


def cross_entropy_chunked(h: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512,
                          z_coef: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h: (B,S,d); head: (d,V); labels: (B,S) with IGNORE masking.
    Returns (mean loss, accuracy: mean correct@1).  Each chunk of
    ``chunk x B`` rows (padding rows labelled IGNORE) runs under
    ``torch.utils.checkpoint``: its logits are recomputed in the backward
    pass instead of kept, as the JAX version's ``jax.checkpoint`` does."""
    B, S, d = h.shape
    N = B * S
    hf = h.reshape(N, d)
    lf = labels.reshape(N)
    c = min(chunk * max(1, B), N)
    n_chunks = -(-N // c)
    pad = n_chunks * c - N
    if pad:
        hf = F.pad(hf, (0, 0, 0, pad))
        lf = F.pad(lf, (0, pad), value=IGNORE)

    def body(hc, lc):
        logits = (hc @ head.to(hc.dtype)).float()
        nll, z, n = _ce_of_logits(logits, lc, z_coef)
        hit = ((logits.argmax(-1) == lc) & (lc != IGNORE)).sum()
        return nll, z, n, hit

    s_nll = s_z = torch.zeros((), dtype=torch.float32, device=h.device)
    s_n = s_hit = torch.zeros((), dtype=torch.int64, device=h.device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        nll, z, n, hit = checkpoint(body, hf[sl], lf[sl], use_reentrant=False)
        s_nll, s_z, s_n, s_hit = s_nll + nll, s_z + z, s_n + n, s_hit + hit
    n = s_n.clamp(min=1)
    return (s_nll + s_z) / n, s_hit / n
