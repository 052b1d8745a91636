"""Public wrappers of the port's kernels — model code calls these, never
a kernel library directly.  Each runs its hand-written CUDA kernel on
CUDA tensors and its plain PyTorch version on CPU tensors (see the
kernel modules)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.paged_attention import paged_attention_fwd


def paged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pos: torch.Tensor, table: torch.Tensor,
                    q_pos: torch.Tensor, *, scale: Optional[float] = None,
                    window: int = 0, softcap: float = 0.0,
                    q_extra: Optional[torch.Tensor] = None,
                    k_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged single-token decode attention over a block-table pool.

    q: (B,1,Hq,D); k/v: (N,page,Hkv,D*) pools; pos: (N,page); table:
    (B,n_cols); q_pos: (B,1) -> (B,1,Hq,Dv).  Same signature as
    ``repro.kernels.ops.paged_attention``."""
    return paged_attention_fwd(q, k, v, pos, table, q_pos, scale=scale,
                               window=window, softcap=softcap,
                               q_extra=q_extra, k_extra=k_extra)
