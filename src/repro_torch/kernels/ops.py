"""Public wrappers of the port's kernels — model code calls these, never
a kernel library directly.  Each runs its hand-written CUDA kernel on
CUDA tensors and its plain PyTorch version on CPU tensors (see the
kernel modules)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.mamba_scan import mamba_scan_fwd
from repro_torch.kernels.paged_attention import paged_attention_fwd
from repro_torch.kernels.quantize import (DEFAULT_BLOCK, int8_dequantize_fwd,
                                          int8_quantize_fwd)
from repro_torch.kernels.rwkv_scan import rwkv_scan_fwd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Dense forward attention with index masks (causal and / or a
    sliding window), GQA through ``h // G``: q (B,Hq,S,D), k / v
    (B,Hkv,T,D) contiguous -> (B,Hq,S,D).  The signature and result of
    ``repro.kernels.ops.flash_attention`` (without its TPU block sizes);
    differentiable, with kernels as the forward and the backward (the
    backward's plain route for float32 and D > 128; see
    ``kernels.flash_attention``)."""
    return FlashAttention.apply(q, k, v, causal, window, scale)


def int8_quantize(x: torch.Tensor, *, block: int = DEFAULT_BLOCK):
    """x: any shape -> (codes int8 (n_rows, block), scales f32 (n_rows, 1)).
    Rows are contiguous ``block``-element groups of the flattened input.
    The signature and result of ``repro.kernels.ops.int8_quantize``."""
    return int8_quantize_fwd(x, block=block)


def int8_dequantize(q: torch.Tensor, scales: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    """(codes, scales) -> ``code * scale`` as ``dtype`` of ``shape``.  The
    signature and result of ``repro.kernels.ops.int8_dequantize``."""
    return int8_dequantize_fwd(q, scales, shape, dtype)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, a: torch.Tensor, *,
               h0: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None,
               return_state: bool = False,
               rows: Optional[torch.Tensor] = None,
               state_out: Optional[torch.Tensor] = None):
    """Mamba selective scan: x, dt (B,S,di); b, c (B,S,ds); a (di,ds)
    -> y (B,S,di) [, final state (B,di,ds)].  With the defaults, the
    result of ``repro.kernels.ops.mamba_scan`` (without its TPU tiling
    arguments); ``h0`` / ``return_state`` / ``state_out`` / ``rows``
    carry a serving cache's state through it (see
    ``kernels.mamba_scan.mamba_scan_fwd``)."""
    return mamba_scan_fwd(x, dt, b, c, a, h0=h0, out_dtype=out_dtype,
                          return_state=return_state, rows=rows,
                          state_out=state_out)


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


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, *,
              s0: Optional[torch.Tensor] = None, chunk: int = 64,
              out_dtype: Optional[torch.dtype] = None,
              return_state: bool = False,
              rows: Optional[torch.Tensor] = None,
              state_out: Optional[torch.Tensor] = None):
    """RWKV6 wkv: r,k,v,w (B,S,H,hd); u (H,hd) -> o (B,S,H,hd) [, final
    state (B,H,hd,hd)].  With the defaults, the signature and result of
    ``repro.kernels.ops.rwkv_scan``; ``s0`` / ``return_state`` /
    ``state_out`` / ``rows`` carry a serving cache's state through it
    (see ``kernels.rwkv_scan.rwkv_scan_fwd``)."""
    return rwkv_scan_fwd(r, k, v, w, u, s0=s0, chunk=chunk,
                         out_dtype=out_dtype, return_state=return_state,
                         rows=rows, state_out=state_out)
