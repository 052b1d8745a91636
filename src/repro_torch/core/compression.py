"""Communication-efficiency toolbox (paper §2.3) in PyTorch: the
counterpart of ``repro.core.compression`` — top-k sparsification (with
error feedback), QSGD-style stochastic quantization, deterministic int8
block quantization and local-SGD step gating.

``int8_block_encode`` / ``int8_block_decode`` go through
``kernels.ops.int8_quantize`` / ``int8_dequantize``: on CUDA tensors the
Hopper kernels of ``kernels/csrc/quantize.cu``, on CPU tensors their plain
versions.  They compute the same function as the JAX package's eager
encode and decode (true division, round half to even), codes and scales
bit for bit.  ``qsgd_encode`` draws its coin flips from an explicit
``torch.Generator`` where the JAX version takes a key, so the two agree
in law, not in bits.

Every transform is a pair (encode, decode) plus an analytic byte count
that the scheduler / perf model use to price communication on slow links.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Top-k sparsification (+ error feedback)
# ---------------------------------------------------------------------------

def topk_encode(g: torch.Tensor, ratio: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top ``ratio`` fraction by magnitude, largest first.
    Returns (values, idx) with idx into the flattened tensor."""
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx


def topk_decode(values: torch.Tensor, idx: torch.Tensor, shape
                ) -> torch.Tensor:
    flat = torch.zeros(math.prod(shape), dtype=values.dtype,
                       device=values.device)
    flat[idx] = values
    return flat.reshape(shape)


def topk_bytes(n_elems: int, ratio: float, value_bytes: int = 4,
               index_bytes: int = 4) -> float:
    k = max(1, int(n_elems * ratio))
    return k * (value_bytes + index_bytes)


@dataclass
class ErrorFeedback:
    """EF-SGD memory: residual of what compression dropped, re-added next
    round.  Usage: state = ef.init(g); g_hat, state = ef.step(g, state)."""
    ratio: float

    def init(self, g: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(g)

    def step(self, g: torch.Tensor, residual: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        corrected = g + residual
        vals, idx = topk_encode(corrected, self.ratio)
        sent = topk_decode(vals, idx, corrected.shape)
        return sent, corrected - sent


# ---------------------------------------------------------------------------
# QSGD stochastic quantization
# ---------------------------------------------------------------------------

def qsgd_encode(gen: torch.Generator, g: torch.Tensor, levels: int = 256
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic uniform quantization to ``levels`` buckets per tensor.
    Returns (signed int32 codes, f32 scale).  Unbiased: E[decode] = g.
    ``gen`` lives on g's device."""
    gf = g.float()
    scale = gf.abs().max() + 1e-12
    y = gf.abs() / scale * (levels - 1)
    lo = torch.floor(y)
    up = torch.rand(g.shape, generator=gen, dtype=torch.float32,
                    device=g.device) < (y - lo)
    q = (lo + up.float()).to(torch.int32)
    return torch.where(torch.signbit(gf), -q, q), scale


def qsgd_decode(codes: torch.Tensor, scale: torch.Tensor, levels: int = 256
                ) -> torch.Tensor:
    return codes.float() * scale / (levels - 1)


def qsgd_bytes(n_elems: int, levels: int = 256) -> float:
    bits = max(1, math.ceil(math.log2(levels))) + 1      # + sign bit
    return n_elems * bits / 8 + 4                        # + f32 scale


# ---------------------------------------------------------------------------
# Deterministic int8 block quantization (all-reduce payload compression)
# ---------------------------------------------------------------------------

def int8_block_encode(g: torch.Tensor, block: int = 256
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block absmax int8.  Returns (q int8 (n_blocks, block), scales
    f32 (n_blocks, 1)); the kernel on CUDA tensors."""
    return ops.int8_quantize(g, block=block)


def int8_block_decode(q: torch.Tensor, scales: torch.Tensor, shape
                      ) -> torch.Tensor:
    """float32 ``code * scale`` of ``shape``; the kernel on CUDA tensors."""
    return ops.int8_dequantize(q, scales, shape, torch.float32)


def int8_bytes(n_elems: int, block: int = 256) -> float:
    n_blocks = math.ceil(n_elems / block)
    return n_elems + n_blocks * 4


# ---------------------------------------------------------------------------
# Local SGD (§2.3): communicate every H steps
# ---------------------------------------------------------------------------

@dataclass
class LocalSGD:
    """Step gate: sync model average every ``period`` local steps.  The
    effective per-step communication volume shrinks by 1/period, which is
    what the scheduler prices."""
    period: int

    def should_sync(self, step: int) -> bool:
        return (step + 1) % self.period == 0

    def bytes_per_step(self, model_bytes: float) -> float:
        return model_bytes / self.period


# ---------------------------------------------------------------------------
# Registry used by the scheduler to price links
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CompressionSpec:
    kind: str            # none | topk | qsgd | int8 | local_sgd
    ratio: float = 0.01  # topk keep-ratio
    levels: int = 256    # qsgd levels
    period: int = 8      # local-sgd period

    def bytes(self, n_elems: int, raw_bytes: Optional[float] = None) -> float:
        raw = raw_bytes if raw_bytes is not None else 4.0 * n_elems
        if self.kind == "none":
            return raw
        if self.kind == "topk":
            return topk_bytes(n_elems, self.ratio)
        if self.kind == "qsgd":
            return qsgd_bytes(n_elems, self.levels)
        if self.kind == "int8":
            return int8_bytes(n_elems)
        if self.kind == "local_sgd":
            return raw / self.period
        raise ValueError(self.kind)
