"""Threefry-2x32 random bits as ``jax.random`` draws them, in torch
integer ops: the port's counterpart of what the serving engine takes from
``jax.random`` (``PRNGKey``, ``split``, ``fold_in``, bits, ``uniform``,
``gumbel``, ``categorical``), so sampled tokens are JAX's token for token.

A key is JAX's raw key data: two uint32 words, held here in an int64
tensor of shape (..., 2) (torch has no full uint32 arithmetic).  Every
word stays in [0, 2**32): sums and shifts are masked with ``MASK`` after
each operation, a rotation is ``((x << r) | (x >> (32 - r))) & MASK``.
The draws follow JAX with ``jax_threefry_partitionable`` on (its default):
the counter of element i of a drawn shape is i split into (hi, lo) 32-bit
words, and a 32-bit draw is the xor of the two output words.  Leading
dimensions of a key tensor are batch dimensions, each row its own key, as
``jax.vmap`` over raw keys gives.  The ops run on the key's device; the
bits do not depend on it.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counter words (x1, x2) under key words
    (k1, k2), 20 rounds, as ``jax._src.prng._threefry2x32_lowering``.
    All int64 holding uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & MASK, (x2 + ks[1]) & MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK
    return x[0], x[1]


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` without 64-bit mode: the seed as an
    int32, so the key is (0, seed mod 2**32), on the CPU."""
    return torch.tensor([0, seed & MASK], dtype=torch.int64)


def _words(key: torch.Tensor, ndim: int):
    """A key tensor's two words, shaped to broadcast over ``ndim``
    trailing dimensions."""
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key is (..., 2) words, not {tuple(key.shape)}")
    shape = (*key.shape[:-1], *(1,) * ndim)
    return key[..., 0].reshape(shape), key[..., 1].reshape(shape)


def _hash_iota(key: torch.Tensor, shape: Sequence[int]):
    """Both output words of the hash of every flat index of ``shape``,
    split into (hi, lo) counter words (``iota_2x32_shape``)."""
    shape = tuple(shape)
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    k1, k2 = _words(key, len(shape))
    return threefry2x32(k1, k2, i >> 32, i & MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (..., num, 2)."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter (0,
    data mod 2**32)."""
    k1, k2 = _words(key, 0)
    zero = torch.zeros_like(k1)
    b1, b2 = threefry2x32(k1, k2, zero, zero + (data & MASK))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: (..., *shape) int64 words
    in [0, 2**32)."""
    b1, b2 = _hash_iota(key, shape)
    return b1 ^ b2


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """JAX's bits-to-float map: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1: float32 in [0, 1)."""
    one = (bits >> 9) | 0x3F800000
    return one.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.  XLA's
    CPU code fuses ``floats * (maxval - minval) + minval`` into one
    multiply-add; float64 holds the float32 product exactly, so the sum
    rounds as the fused one does (but for a double rounding on a float32
    tie, which no draw of the tests met)."""
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    width = torch.tensor(maxval, dtype=torch.float32, device=key.device) - lo
    x = _unit_floats(random_bits(key, shape)).double() * width.double()
    return torch.maximum(lo, (x + lo.double()).float())


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """-log(-log(u)) over u floored at float32's smallest normal, as
    JAX's low-resolution ``gumbel`` maps its uniforms."""
    return -torch.log(-torch.log(u.clamp(min=_TINY)))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in its default mode
    ("low": one uniform in [tiny, 1) a value).  The bits and uniforms are
    JAX's exactly; the two logs are torch's, which may differ from
    XLA's by an ulp."""
    return gumbel_from_uniform(uniform(key, shape, minval=_TINY))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Gumbel-argmax over the last axis of ``logits`` (float32).  A key
    of shape (2,) is ``jax.random.categorical(key, logits)`` (one draw of
    logits' whole shape); keys of shape (B, 2) with logits (B, ..., V)
    are ``jax.vmap(jax.random.categorical)(keys, logits)`` (each row's
    own draw).  Ties go to the lowest index, as ``jnp.argmax``."""
    shape = logits.shape if key.dim() == 1 else logits.shape[1:]
    g = gumbel(key.to(logits.device), shape)
    return torch.argmax(g + logits, dim=-1)
