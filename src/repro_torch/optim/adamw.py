"""Optimizers in PyTorch: AdamW with float32 master weights (model
params may be bf16; moments and the master copy are f32), SGD with
momentum, global-norm clipping, LR schedules — the counterparts of
``repro.optim.adamw``.

The API stays functional: ``opt = adamw(...); state = opt.init(params);
params, state, metrics = opt.update(grads, state, params)``.  Unlike the
JAX version, ``update`` writes the new values into ``params`` and
``state`` in place (under ``torch.no_grad``) and returns the same trees,
so a step allocates no second copy of the model or its state.  The step
counter, the learning rate and the metrics stay tensors on the params'
device: an update waits for nothing on the host.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.tree import leaves, tree_map

LR = Union[Callable[[torch.Tensor], torch.Tensor], float]


# ---------------------------------------------------------------------------
# Schedules (step: an int tensor; returns a float32 tensor)
# ---------------------------------------------------------------------------

def constant_lr(lr: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def cosine_lr(peak: float, warmup: int, total: int,
              floor: float = 0.0) -> Callable[[torch.Tensor], torch.Tensor]:
    def fn(step):
        step = step.float()
        warm = peak * step / max(1, warmup)
        t = ((step - warmup) / max(1, total - warmup)).clamp(0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return fn


def linear_lr(peak: float, warmup: int,
              total: int) -> Callable[[torch.Tensor], torch.Tensor]:
    def fn(step):
        step = step.float()
        warm = peak * step / max(1, warmup)
        t = ((step - warmup) / max(1, total - warmup)).clamp(0.0, 1.0)
        return torch.where(step < warmup, warm, peak * (1.0 - t))
    return fn


# ---------------------------------------------------------------------------
# Gradient clipping
# ---------------------------------------------------------------------------

def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares of every leaf, summed leaf by
    leaf in flatten order (the JAX version's order)."""
    total = None
    for x in leaves(tree):
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to a global norm of at most ``max_norm``, norm).  The
    scale is applied in float32 and the result cast back to each leaf's
    dtype."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _q8(x: torch.Tensor):
    """Row-wise absmax int8 (one scale per trailing row).  Returns (q int8
    of x's shape, scales float32 (..., 1)); ``torch.round`` rounds half
    to even, as ``jnp.round``."""
    xf = x.float()
    scales = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scales), -127, 127).to(torch.int8)
    return q, scales


def _dq8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * scales


def adamw(lr: LR, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, clip_norm: Optional[float] = 1.0,
          master_dtype=torch.float32, state_bits: int = 32) -> Optimizer:
    """AdamW.  ``state_bits=8`` stores the moments as row-wise int8 (the
    second moment in the sqrt domain), as the JAX version does."""
    if state_bits not in (8, 32):
        raise ValueError(f"state_bits must be 8 or 32, not {state_bits}")
    lr_fn = lr if callable(lr) else constant_lr(lr)
    q8 = state_bits == 8

    def _enc(x, sqrt_domain=False):
        if not q8:
            return x
        if sqrt_domain:                        # second moment: quantize
            x = torch.sqrt(torch.clamp(x, min=0.0))   # sqrt(nu), linear int8
        q, s = _q8(x)                          # on the |g| scale, not g²
        return {"q": q, "s": s}

    def _dec(x, sqrt_domain=False):
        if not q8:
            return x
        v = _dq8(x["q"], x["s"])
        return v.square() if sqrt_domain else v

    def _store(dst, new):
        """Write an updated moment into its state storage in place."""
        if q8:
            dst["q"].copy_(new["q"])
            dst["s"].copy_(new["s"])
        else:
            dst.copy_(new)

    @torch.no_grad()
    def init(params):
        def zeros(p, sqrt_domain=False):
            return _enc(torch.zeros(p.shape, dtype=master_dtype,
                                    device=p.device), sqrt_domain)
        some = next(leaves(params))
        return {
            "step": torch.zeros((), dtype=torch.int32, device=some.device),
            "mu": tree_map(zeros, params),
            "nu": tree_map(lambda p: zeros(p, True), params),
            "master": tree_map(lambda p: p.detach().to(master_dtype, copy=True),
                               params),
        }

    @torch.no_grad()
    def update(grads, state, params):
        state["step"].add_(1)
        step = state["step"]
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, clip_norm) if clip_norm is not None else None
        lr_t = lr_fn(step)
        stepf = step.float()
        c1 = 1.0 - b1 ** stepf
        c2 = 1.0 - b2 ** stepf

        def upd(g, mu, nu, m, p):
            if scale is not None:              # clipped in f32, cast back
                g = (g.float() * scale).to(g.dtype)
            g = g.to(master_dtype)
            mu_new = b1 * _dec(mu) + (1 - b1) * g
            nu_new = b2 * _dec(nu, True) + (1 - b2) * g.square()
            u = (mu_new / c1) / (torch.sqrt(nu_new / c2) + eps)
            m.sub_(lr_t * (u + weight_decay * m))
            _store(mu, _enc(mu_new))
            _store(nu, _enc(nu_new, True))
            p.copy_(m)

        tree_map(upd, grads, state["mu"], state["nu"], state["master"], params)
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)


def sgd(lr: LR, *, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    lr_fn = lr if callable(lr) else constant_lr(lr)

    @torch.no_grad()
    def init(params):
        some = next(leaves(params))
        return {"step": torch.zeros((), dtype=torch.int32, device=some.device),
                "vel": tree_map(lambda p: torch.zeros(
                    p.shape, dtype=torch.float32, device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params):
        state["step"].add_(1)
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, clip_norm) if clip_norm is not None else None
        lr_t = lr_fn(state["step"])

        def upd(p, g, v):
            if scale is not None:
                g = (g.float() * scale).to(g.dtype)
            v.copy_(momentum * v + g.float())
            p.copy_(p.float() - lr_t * v)

        tree_map(upd, params, grads, state["vel"])
        return params, state, {"grad_norm": gnorm, "lr": lr_t}

    return Optimizer(init, update)
