"""Recurrent mixers in PyTorch: the counterparts of ``repro.models.ssm``.

RWKV6 "Finch" (data-dependent decay) is ported; Mamba waits for a later
slice (its only model, jamba, also needs MoE), and ``mamba_apply``
raises.

The wkv recurrence has two paths.  The plain one is the JAX version's
sequential scan (``_rwkv_step`` under ``_chunked_scan``); with
``use_kernel=True`` it runs through ``kernels.ops.rwkv_scan`` — the
Hopper kernel on CUDA tensors, its plain version on CPU tensors — which
starts from the cached state and writes the final state back into the
cache's storage in place.  Both give the output ``o`` in float32, as
the JAX step does, and ``rmsnorm`` normalises it in float32 before the
cast to the activation dtype.

Serving caches carry a fixed-size recurrent state per slot — there is
no sequence axis to page, so a paged engine keeps it per slot too.
``rwkv_apply`` writes ``state`` and ``shift`` in place; rows whose
``valid`` flag is False (idle serving slots, which ran the scan on
padding) keep both bit for bit, with no host sync.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import (dense_init, rmsnorm, rmsnorm_init,
                                       row_dot)


def _chunked_scan(step_fn, h0, xs, length: int):
    """Sequential scan over time: ``xs`` is a tuple of time-major
    (S, ...) tensors.  Returns (h_final, ys) with ys time-major (S, ...).

    The JAX version pads ``length`` up to whole chunks of its
    rematerialised inner scan and gates the padded steps so that they
    leave the carry untouched (a decay step on zero padding is not the
    identity).  An eager loop has no fixed trip count, so here the padded
    steps are simply not run: the same carry and outputs."""
    h, ys = h0, []
    for t in range(length):
        h, y = step_fn(h, tuple(a[t] for a in xs))
        ys.append(y)
    return h, torch.stack(ys)


def mamba_apply(p: dict, x: torch.Tensor, cfg, *, cache=None):
    raise NotImplementedError(
        "repro_torch: the Mamba mixer is not ported yet (its only model, "
        "jamba, also needs MoE)")


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================

def rwkv_init(gen: torch.Generator, cfg, lead=(), device=None) -> dict:
    d, hd, lora = cfg.d_model, cfg.rwkv_head_dim, cfg.rwkv_decay_lora
    H = cfg.rwkv_n_heads
    kw = dict(lead=lead, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mu": torch.rand((*lead, 5, d), generator=gen, **f32),  # r,k,v,g,w
        "wr": dense_init(gen, d, d, **kw),
        "wk": dense_init(gen, d, d, **kw),
        "wv": dense_init(gen, d, d, **kw),
        "wg": dense_init(gen, d, d, **kw),
        "wo": dense_init(gen, d, d, scale=1.0 / math.sqrt(2 * cfg.n_layers),
                         **kw),
        "w0": torch.full((*lead, d), -0.5, **f32),               # decay base
        "wA": dense_init(gen, d, lora, **kw),
        "wB": dense_init(gen, lora, d, **kw),
        "u": torch.randn((*lead, H, hd), generator=gen, **f32) * 0.1,
        "ln_x": rmsnorm_init(hd, **kw),
    }


def _rwkv_step(S, xs_t, u):
    """S: (B,H,hd,hd) f32 [k-index, v-index].
    xs_t = (r,k,v,w): each (B,H,hd); u: (1,H,hd) bonus."""
    r, k, v, w = xs_t
    r, k, v = r.float(), k.float(), v.float()
    kv = k[..., :, None] * v[..., None, :]                       # (B,H,hd,hd)
    o = torch.einsum("bhi,bhij->bhj", r, S + u[..., None] * kv)  # (B,H,hd)
    S = w[..., :, None] * S + kv
    return S, o


def rwkv_apply(p: dict, x: torch.Tensor, cfg, *, cache: Optional[dict] = None,
               valid: Optional[torch.Tensor] = None,
               use_kernel: bool = False):
    """RWKV6 time-mix.  x: (B,S,d) -> (out, cache).  cache: {"state":
    (B,H,hd,hd) f32, "shift": (B,d)}, written in place.  ``valid`` (B,)
    bool: rows that are False keep ``state`` and ``shift`` bit for bit.
    ``use_kernel=True`` runs the recurrence through ``ops.rwkv_scan``."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    prev = (cache["shift"][:, None, :] if cache is not None
            else torch.zeros((B, 1, d), dtype=x.dtype, device=x.device))
    xx = torch.cat([prev, x[:, :-1, :]], dim=1)                  # shifted
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (xx - x) * mu[i] for i in range(5))

    r = (xr @ p["wr"].to(x.dtype)).reshape(B, S, H, hd)
    k = (xk @ p["wk"].to(x.dtype)).reshape(B, S, H, hd)
    v = (xv @ p["wv"].to(x.dtype)).reshape(B, S, H, hd)
    g = F.silu(xg @ p["wg"].to(x.dtype))
    # data-dependent decay (the Finch contribution)
    w_dd = p["w0"].float() + (
        torch.tanh(xw @ p["wA"].to(x.dtype)) @ p["wB"].to(x.dtype)).float()
    w = torch.exp(-torch.exp(w_dd)).reshape(B, S, H, hd)         # in (0,1)
    u = p["u"].float()                                           # (H,hd)

    S0 = cache["state"] if cache is not None else None
    if use_kernel:
        # the final state lands in the cache's storage; rows that are not
        # valid are left untouched there
        o = ops.rwkv_scan(r, k, v, w, u, s0=S0, out_dtype=torch.float32,
                          rows=valid, state_out=S0)
    else:
        h0 = S0 if S0 is not None else torch.zeros(
            (B, H, hd, hd), dtype=torch.float32, device=x.device)
        step = lambda S_, xs_t: _rwkv_step(S_, xs_t, u[None])
        tm = lambda a: a.transpose(0, 1)                         # time-major
        S1, o = _chunked_scan(step, h0, (tm(r), tm(k), tm(v), tm(w)), S)
        o = o.transpose(0, 1)                                    # (B,S,H,hd)
        if S0 is not None:
            if valid is not None:
                S1 = torch.where(valid[:, None, None, None], S1, S0)
            S0.copy_(S1)
    o = rmsnorm(o, p["ln_x"], cfg.norm_eps).to(x.dtype)
    out = row_dot(o.reshape(B, S, d) * g, p["wo"])
    if cache is not None:
        shift = x[:, -1, :]
        if valid is not None:
            shift = torch.where(valid[:, None], shift, cache["shift"])
        cache["shift"].copy_(shift)
    return out, cache


def rwkv_cache_init(batch: int, cfg, dtype=torch.bfloat16, lead=(),
                    device=None) -> dict:
    H, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    return {
        "state": torch.zeros((*lead, batch, H, hd, hd), dtype=torch.float32,
                             device=device),
        "shift": torch.zeros((*lead, batch, cfg.d_model), dtype=dtype,
                             device=device),
    }
