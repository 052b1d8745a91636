"""Recurrent mixers in PyTorch: the counterparts of ``repro.models.ssm``
— Mamba (selective scan) and RWKV6 "Finch" (data-dependent decay).

Each recurrence has two paths.  The plain one is the JAX version's
sequential scan (``kernels.ref.mamba_scan_ref``, the arithmetic of the
JAX ``_mamba_step``; ``_rwkv_step`` under ``_chunked_scan``); with
``use_kernel=True`` it runs through
``kernels.ops.mamba_scan`` / ``kernels.ops.rwkv_scan`` — the Hopper
kernel on CUDA tensors, its plain version on CPU tensors — which starts
from the cached state and writes the final state back into the cache's
storage in place.  Both give the scan's output in float32, as the JAX
steps do.  (The JAX mixers run only the plain scans; the Pallas
``ssm_scan`` kernels mirror them.  The port runs its kernels on the
model path.)

Serving caches carry a fixed-size recurrent state per slot — there is
no sequence axis to page, so a paged engine keeps it per slot too.
``mamba_apply`` writes ``h`` and ``conv`` in place, ``rwkv_apply``
``state`` and ``shift``; rows whose ``valid`` flag is False (idle
serving slots, which ran the scan on padding) keep both bit for bit,
with no host sync.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import mamba_scan_ref
from repro_torch.models import hints
from repro_torch.models.hints import constrain
from repro_torch.models.layers import (dense_init, rmsnorm, rmsnorm_init,
                                       row_dot, silu)


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


# ===========================================================================
# Mamba
# ===========================================================================

def mamba_init(gen: torch.Generator, cfg, lead=(), device=None) -> dict:
    d, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dtr, dc = cfg.mamba_dt_rank, cfg.mamba_d_conv
    kw = dict(lead=lead, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    # S4D-real initialization for A
    A = torch.arange(1, ds + 1, **f32).expand(*lead, di, ds)
    # inverse softplus of U[1e-3, 1e-1], drawn log-uniformly
    u = torch.rand((*lead, di), generator=gen, **f32)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "in_proj": dense_init(gen, d, 2 * di, **kw),
        "conv_w": (torch.randn((*lead, dc, di), generator=gen, **f32)
                   / math.sqrt(dc)).to(torch.bfloat16),
        "conv_b": torch.zeros((*lead, di), **f32),
        "x_proj": dense_init(gen, di, dtr + 2 * ds, **kw),
        "dt_proj": dense_init(gen, dtr, di, scale=dtr ** 0.5, **kw),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(A),
        "D": torch.ones((*lead, di), **f32),
        "out_proj": dense_init(gen, di, d,
                               scale=1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time.  x: (B,S,di), w: (K,di).
    prev: (B,K-1,di) history for decode.  Returns (y, new_history); the
    taps are summed in the JAX version's order, in x.dtype."""
    K = w.shape[0]
    if prev is None:
        prev = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev.to(x.dtype), x], dim=1)                 # (B,S+K-1,di)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i].to(x.dtype)
    y = y + b.to(x.dtype)
    return y, xp[:, -(K - 1):]


def _mamba_scan(x, dt, b, c, a, h0, rows, use_kernel: bool):
    """The selective scan: (y (B,S,di) f32, final state).  The kernel
    (``use_kernel``) writes the final state into ``h0``'s storage, rows
    that are not valid untouched there, and returns ``h0`` itself as the
    state.  On DTensors (a dry-run on a mesh) it runs on each rank's shard
    by the "mamba_scan" layout of ``hints.LAYOUTS``."""
    if hints.mesh_of(x, h0) is not None:
        B, S, di = x.shape
        return hints.local_call(
            "mamba_scan",
            lambda _, **t: hints.scan_steps(
                lambda **u: _mamba_scan(**u, use_kernel=use_kernel), t,
                ("x", "dt", "b", "c")),
            dict(x=x, dt=dt, b=b, c=c, a=a, h0=h0, rows=rows),
            {"y": x.shape, "h": (B, di, a.shape[-1])})
    if use_kernel:
        y = ops.mamba_scan(x, dt, b.contiguous(), c.contiguous(), a, h0=h0,
                           out_dtype=torch.float32, rows=rows, state_out=h0)
        return y, h0
    return mamba_scan_ref(x, dt, b, c, a, h0=h0, out_dtype=torch.float32,
                          return_state=True, rows=rows)


def mamba_apply(p: dict, x: torch.Tensor, cfg, *,
                cache: Optional[dict] = None,
                valid: Optional[torch.Tensor] = None,
                use_kernel: bool = False):
    """Mamba block.  x: (B,S,d) -> (out, cache).  cache: {"h": (B,di,ds)
    f32, "conv": (B,K-1,di)}, written in place.  ``valid`` (B,) bool:
    rows that are False keep ``h`` and ``conv`` bit for bit.
    ``use_kernel=True`` runs the selective scan through
    ``ops.mamba_scan`` at every S."""
    ds, dtr = cfg.mamba_d_state, cfg.mamba_dt_rank
    xz = x @ p["in_proj"].to(x.dtype)
    xs, z = xz.chunk(2, dim=-1)                                  # (B,S,di)
    conv_prev = cache["conv"] if cache is not None else None
    xs, conv_new = _causal_conv(xs, p["conv_w"], p["conv_b"], conv_prev)
    xs = silu(xs)

    proj = xs @ p["x_proj"].to(x.dtype)                          # (B,S,dtr+2ds)
    dt, Bm, Cm = proj.split([dtr, ds, ds], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].to(x.dtype)
                    + p["dt_bias"].to(x.dtype))                  # (B,S,di)
    A = -torch.exp(p["A_log"])                                   # (di,ds) f32

    h0 = cache["h"] if cache is not None else None
    y, h1 = _mamba_scan(xs, dt, Bm, Cm, A, h0, valid, use_kernel)
    if h0 is not None and h1 is not h0:
        h0.copy_(constrain(h1, "cache/h"))
    y = y.to(x.dtype) + xs * p["D"].to(x.dtype)
    y = y * silu(z)
    out = row_dot(y, p["out_proj"])
    if cache is not None:
        if valid is not None:
            conv_new = torch.where(valid[:, None, None], conv_new,
                                   cache["conv"])
        cache["conv"].copy_(constrain(conv_new, "cache/conv"))
    return out, cache


def mamba_cache_init(batch: int, cfg, dtype=torch.bfloat16, lead=(),
                     device=None) -> dict:
    return {
        "h": torch.zeros((*lead, batch, cfg.mamba_d_inner, cfg.mamba_d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, cfg.mamba_d_conv - 1,
                             cfg.mamba_d_inner), dtype=dtype, device=device),
    }


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


def _rwkv_scan(r, k, v, w, u, s0, rows, use_kernel: bool):
    """The wkv recurrence: (o (B,S,H,hd) f32, final state; rows that are
    not valid keep ``s0``).  The kernel (``use_kernel``) writes the final
    state into ``s0``'s storage and returns ``s0`` itself as the state.
    On DTensors (a dry-run on a mesh) it runs on each rank's shard by the
    "rwkv_scan" layout of ``hints.LAYOUTS``."""
    B, S, H, hd = r.shape
    if hints.mesh_of(r, s0) is not None:
        return hints.local_call(
            "rwkv_scan",
            lambda _, **t: hints.scan_steps(
                lambda **a: _rwkv_scan(**a, use_kernel=use_kernel), t,
                ("r", "k", "v", "w")),
            dict(r=r, k=k, v=v, w=w, u=u, s0=s0, rows=rows),
            {"o": r.shape, "s": (B, H, hd, hd)})
    if use_kernel:
        o = ops.rwkv_scan(r, k, v, w, u, s0=s0, out_dtype=torch.float32,
                          rows=rows, state_out=s0)
        return o, s0
    h0 = s0 if s0 is not None else torch.zeros(
        (B, H, hd, hd), dtype=torch.float32, device=r.device)
    step = lambda S_, xs_t: _rwkv_step(S_, xs_t, u[None])
    tm = lambda a: a.transpose(0, 1)                             # time-major
    S1, o = _chunked_scan(step, h0, (tm(r), tm(k), tm(v), tm(w)), S)
    if s0 is not None and rows is not None:
        S1 = torch.where(rows[:, None, None, None], S1, s0)
    return o.transpose(0, 1), S1                                 # (B,S,H,hd)


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
    g = silu(xg @ p["wg"].to(x.dtype))
    # data-dependent decay (the Finch contribution); on a mesh the LoRA's
    # small wA is gathered whole per rank (FSDP) unless xw's width is
    # split as wA's rows are (decode's hidden split): then the
    # contraction stays local and its partial sums are reduced
    wA = (p["wA"] if hints.splits_alike(xw, -1, p["wA"], 0)
          else hints.unsplit(p["wA"], 0))
    w_dd = p["w0"].float() + (
        torch.tanh(xw @ wA.to(x.dtype)) @ p["wB"].to(x.dtype)).float()
    w = torch.exp(-torch.exp(w_dd)).reshape(B, S, H, hd)         # in (0,1)
    u = p["u"].float()                                           # (H,hd)

    S0 = cache["state"] if cache is not None else None
    o, S1 = _rwkv_scan(r, k, v, w, u, S0, valid, use_kernel)
    if S0 is not None and S1 is not S0:
        S0.copy_(constrain(S1, "cache/state"))
    o = rmsnorm(o, p["ln_x"], cfg.norm_eps).to(x.dtype)
    out = row_dot(o.reshape(B, S, d) * g, p["wo"])
    if cache is not None:
        shift = x[:, -1, :]
        if valid is not None:
            shift = torch.where(valid[:, None], shift, cache["shift"])
        cache["shift"].copy_(constrain(shift, "cache/shift"))
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
