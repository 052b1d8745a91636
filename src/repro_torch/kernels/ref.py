"""Plain PyTorch versions of the port's hand-written kernels.

Each function computes what its CUDA kernel computes, in ordinary tensor
ops.  The kernel wrappers run these for tensors that lie on the CPU (the
tests), and ``chip_smoke.py`` holds each kernel against its plain
version on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # finite "minus infinity" keeps online softmax NaN-free


def paged_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos: torch.Tensor, table: torch.Tensor,
                        q_pos: torch.Tensor, *, scale: Optional[float] = None,
                        window: int = 0, softcap: float = 0.0,
                        q_extra: Optional[torch.Tensor] = None,
                        k_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged single-token decode attention, one table column at a time.

    q: (B, 1, Hq, D); k: (N, page, Hkv, D); v: (N, page, Hkv, Dv);
    pos: (N, page) int32 (< 0 = unwritten); table: (B, n_cols) int32
    (< 0 = unallocated); q_pos: (B, 1) int32 (< 0 = idle slot).
    q_extra (B, 1, Hq, De) / k_extra (N, page, Hkv, De) add a second
    score contraction (MLA rope term).  Returns (B, 1, Hq, Dv) in q.dtype.

    The walk, mask and online softmax are those of the Pallas kernel
    (``repro/kernels/paged_attention.py:139-198``): the mask is
    ``blk >= 0 & pos >= 0 & pos <= q_pos`` (``& pos > q_pos - window`` for
    SWA), a fully masked page gives ``alpha = exp(0) = 1`` and ``p = 0``
    (so a -1 column is exactly neutral), and the finalize is
    ``acc / max(l, 1e-30)`` (so an idle slot outputs exact zeros)."""
    B, _, Hq, D = q.shape
    Hkv, Dv = v.shape[2], v.shape[3]
    G = Hq // Hkv
    n_cols = table.shape[1]
    if scale is None:
        scale = D ** -0.5
    qf = q.float().reshape(B, Hkv, G, D) * scale
    qe = None
    if q_extra is not None:
        qe = q_extra.float().reshape(B, Hkv, G, q_extra.shape[-1]) * scale
    qp = q_pos.reshape(B, 1)
    m = torch.full((B, Hkv, G, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Dv), dtype=torch.float32, device=q.device)
    for c in range(n_cols):
        blk = table[:, c]
        safe = blk.clamp(min=0).long()
        s = torch.einsum("bngd,bpnd->bngp", qf, k[safe].float())
        if qe is not None:
            s = s + torch.einsum("bngd,bpnd->bngp", qe, k_extra[safe].float())
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        pj = pos[safe]                                       # (B, page)
        ok = (blk[:, None] >= 0) & (pj >= 0) & (pj <= qp)
        if window > 0:
            ok &= pj > qp - window
        okb = ok[:, None, None, :]
        s = torch.where(okb, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(okb, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bngp,bpnd->bngd", p,
                                         v[safe].float())
        m = m_new
    out = acc / l.clamp(min=1e-30)
    return out.reshape(B, 1, Hq, Dv).to(q.dtype)


# table columns per split of the paged-decode kernel (``PAGES_PER_SPLIT``
# in csrc/paged_attention.cu, which reports it to the wrapper), and of its
# MLA instance (``MLA_PAGES_PER_SPLIT`` there)
PAGES_PER_SPLIT = 4
MLA_PAGES_PER_SPLIT = 8


def paged_attention_split_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, pos: torch.Tensor,
                              table: torch.Tensor, q_pos: torch.Tensor, *,
                              scale: Optional[float] = None, window: int = 0,
                              softcap: float = 0.0,
                              q_extra: Optional[torch.Tensor] = None,
                              k_extra: Optional[torch.Tensor] = None,
                              pages_per_split: int = PAGES_PER_SPLIT,
                              round_p: bool = False) -> torch.Tensor:
    """The split-K algorithm of the paged-decode kernel, in plain ops.

    Same arguments and result as ``paged_attention_ref``.  Split s covers
    the fixed table columns [s * pages_per_split, (s + 1) *
    pages_per_split) (columns past the table count as -1), so appending
    columns never moves a boundary.  Each split's ``pages_per_split *
    page`` rows give a partial (m_s = its largest unmasked score, or
    -1e30; l_s = sum of exp(s - m_s) over unmasked rows; acc_s = the
    same weights times V); the partials then merge in split order:
    ``M = max m_s``, ``l = sum l_s e^(m_s - M)``, ``o = sum acc_s
    e^(m_s - M) / max(l, 1e-30)``, skipping the splits with l_s = 0
    (no unmasked row: adding them would add exactly 0).  So -1 columns
    are neutral bit for bit, and an idle slot outputs exact zeros.

    ``round_p=True`` rounds P to q's dtype for the P.V product (l sums
    the unrounded P), as the MLA instance (``MLA_PAGES_PER_SPLIT``
    columns a split) rounds it to bf16 for the tensor cores."""
    B, _, Hq, D = q.shape
    page, Hkv, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    n_cols = table.shape[1]
    pps = pages_per_split
    n_splits = -(-n_cols // pps)
    tab = F.pad(table, (0, n_splits * pps - n_cols), value=-1)
    R = pps * page
    qf = q.float().reshape(B, Hkv, G, D) * scale
    qe = None
    if q_extra is not None:
        qe = q_extra.float().reshape(B, Hkv, G, q_extra.shape[-1]) * scale
    qp = q_pos.reshape(B, 1)
    parts = []                  # (m_s, l_s, acc_s), one per split, in order
    for i in range(n_splits):   # the same ops on the same shapes per split
        ts = tab[:, i * pps:(i + 1) * pps]
        safe = ts.clamp(min=0).long()
        s = torch.einsum("bngd,brnd->bngr", qf,
                         k[safe].reshape(B, R, Hkv, D).float())
        if qe is not None:
            s = s + torch.einsum("bngd,brnd->bngr", qe, k_extra[safe].reshape(
                B, R, Hkv, -1).float())
        if softcap > 0.0:
            s = softcap * torch.tanh(s / softcap)
        pj = pos[safe].reshape(B, R)
        ok = (ts >= 0).repeat_interleave(page, dim=1) & (pj >= 0) & (pj <= qp)
        if window > 0:
            ok &= pj > qp - window
        okb = ok[:, None, None, :]
        s = torch.where(okb, s, NEG_INF)
        m = s.amax(dim=-1)                                # (B,Hkv,G)
        p = torch.where(okb, torch.exp(s - m[..., None]), 0.0)
        pv = p.to(q.dtype).float() if round_p else p
        parts.append((m, p.sum(dim=-1), torch.einsum(
            "bngr,brnd->bngd", pv, v[safe].reshape(B, R, Hkv, Dv).float())))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l = torch.zeros_like(M)
    acc = torch.zeros((B, Hkv, G, Dv), dtype=torch.float32, device=q.device)
    for m, l_s, acc_s in parts:
        w = torch.where(l_s > 0, torch.exp(m - M), 0.0)
        l = l + l_s * w
        acc = acc + acc_s * w[..., None]
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.reshape(B, 1, Hq, Dv).to(q.dtype)


def mamba_scan_ref(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, *,
                   h0: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None,
                   return_state: bool = False,
                   rows: Optional[torch.Tensor] = None):
    """Mamba selective scan, one time step after another.

    x, dt: (B, S, di); b, c: (B, S, ds); a: (di, ds) float32 (negative);
    h0: (B, di, ds) float32 or None (zeros).  Per step, in float32 (the
    arithmetic of ``repro.models.ssm._mamba_step``):
    ``h <- exp(dt_t a) h + (dt_t x_t) b_t`` and ``y_t = h . c_t``.
    Returns y (B, S, di) in ``out_dtype`` (default x.dtype), and the
    final state too when ``return_state``.  ``rows`` (B,) bool: rows that
    are False return ``h0`` as their final state (their outputs are
    still computed).

    With ``h0=None`` and the default output type this is
    ``repro.kernels.ref.mamba_scan_ref`` (and the Pallas ``mamba_scan``);
    with ``h0`` and float32 output it is the JAX model's scan of
    ``_mamba_step`` from a cached state."""
    B, S, di = x.shape
    ds = b.shape[-1]
    a = a.float()
    h = (torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        x_t, dt_t, b_t, c_t = (v[:, t].float() for v in (x, dt, b, c))
        dA = torch.exp(dt_t[..., None] * a)                  # (B,di,ds)
        h = dA * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, c_t))
    y = torch.stack(ys, dim=1).to(out_dtype or x.dtype)
    if not return_state:
        return y
    if rows is not None:
        h = torch.where(rows.reshape(B, 1, 1), h, 0.0 if h0 is None else h0)
    return y, h


def rwkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, *,
                  s0: Optional[torch.Tensor] = None,
                  out_dtype: Optional[torch.dtype] = None,
                  return_state: bool = False,
                  rows: Optional[torch.Tensor] = None):
    """RWKV6 wkv recurrence, one time step after another.

    r, k, v, w: (B, S, H, hd); u: (H, hd) float32; s0: (B, H, hd, hd)
    float32 [k-index, v-index] or None (zeros).  Per step, in float32:
    ``o_t = r_t . (S + diag(u) k_t v_t^T)`` and
    ``S <- diag(w_t) S + k_t v_t^T``.  Returns o (B, S, H, hd) in
    ``out_dtype`` (default r.dtype), and the final state too when
    ``return_state``.  ``rows`` (B,) bool: rows that are False return
    ``s0`` as their final state (their outputs are still computed).

    With ``s0=None`` and the default output type this is
    ``repro.kernels.ref.rwkv_scan_ref`` (and the Pallas ``rwkv_scan``);
    with ``s0`` and float32 output it is the JAX model's
    ``_chunked_scan(_rwkv_step, s0, ...)``."""
    B, S, H, hd = r.shape
    st = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
          if s0 is None else s0.float())
    uu = u.float()[None, :, :, None]
    outs = []
    for t in range(S):
        r_t, k_t, v_t, w_t = (a[:, t].float() for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]           # (B,H,hd,hd)
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, st + uu * kv))
        st = w_t[..., :, None] * st + kv
    o = torch.stack(outs, dim=1).to(out_dtype or r.dtype)
    if not return_state:
        return o
    if rows is not None:
        st = torch.where(rows.reshape(B, 1, 1, 1), st,
                         0.0 if s0 is None else s0)
    return o, st


def rwkv_scan_split_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, *,
                        s0: Optional[torch.Tensor] = None,
                        out_dtype: Optional[torch.dtype] = None,
                        return_state: bool = False,
                        rows: Optional[torch.Tensor] = None):
    """The RWKV kernel's arithmetic in plain ops: ``rwkv_scan_ref`` with
    the bonus term factored out and the i-sum split as csrc/rwkv_scan.cu
    splits it.  Same arguments and result.

    Per step ``o_t[j] = sum_i r_t[i] S[i][j] + v_t[j] a_t`` with ``a_t =
    sum_i r_t[i] u[i] k_t[i]``.  The first sum runs in HD / 8 row groups
    (HD = 64 for hd <= 64, else 128; rows past hd are zeros): group g
    holds rows 4g..4g+3 and HD/2 + 4g..HD/2 + 4g+3, and the groups'
    partial sums add in group order.  The state update is the plain
    version's."""
    B, S, H, hd = r.shape
    HD = 64 if hd <= 64 else 128
    G = HD // 8
    order = torch.tensor([m // 4 * (HD // 2) + 4 * g + m % 4
                          for g in range(G) for m in range(8)],
                         device=r.device)
    st = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
          if s0 is None else s0.float())
    uu = u.float()
    outs = []
    for t in range(S):
        r_t, k_t, v_t, w_t = (a[:, t].float() for a in (r, k, v, w))
        prod = F.pad(r_t[..., :, None] * st, (0, 0, 0, HD - hd))
        part = prod[:, :, order].reshape(B, H, G, 8, hd).sum(dim=3)
        acc = part[:, :, 0]
        for g in range(1, G):
            acc = acc + part[:, :, g]
        a_t = (r_t * uu * k_t).sum(dim=-1, keepdim=True)     # (B,H,1)
        outs.append(acc + v_t * a_t)
        st = w_t[..., :, None] * st + k_t[..., :, None] * v_t[..., None, :]
    o = torch.stack(outs, dim=1).to(out_dtype or r.dtype)
    if not return_state:
        return o
    if rows is not None:
        st = torch.where(rows.reshape(B, 1, 1, 1), st,
                         0.0 if s0 is None else s0)
    return o, st


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        scale: Optional[float] = None,
                        return_lse: bool = False):
    """Dense attention with the flash kernel's index masks.

    q: (B, Hq, S, D); k, v: (B, Hkv, T, D); query head h reads kv head
    h // (Hq // Hkv).  Key j is masked for query i where j > i (causal)
    or j <= i - window (window > 0).  Float32 inside; returns the output
    in q.dtype and, with ``return_lse``, also the per-row logsumexp
    (B, Hq, S) in float32 (``NEG_INF`` for a row with no key, whose
    output is zeros).  This is ``repro.kernels.ref.attention_ref`` (and
    the Pallas ``flash_attention``) with the logsumexp added; it is
    differentiable by autograd, which the tests use as the reference of
    the kernel's backward."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qf = q.float().reshape(B, Hkv, G, S, D)
    s = torch.einsum("bngsd,bntd->bngst", qf, k.float()) * scale
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= j > i - window
    s = s.masked_fill(~ok, float("-inf"))
    m = s.detach().amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, NEG_INF)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bngst,bntd->bngsd", e / l, v.float())
    out = out.reshape(B, Hq, S, v.shape[-1]).to(q.dtype)
    if not return_lse:
        return out
    return out, (m + torch.log(l)).reshape(B, Hq, S)


def int8_quantize_ref(x: torch.Tensor, block: int = 256):
    """Per-block absmax int8: x (any shape) -> (codes int8 (rows, block),
    scales float32 (rows, 1)), rows = ceil(numel / block), each row
    ``block`` consecutive elements of the flattened input, the last one
    zero-padded.  ``scale = absmax / 127 + 1e-12`` by true division on
    every device, and ``code = clip(round_half_even(x / scale), -127,
    127)``: the arithmetic of ``repro.core.compression.int8_block_encode``
    (and the Pallas ``int8_quantize``).  A row holding a NaN gets a NaN
    scale; a NaN quotient codes as 0 (XLA's float-to-int conversion)."""
    flat = x.reshape(-1)
    pad = -flat.numel() % block
    if pad:
        flat = F.pad(flat, (0, pad))
    rows = flat.reshape(-1, block).float()
    amax = rows.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: on CUDA, ``amax / 127.0`` (a host scalar) would
    # multiply by the rounded reciprocal, one ulp off in some rows
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    q = rows.div(scale).round_().clamp_(-127, 127).nan_to_num_(nan=0.0)
    return q.to(torch.int8), scale


def int8_dequantize_ref(q: torch.Tensor, scales: torch.Tensor, shape,
                        dtype=torch.float32) -> torch.Tensor:
    """``code * scale`` in float32, cast to ``dtype``, trimmed to the first
    ``prod(shape)`` elements and reshaped: ``repro.kernels.ref.
    int8_dequantize_ref`` (and the Pallas ``int8_dequantize``)."""
    n = math.prod(shape)
    flat = (q.float() * scales).reshape(-1)
    return flat[:n].reshape(shape).to(dtype)
