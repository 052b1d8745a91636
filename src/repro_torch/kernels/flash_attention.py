"""Flash attention: the wrapper of the Hopper kernel
``csrc/flash_attention.cu`` and its autograd.

``flash_attention_fwd`` returns the output and the per-row logsumexp.
For tensors on the CPU it runs the plain version
(``ref.flash_attention_ref``).  For CUDA tensors it checks what the
kernel takes, allocates the outputs, and launches on PyTorch's current
stream — or raises; nothing falls back.  Called directly, it raises on
CUDA inputs that require grad under grad mode (the launch leaves no
autograd node); ``FlashAttention`` runs it with grad mode off and
differentiates it, each call in a ``tracing`` span (``attn.forward``,
``attn.backward``) with its shape.  ``flash_attention_fwd.launches``
counts launches, so a run can show that its attention went through the
kernel (``window_launches`` counts those with a sliding window apart).

``FlashAttention`` is the differentiable call: its forward is
``flash_attention_fwd``; its backward, ``flash_attention_bwd``, is plain
PyTorch — the FlashAttention-2 equations, blocked over kv tiles, from the
saved q, k, v, output and logsumexp.  (The JAX package has no backward
kernel: XLA differentiates its jnp attention.)
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 256
BLOCK_K = 512   # keys per kv tile of the plain backward
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_repro_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_fwd.argtypes = [p] * 5 + [i] * 6 + [f, i, i, i, p]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_tensor_cores.argtypes = [i, i]
        lib.flash_attention_tensor_cores.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [i, i]
        lib.flash_attention_smem_bytes.restype = ctypes.c_longlong
        lib._repro_typed = True
    return lib


def instance(dtype: torch.dtype, D: int) -> dict:
    """Which kernel instance a call with 16-byte aligned inputs of this
    dtype and head dim takes (``tensor_cores``: the wgmma instance) and
    the dynamic shared memory of one of its blocks."""
    lib, code = _lib(), _DTYPES[dtype]
    return {"tensor_cores": bool(lib.flash_attention_tensor_cores(code, D)),
            "smem_bytes": int(lib.flash_attention_smem_bytes(code, D))}


def _check(q, k, v) -> None:
    B, Hq, S, D = q.shape
    if k.ndim != 4 or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    Hkv, T = k.shape[1], k.shape[2]
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} must match k {tuple(k.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if S < 1 or T < 1 or not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash kernel takes S, T >= 1 and head dims <= "
                         f"{MAX_HEAD_DIM}: S={S} T={T} D={D}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernel takes float32 / bfloat16, not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None):
    """q (B,Hq,S,D), k / v (B,Hkv,T,D), float32 or bfloat16.  Returns
    (out (B,Hq,S,D) in q.dtype, lse (B,Hq,S) float32).  See
    ``ref.flash_attention_ref`` for the semantics."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    refuse_autograd("flash_attention", q, k, v)
    _check(q, k, v)
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, S, T, D, float(scale), int(causal),
            int(window), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd: CUDA launch failed "
                           f"(cudaError_t {err})")
    flash_attention_fwd.launches += 1
    if window > 0:
        flash_attention_fwd.window_launches += 1
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.window_launches = 0     # the launches with a window


def flash_attention_bwd(q, k, v, out, lse, d_out, *, causal: bool = True,
                        window: int = 0, scale: Optional[float] = None):
    """Gradients (dq, dk, dv) of ``flash_attention_fwd``'s output, in
    plain PyTorch and float32, from the saved inputs, output and
    logsumexp.  Per kv tile of ``BLOCK_K`` keys, for the query rows that
    see at least one of its keys:

        P = exp(S - lse) (masked to 0),   D = rowsum(dO * O)
        dV += P^T dO,   dS = P * (dO V^T - D)
        dQ += dS K * scale,   dK += dS^T Q * scale

    with dK and dV summed over each kv head's G query heads.  No more
    than (rows, BLOCK_K) scores of a head exist at once."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qf = q.float().reshape(B, Hkv, G, S, D)
    do = d_out.float().reshape(B, Hkv, G, S, D)
    lse = lse.reshape(B, Hkv, G, S, 1)
    delta = (do * out.float().reshape(B, Hkv, G, S, D)).sum(-1, keepdim=True)
    dq = torch.zeros_like(qf)
    dk = torch.zeros((B, Hkv, T, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for t0 in range(0, T, BLOCK_K):
        t1 = min(T, t0 + BLOCK_K)
        # rows before t0 see no key of a causal tile; rows at or past
        # t1 - 1 + window see none behind the window
        lo = min(t0, S) if causal else 0
        hi = min(S, t1 - 1 + window) if window > 0 else S
        if lo >= hi:
            continue
        kj, vj = k[:, :, t0:t1].float(), v[:, :, t0:t1].float()
        i = torch.arange(lo, hi, device=q.device)[:, None]
        j = torch.arange(t0, t1, device=q.device)[None, :]
        ok = torch.ones((hi - lo, t1 - t0), dtype=torch.bool, device=q.device)
        if causal:
            ok &= j <= i
        if window > 0:
            ok &= j > i - window
        qi, doi = qf[:, :, :, lo:hi], do[:, :, :, lo:hi]
        s = torch.einsum("bngrd,bncd->bngrc", qi, kj) * scale
        p = torch.where(ok, torch.exp(s - lse[:, :, :, lo:hi]), 0.0)
        del s
        dv[:, :, t0:t1] = torch.einsum("bngrc,bngrd->bncd", p, doi)
        ds = p * (torch.einsum("bngrd,bncd->bngrc", doi, vj)
                  - delta[:, :, :, lo:hi])
        del p
        dq[:, :, :, lo:hi] += torch.einsum("bngrc,bncd->bngrd", ds, kj) * scale
        dk[:, :, t0:t1] = torch.einsum("bngrc,bngrd->bncd", ds, qi) * scale
    return (dq.reshape(B, Hq, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _span(name, q, k, causal, window):
    """A ``tracing`` span with the call's shape, built only when spans
    record."""
    if not tracing.enabled():
        return tracing.NULL
    B, Hq, S, D = q.shape
    return tracing.span(name, B=B, Hq=Hq, Hkv=k.shape[1], S=S, T=k.shape[2],
                        D=D, causal=bool(causal), window=int(window),
                        dtype=str(q.dtype).removeprefix("torch."))


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the kernel forward (the plain
    version on CPU tensors) and the plain blocked backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        with _span("attn.forward", q, k, causal, window):
            out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                           window=window, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        with _span("attn.backward", q, k, ctx.opts["causal"],
                   ctx.opts["window"]):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, d_out,
                                             **ctx.opts)
        return dq, dk, dv, None, None, None
