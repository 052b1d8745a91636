"""Mamba selective scan: the wrapper of the Hopper kernel
``csrc/mamba_scan.cu``.

For tensors on the CPU it runs the plain version (``ref.mamba_scan_ref``).
For CUDA tensors it checks what the kernel takes, allocates the outputs,
and launches on PyTorch's current stream — or raises; nothing falls
back.  The kernel has no backward, so on CUDA it also raises when grad
mode is on and an input requires grad.  ``mamba_scan_fwd.launches`` counts
launches, so a run can show that its Mamba mixers went through the kernel.
The launch is the custom op ``repro_torch::mamba_scan`` (CUDA only), with
a fake implementation and a FLOP formula, so a dry-run traces it on fake
tensors without launching or counting anything; on a mesh the model
calls it on each rank's shard (``models.hints.LAYOUTS``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.ref import mamba_scan_ref

MAX_D_STATE = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("mamba_scan")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mamba_scan_fwd.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.mamba_scan_fwd.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check(x, dt, b, c, a, h0, rows, state_out, out_dtype) -> None:
    B, S, di = x.shape
    ds = b.shape[-1]
    if S < 1 or not 1 <= ds <= MAX_D_STATE or B > 65535:
        raise ValueError(f"mamba_scan kernel takes S >= 1, d_state <= "
                         f"{MAX_D_STATE} and B <= 65535: B={B} S={S} ds={ds}")
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"mamba_scan kernel takes float32 / bfloat16, not "
                        f"{x.dtype} -> {out_dtype}")
    tensors = {"x": x, "dt": dt, "b": b, "c": c, "a": a}
    if dt.shape != x.shape or dt.dtype != x.dtype:
        raise ValueError("dt must match x's shape and dtype")
    for name in ("b", "c"):
        if tensors[name].shape != (B, S, ds) or tensors[name].dtype != x.dtype:
            raise ValueError(f"{name} must be {x.dtype} ({B}, {S}, {ds})")
    if a.shape != (di, ds) or a.dtype != torch.float32:
        raise ValueError(f"a must be float32 ({di}, {ds})")
    for name, t in (("h0", h0), ("state_out", state_out)):
        if t is not None:
            if t.shape != (B, di, ds) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 ({B}, {di}, {ds})")
            tensors[name] = t
    if rows is not None:
        if rows.shape != (B,) or rows.dtype != torch.bool:
            raise ValueError(f"rows must be bool ({B},)")
        tensors["rows"] = rows
    if (h0 is not None and state_out is not None
            and state_out.data_ptr() != h0.data_ptr()):
        lo, n = h0.data_ptr(), h0.numel() * 4
        so = state_out.data_ptr()
        if lo < so + n and so < lo + n:
            raise ValueError("state_out overlaps h0 without being h0")
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def mamba_scan_fwd(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor, *,
                   h0: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None,
                   return_state: bool = False,
                   rows: Optional[torch.Tensor] = None,
                   state_out: Optional[torch.Tensor] = None):
    """x, dt (B,S,di) and b, c (B,S,ds), all float32 or all bfloat16; a
    (di,ds) float32; h0 (B,di,ds) float32 or None (zeros).  Returns y
    (B,S,di) in ``out_dtype`` (default x.dtype), and with
    ``return_state`` also the final state.  ``state_out`` receives the
    final state and may be ``h0`` itself (in place); ``rows`` (B,) bool
    leaves the final state of False rows equal to ``h0``.  See
    ``ref.mamba_scan_ref`` for the semantics."""
    out_dtype = out_dtype or x.dtype
    want_state = return_state or state_out is not None
    if x.device.type == "cpu":
        y, h = mamba_scan_ref(x, dt, b, c, a, h0=h0, out_dtype=out_dtype,
                              return_state=True, rows=rows)
        if state_out is not None:
            h = state_out.copy_(h)
        return (y, h) if return_state else y
    if x.device.type != "cuda":
        raise ValueError(f"mamba_scan_fwd: unsupported device {x.device}")
    refuse_autograd("mamba_scan", x, dt, b, c, a, h0)
    B, S, di = x.shape
    ds = b.shape[-1]
    if want_state and state_out is None:
        state_out = x.new_empty((B, di, ds), dtype=torch.float32)
    y = torch.ops.repro_torch.mamba_scan(x, dt, b, c, a, h0, rows, state_out,
                                         out_dtype)
    return (y, state_out) if return_state else y


mamba_scan_fwd.launches = 0


@torch.library.custom_op("repro_torch::mamba_scan",
                         mutates_args=("state_out",), device_types="cuda")
def _mamba_scan_cuda(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, a: torch.Tensor,
                     h0: Optional[torch.Tensor], rows: Optional[torch.Tensor],
                     state_out: Optional[torch.Tensor],
                     out_dtype: torch.dtype) -> torch.Tensor:
    """The launch: checks what the kernel takes, allocates the output,
    launches (the final state into ``state_out``, which may be ``h0``),
    and counts the launch."""
    _check(x, dt, b, c, a, h0, rows, state_out, out_dtype)
    B, S, di = x.shape
    ds = b.shape[-1]
    y = torch.empty((B, S, di), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().mamba_scan_fwd(
            x.data_ptr(), dt.data_ptr(), b.data_ptr(), c.data_ptr(),
            a.data_ptr(), None if h0 is None else h0.data_ptr(),
            None if rows is None else rows.data_ptr(),
            None if state_out is None else state_out.data_ptr(),
            y.data_ptr(), B, S, di, ds, _DTYPES[x.dtype], _DTYPES[out_dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_fwd: CUDA launch failed "
                           f"(cudaError_t {err})")
    mamba_scan_fwd.launches += 1
    return y


@_mamba_scan_cuda.register_fake
def _(x, dt, b, c, a, h0, rows, state_out, out_dtype):
    return x.new_empty(x.shape, dtype=out_dtype)


def mamba_scan_flops(B: int, S: int, di: int, ds: int) -> int:
    """The matmul FLOPs ``FlopCounterMode`` counts for the plain version:
    the (di, ds) x (ds,) output contraction per (step, slot)."""
    return 2 * B * S * di * ds


@register_flop_formula(torch.ops.repro_torch.mamba_scan)
def _(x_shape, dt_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    B, S, di = x_shape
    return mamba_scan_flops(B, S, di, b_shape[-1])
