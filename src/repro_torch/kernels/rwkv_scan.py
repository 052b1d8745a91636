"""RWKV6 wkv recurrence: the wrapper of the Hopper kernel
``csrc/rwkv_scan.cu``.

For tensors on the CPU it runs the plain version (``ref.rwkv_scan_ref``).
For CUDA tensors it checks what the kernel takes, allocates the outputs,
and launches on PyTorch's current stream — or raises; nothing falls
back.  The kernel has no backward, so on CUDA it also raises when grad
mode is on and an input requires grad.  ``rwkv_scan_fwd.launches`` counts
launches, so a run can show that its RWKV time-mixes went through the kernel.
The launch is the custom op ``repro_torch::rwkv_scan`` (CUDA only), with a
fake implementation and a FLOP formula, so a dry-run traces it on fake
tensors without launching or counting anything; on a mesh the model
calls it on each rank's shard (``models.hints.LAYOUTS``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.ref import rwkv_scan_ref

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("rwkv_scan")
    if not getattr(lib, "_repro_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rwkv_scan_fwd.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.rwkv_scan_fwd.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _check(r, k, v, w, u, s0, rows, state_out, out_dtype) -> None:
    B, S, H, hd = r.shape
    if S < 1 or not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"rwkv_scan kernel takes S >= 1 and head dims <= "
                         f"{MAX_HEAD_DIM}: S={S} hd={hd}")
    if r.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"rwkv_scan kernel takes float32 / bfloat16, not "
                        f"{r.dtype} -> {out_dtype}")
    tensors = {"r": r, "k": k, "v": v, "w": w, "u": u}
    for name in ("k", "v"):
        if tensors[name].shape != r.shape or tensors[name].dtype != r.dtype:
            raise ValueError(f"{name} must match r's shape and dtype")
    if w.shape != r.shape or w.dtype != torch.float32:
        raise ValueError("w must be float32 (or bfloat16) of r's shape")
    if u.shape != (H, hd) or u.dtype != torch.float32:
        raise ValueError(f"u must be float32 ({H}, {hd})")
    for name, t in (("s0", s0), ("state_out", state_out)):
        if t is not None:
            if t.shape != (B, H, hd, hd) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 ({B}, {H}, {hd}, {hd})")
            tensors[name] = t
    if rows is not None:
        if rows.shape != (B,) or rows.dtype != torch.bool:
            raise ValueError(f"rows must be bool ({B},)")
        tensors["rows"] = rows
    if (s0 is not None and state_out is not None
            and state_out.data_ptr() != s0.data_ptr()):
        a, n = s0.data_ptr(), s0.numel() * 4
        c = state_out.data_ptr()
        if a < c + n and c < a + n:
            raise ValueError("state_out overlaps s0 without being s0")
    for name, t in tensors.items():
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rwkv_scan_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, *,
                  s0: Optional[torch.Tensor] = None, chunk: int = 64,
                  out_dtype: Optional[torch.dtype] = None,
                  return_state: bool = False,
                  rows: Optional[torch.Tensor] = None,
                  state_out: Optional[torch.Tensor] = None):
    """r, k, v (B,S,H,hd) float32 / bfloat16; w (B,S,H,hd) float32 (a
    bfloat16 w is upcast, which is exact); u (H,hd) float32; s0
    (B,H,hd,hd) float32 or None (zeros).  Returns o (B,S,H,hd) in
    ``out_dtype`` (default r.dtype), and with ``return_state`` also the
    final state.  ``state_out`` receives the final state and may be
    ``s0`` itself (in place); ``rows`` (B,) bool leaves the final state
    of False rows equal to ``s0``.  ``chunk`` is accepted for parity with
    the JAX signature and does not change the result.  See
    ``ref.rwkv_scan_ref`` for the semantics."""
    del chunk
    out_dtype = out_dtype or r.dtype
    want_state = return_state or state_out is not None
    if r.device.type == "cpu":
        o, st = rwkv_scan_ref(r, k, v, w, u, s0=s0, out_dtype=out_dtype,
                              return_state=True, rows=rows)
        if state_out is not None:
            st = state_out.copy_(st)
        return (o, st) if return_state else o
    if r.device.type != "cuda":
        raise ValueError(f"rwkv_scan_fwd: unsupported device {r.device}")
    refuse_autograd("rwkv_scan", r, k, v, w, u, s0)
    if w.dtype == torch.bfloat16:
        w = w.float()
    B, S, H, hd = r.shape
    if want_state and state_out is None:
        state_out = r.new_empty((B, H, hd, hd), dtype=torch.float32)
    o = torch.ops.repro_torch.rwkv_scan(r, k, v, w, u, s0, rows, state_out,
                                        out_dtype)
    return (o, state_out) if return_state else o


rwkv_scan_fwd.launches = 0


@torch.library.custom_op("repro_torch::rwkv_scan", mutates_args=("state_out",),
                         device_types="cuda")
def _rwkv_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
                    rows: Optional[torch.Tensor],
                    state_out: Optional[torch.Tensor],
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The launch: checks what the kernel takes, allocates the output,
    launches (the final state into ``state_out``, which may be ``s0``),
    and counts the launch."""
    _check(r, k, v, w, u, s0, rows, state_out, out_dtype)
    B, S, H, hd = r.shape
    o = torch.empty((B, S, H, hd), dtype=out_dtype, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _lib().rwkv_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            None if rows is None else rows.data_ptr(),
            None if state_out is None else state_out.data_ptr(),
            o.data_ptr(), B, S, H, hd, _DTYPES[r.dtype], _DTYPES[out_dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"rwkv_scan_fwd: CUDA launch failed "
                           f"(cudaError_t {err})")
    rwkv_scan_fwd.launches += 1
    return o


@_rwkv_scan_cuda.register_fake
def _(r, k, v, w, u, s0, rows, state_out, out_dtype):
    return r.new_empty(r.shape, dtype=out_dtype)


def rwkv_scan_flops(B: int, S: int, H: int, hd: int) -> int:
    """The matmul FLOPs ``FlopCounterMode`` counts for the plain version:
    one (1, hd) x (hd, hd) product per (step, slot, head)."""
    return 2 * B * S * H * hd * hd


@register_flop_formula(torch.ops.repro_torch.rwkv_scan)
def _(r_shape, *args, out_shape=None, **kwargs) -> int:
    return rwkv_scan_flops(*r_shape)
