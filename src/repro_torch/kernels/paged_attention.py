"""Paged single-token decode attention: the wrapper of the Hopper kernel
``csrc/paged_attention.cu``.

For tensors on the CPU it runs the plain version
(``ref.paged_attention_ref``).  For CUDA tensors it checks what the
kernel takes, allocates the output, and launches on PyTorch's current
stream — or raises; nothing falls back.  ``paged_attention_fwd.launches``
counts launches, so a run can show that its decode ticks went through
the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attention_ref

MAX_HEAD_DIM = 256
MAX_GROUP = 16
MAX_SMEM_BYTES = 232_448          # 227 KB: what one Hopper block can use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if not getattr(lib, "_repro_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_fwd.argtypes = ([p] * 9 + [i] * 9
                                            + [f, i, f, i, i, p])
        lib.paged_attention_fwd.restype = ctypes.c_int
        lib.paged_attention_smem_bytes.argtypes = [i] * 5
        lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
        lib._repro_typed = True
    return lib


def smem_bytes(G: int, D: int, Dv: int, De: int, page: int) -> int:
    """Dynamic shared memory one kernel block needs (from the kernel's
    own C function, so the check and the launch share one formula)."""
    return int(_lib().paged_attention_smem_bytes(G, D, Dv, De, page))


def _check(q, k, v, pos, table, q_pos, q_extra, k_extra) -> None:
    B, S, Hq, D = q.shape
    N, page, Hkv, Dv = v.shape
    if S != 1:
        raise ValueError(f"paged decode kernel is single-token: S={S}")
    if k.shape != (N, page, Hkv, D):
        raise ValueError(f"k pool {tuple(k.shape)} does not match q / v")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged decode kernel takes float32 / bfloat16, "
                        f"not {q.dtype}")
    tensors = {"q": q, "k": k, "v": v, "pos": pos, "table": table,
               "q_pos": q_pos}
    if (q_extra is None) != (k_extra is None):
        raise ValueError("q_extra and k_extra come together")
    if q_extra is not None:
        De = q_extra.shape[-1]
        if q_extra.shape != (B, 1, Hq, De) or k_extra.shape != (N, page, Hkv, De):
            raise ValueError("q_extra / k_extra shapes do not match q / k")
        tensors.update(q_extra=q_extra, k_extra=k_extra)
    for name in ("k", "v", "q_extra", "k_extra"):
        if name in tensors and tensors[name].dtype != q.dtype:
            raise TypeError(f"{name} is {tensors[name].dtype}, q is {q.dtype}")
    for name in ("pos", "table", "q_pos"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, not {tensors[name].dtype}")
    if pos.shape != (N, page) or table.shape[0] != B or q_pos.numel() != B:
        raise ValueError("pos / table / q_pos shapes do not match the pool")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos: torch.Tensor, table: torch.Tensor,
                        q_pos: torch.Tensor, *, scale: Optional[float] = None,
                        window: int = 0, softcap: float = 0.0,
                        q_extra: Optional[torch.Tensor] = None,
                        k_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,1,Hq,D); k (N,page,Hkv,D); v (N,page,Hkv,Dv); pos (N,page)
    int32; table (B,n_cols) int32; q_pos (B,1) int32; optional q_extra
    (B,1,Hq,De) / k_extra (N,page,Hkv,De).  Returns (B,1,Hq,Dv) in
    q.dtype.  See ``ref.paged_attention_ref`` for the semantics."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_ref(q, k, v, pos, table, q_pos, scale=scale,
                                   window=window, softcap=softcap,
                                   q_extra=q_extra, k_extra=k_extra)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_fwd: unsupported device {q.device}")
    _check(q, k, v, pos, table, q_pos, q_extra, k_extra)
    B, _, Hq, D = q.shape
    N, page, Hkv, Dv = v.shape
    G = Hq // Hkv
    De = 0 if q_extra is None else q_extra.shape[-1]
    if max(D, Dv, De) > MAX_HEAD_DIM or G > MAX_GROUP:
        raise ValueError(f"paged decode kernel takes head dims <= "
                         f"{MAX_HEAD_DIM} and G <= {MAX_GROUP}: D={D} "
                         f"Dv={Dv} De={De} G={G}")
    smem = smem_bytes(G, D, Dv, De, page)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged decode kernel needs {smem} bytes of shared "
                         f"memory per block (> {MAX_SMEM_BYTES}): G={G} "
                         f"D={D} Dv={Dv} De={De} page={page}")
    # 16-byte loads when every K/V row starts on a 16-byte boundary
    per16 = 16 // q.element_size()
    pools = (k, v) + ((k_extra,) if De else ())
    vec = (all(dim % per16 == 0 for dim in (D, Dv, De))
           and all(t.data_ptr() % 16 == 0 for t in pools))
    out = torch.empty((B, 1, Hq, Dv), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().paged_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            table.data_ptr(), q_pos.data_ptr(),
            q_extra.data_ptr() if De else None,
            k_extra.data_ptr() if De else None, out.data_ptr(),
            B, Hkv, G, D, Dv, De, page, table.shape[1], N, float(scale),
            int(window), float(softcap), _DTYPES[q.dtype], int(vec), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_fwd: CUDA launch failed "
                           f"(cudaError_t {err})")
    paged_attention_fwd.launches += 1
    return out


paged_attention_fwd.launches = 0
