"""Per-block absmax int8 quantization: the wrappers of the Hopper kernels
``csrc/quantize.cu``.

For tensors on the CPU they run the plain versions
(``ref.int8_quantize_ref`` / ``ref.int8_dequantize_ref``).  For CUDA
tensors they check what the kernels take, allocate the outputs, and
launch on PyTorch's current stream — or raise; nothing falls back.  The
kernels have no backward, so on CUDA they also raise when grad mode is on
and an input requires grad.  ``int8_quantize_fwd.launches`` and
``int8_dequantize_fwd.launches`` count launches, so a run can show that
its compression went through the kernels.  Element counts cross the C interface as 64-bit integers: one
launch codes a gradient of more than 2^31 elements.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.ref import int8_dequantize_ref, int8_quantize_ref

DEFAULT_BLOCK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("quantize")
    if not getattr(lib, "_repro_typed", False):
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.int8_quantize_fwd.argtypes = [p, p, p, i64, i64, i, i, i, p]
        lib.int8_quantize_fwd.restype = ctypes.c_int
        lib.int8_dequantize_fwd.argtypes = [p, p, p, i64, i, i, i, p]
        lib.int8_dequantize_fwd.restype = ctypes.c_int
        lib._repro_typed = True
    return lib


def _stream(device: torch.device):
    return torch.cuda.current_stream(device).cuda_stream


def int8_quantize_fwd(x: torch.Tensor, *, block: int = DEFAULT_BLOCK):
    """x: any shape, float32 or bfloat16 -> (codes int8 (rows, block),
    scales float32 (rows, 1)), rows = ceil(numel / block).  See
    ``ref.int8_quantize_ref`` for the semantics."""
    if block < 1:
        raise ValueError(f"int8_quantize: block must be >= 1, not {block}")
    if x.device.type == "cpu":
        return int8_quantize_ref(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"int8_quantize_fwd: unsupported device {x.device}")
    refuse_autograd("int8_quantize", x)
    if x.dtype not in _DTYPES:
        raise TypeError(f"int8_quantize kernel takes float32 / bfloat16, "
                        f"not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("int8_quantize kernel takes a contiguous input")
    n = x.numel()
    rows = -(-n // block)
    q = torch.empty((rows, block), dtype=torch.int8, device=x.device)
    s = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    if n == 0:
        return q, s
    vec_ok = int(block % 8 == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        err = _lib().int8_quantize_fwd(x.data_ptr(), q.data_ptr(),
                                       s.data_ptr(), n, rows, block,
                                       _DTYPES[x.dtype], vec_ok,
                                       _stream(x.device))
    if err != 0:
        raise RuntimeError(f"int8_quantize_fwd: CUDA launch failed "
                           f"(cudaError_t {err})")
    int8_quantize_fwd.launches += 1
    return q, s


def int8_dequantize_fwd(q: torch.Tensor, scales: torch.Tensor, shape,
                        dtype=torch.float32) -> torch.Tensor:
    """codes int8 (rows, block), scales float32 (rows, 1) -> ``code *
    scale`` as ``dtype`` (float32 or bfloat16) of ``shape``, written
    straight from the first ``prod(shape)`` codes (no padded
    intermediate).  See ``ref.int8_dequantize_ref``."""
    shape = tuple(shape)
    n = math.prod(shape)
    if q.ndim != 2 or scales.shape != (q.shape[0], 1):
        raise ValueError(f"codes (rows, block) and scales (rows, 1) expected, "
                         f"got {tuple(q.shape)} and {tuple(scales.shape)}")
    if n > q.numel():
        raise ValueError(f"shape {shape} holds {n} elements, the codes only "
                         f"{q.numel()}")
    if q.device.type == "cpu":
        return int8_dequantize_ref(q, scales, shape, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"int8_dequantize_fwd: unsupported device {q.device}")
    refuse_autograd("int8_dequantize", scales)
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"int8_dequantize kernel takes int8 codes and float32 "
                        f"scales, not {q.dtype} / {scales.dtype}")
    if dtype not in _DTYPES:
        raise TypeError(f"int8_dequantize kernel writes float32 / bfloat16, "
                        f"not {dtype}")
    if scales.device != q.device:
        raise ValueError(f"scales are on {scales.device}, codes on {q.device}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("int8_dequantize kernel takes contiguous codes and "
                         "scales")
    out = torch.empty(shape, dtype=dtype, device=q.device)
    if n == 0:
        return out
    block = q.shape[1]
    vec_ok = int(block % 8 == 0 and q.data_ptr() % 8 == 0
                 and out.data_ptr() % 16 == 0)
    with torch.cuda.device(q.device):
        err = _lib().int8_dequantize_fwd(q.data_ptr(), scales.data_ptr(),
                                         out.data_ptr(), n, block,
                                         _DTYPES[dtype], vec_ok,
                                         _stream(q.device))
    if err != 0:
        raise RuntimeError(f"int8_dequantize_fwd: CUDA launch failed "
                           f"(cudaError_t {err})")
    int8_dequantize_fwd.launches += 1
    return out


int8_quantize_fwd.launches = 0
int8_dequantize_fwd.launches = 0
