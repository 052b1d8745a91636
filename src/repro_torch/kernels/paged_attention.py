"""Paged single-token decode attention: the wrapper of the Hopper kernel
``csrc/paged_attention.cu``.

For tensors on the CPU it runs the plain version
(``ref.paged_attention_ref``).  For CUDA tensors it checks what the
kernel takes, allocates the output and the float32 scratch of the
split-K partials, and launches on PyTorch's current stream — or raises;
nothing falls back.  The kernel has no backward, so on CUDA it also
raises when grad mode is on and an input requires grad.
``paged_attention_fwd.launches`` counts calls that launched the kernel
(one each: the split kernel merges its partials in the same launch; a
head-tiled instance launches its split kernel and the merge kernel), so
a run can show that its decode ticks went through it;
``paged_attention_fwd.window_launches`` counts those of them with a
window, so a run can tell a model's sliding-window layers from its
global ones, and ``paged_attention_fwd.instance_launches`` counts them
by the instance that ran (``instance``).  The launch is the custom op ``repro_torch::paged_attention``
(CUDA only), with a fake implementation and a FLOP formula, so a dry-run
traces it on fake tensors without launching or counting anything; on a
mesh the model calls it on each rank's shard (``models.hints.LAYOUTS``).

Query groups of up to ``MAX_GROUP`` heads with head dims up to
``MAX_HEAD_DIM`` run the split kernel, gemma3-12b's decode shape (bf16,
``WIDE_GROUP`` heads of ``WIDE_HEAD_DIM``) its wide-head instance, a warp
per K row with the exact group; larger ones (MLA's absorbed decode:
G = 128 heads over one latent head of 512 plus a 64-wide rope term) run
a head-tiled instance (``instance`` says which): at DeepSeek-V3's widths
in bf16 (D = Dv = ``MLA_HEAD_DIM``, a rope term of at most 64), with one
tensor passed as both k and v (MLA's latent pool) and 16-row pages, the
MLA instance: ``MLA_HEADS`` query heads a block on the tensor cores
(wgmma), splits of ``MLA_PAGES_PER_SPLIT`` table columns; otherwise the
CUDA-core one, ``TILE_HEADS`` a block.  Both stage a row of k once when
it is also v.

The split kernel's last block per (slot, kv head) is found with a counter
that the block resets; the counters live in one zeroed int32 buffer per
(device, stream), kept here and grown as B * Hkv grows.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, refuse_autograd
from repro_torch.kernels.ref import (MLA_PAGES_PER_SPLIT, PAGES_PER_SPLIT,
                                     paged_attention_ref)

MAX_HEAD_DIM = 256                # of the split kernel
MAX_GROUP = 16                    # of the split kernel
WIDE_GROUP = 2                    # of its wide-head instance: gemma3's
WIDE_HEAD_DIM = 256               # G = 2, D = Dv = 256, 16-row pages, bf16
WIDE_PAGE = 16
TILE_HEADS = 16                   # query heads a block of the tiled instance
MLA_HEADS = 64                    # of the MLA instance: wgmma's M
MLA_HEAD_DIM = 512                # its D = Dv (DeepSeek-V3's kv_lora_rank)
MLA_PAGE = 16
MLA_MAX_EXTRA = 64                # its widest rope term
_INSTANCES = {"split": 0, "tiled": 1, "mla": 2, "wide": 3}
MAX_SMEM_BYTES = 232_448          # 227 KB: what one Hopper block can use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if not getattr(lib, "_repro_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_attention_fwd.argtypes = ([p] * 11 + [i] * 9
                                            + [f, i, f, i, i, i, i, p])
        lib.paged_attention_fwd.restype = ctypes.c_int
        lib.paged_attention_smem_bytes.argtypes = [i] * 6
        lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
        lib.paged_attention_pages_per_split.argtypes = []
        lib.paged_attention_pages_per_split.restype = ctypes.c_int
        lib.paged_attention_part_floats.argtypes = [i, i]
        lib.paged_attention_part_floats.restype = ctypes.c_longlong
        lib.paged_attention_tiled_smem_bytes.argtypes = [i] * 6
        lib.paged_attention_tiled_smem_bytes.restype = ctypes.c_longlong
        lib.paged_attention_mla_smem_bytes.argtypes = []
        lib.paged_attention_mla_smem_bytes.restype = ctypes.c_longlong
        lib.paged_attention_wide_smem_bytes.argtypes = [i] * 3
        lib.paged_attention_wide_smem_bytes.restype = ctypes.c_longlong
        for fn in ("tile_heads", "mla_heads", "mla_pages_per_split"):
            getattr(lib, f"paged_attention_{fn}").argtypes = []
            getattr(lib, f"paged_attention_{fn}").restype = ctypes.c_int
        if (lib.paged_attention_pages_per_split(),
                lib.paged_attention_mla_pages_per_split()) != (
                    PAGES_PER_SPLIT, MLA_PAGES_PER_SPLIT):
            raise RuntimeError("paged_attention.cu and ref disagree on the "
                               "columns per split")
        if (lib.paged_attention_tile_heads(),
                lib.paged_attention_mla_heads()) != (TILE_HEADS, MLA_HEADS):
            raise RuntimeError("paged_attention.cu and the wrapper disagree "
                               "on the head tiles")
        lib._repro_typed = True
    return lib


def smem_bytes(inst: str, G: int, D: int, Dv: int, De: int, page: int,
               itemsize: int, kv_same: bool = False) -> int:
    """Dynamic shared memory one block of instance ``inst`` needs (from
    the kernel's own C functions, so the check and the launch share one
    formula)."""
    if inst == "mla":
        return int(_lib().paged_attention_mla_smem_bytes())
    if inst == "wide":
        return int(_lib().paged_attention_wide_smem_bytes(G, D, Dv))
    if inst == "tiled":
        return int(_lib().paged_attention_tiled_smem_bytes(
            D, Dv, De, page, itemsize, int(kv_same)))
    return int(_lib().paged_attention_smem_bytes(G, D, Dv, De, page,
                                                 itemsize))


def instance(G: int, D: int, Dv: int, De: int, page: int,
             dtype: torch.dtype, kv_same: bool, aligned: bool = True,
             vec: bool = True) -> str:
    """The kernel instance a call runs: "wide", the split kernel's
    instance for gemma3-12b's decode shape (bf16; G = ``WIDE_GROUP``;
    D = Dv = ``WIDE_HEAD_DIM``; no second contraction; 16-row pages;
    16-byte aligned q (``aligned``) and pools of 16-byte rows
    (``vec``)); else "split" (G <= ``MAX_GROUP``, head dims <=
    ``MAX_HEAD_DIM``); else a head-tiled one: "mla" on the tensor cores
    where its shape allows (bf16; k is v; 16-row pages; G a multiple of
    ``MLA_HEADS``; D = Dv = ``MLA_HEAD_DIM``; a rope term De of 8 to
    ``MLA_MAX_EXTRA``, a multiple of 8; 16-byte aligned q and q_extra and
    pools of 16-byte rows), else "tiled" on the CUDA cores (float32 among
    them: the tensor cores would round it)."""
    if (dtype == torch.bfloat16 and G == WIDE_GROUP and De == 0
            and D == Dv == WIDE_HEAD_DIM and page == WIDE_PAGE and aligned
            and vec):
        return "wide"
    if G <= MAX_GROUP and max(D, Dv, De) <= MAX_HEAD_DIM:
        return "split"
    if (dtype == torch.bfloat16 and kv_same and aligned and vec
            and page == MLA_PAGE and G % MLA_HEADS == 0
            and D == Dv == MLA_HEAD_DIM and 0 < De <= MLA_MAX_EXTRA
            and De % 8 == 0):
        return "mla"
    return "tiled"


_counters = {}   # (device index, stream) -> zeroed int32 counters


def _counters_for(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = _counters[key] = torch.zeros(max(n, 256), dtype=torch.int32,
                                           device=device)
    return buf


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
    q.dtype.  See ``ref.paged_attention_ref`` for the semantics;
    ``instance`` says which instance of the kernel runs.  On CUDA tensors
    (fake ones too) this is the custom op ``repro_torch::paged_attention``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_ref(q, k, v, pos, table, q_pos, scale=scale,
                                   window=window, softcap=softcap,
                                   q_extra=q_extra, k_extra=k_extra)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_fwd: unsupported device {q.device}")
    refuse_autograd("paged_attention", q, k, v, q_extra, k_extra)
    return torch.ops.repro_torch.paged_attention(
        q, k, v, pos, table, q_pos, q_extra, k_extra, float(scale),
        int(window), float(softcap))


paged_attention_fwd.launches = 0
paged_attention_fwd.window_launches = 0
paged_attention_fwd.instance_launches = dict.fromkeys(_INSTANCES, 0)


@torch.library.custom_op("repro_torch::paged_attention", mutates_args=(),
                         device_types="cuda")
def _paged_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor, table: torch.Tensor,
                          q_pos: torch.Tensor,
                          q_extra: Optional[torch.Tensor],
                          k_extra: Optional[torch.Tensor], scale: float,
                          window: int, softcap: float) -> torch.Tensor:
    """The launch: checks what the kernel takes, allocates the output and
    the split partials, launches, and counts the launch."""
    _check(q, k, v, pos, table, q_pos, q_extra, k_extra)
    B, _, Hq, D = q.shape
    N, page, Hkv, Dv = v.shape
    G = Hq // Hkv
    De = 0 if q_extra is None else q_extra.shape[-1]
    # 16-byte loads when every K/V row starts on a 16-byte boundary
    per16 = 16 // q.element_size()
    pools = (k, v) + ((k_extra,) if De else ())
    vec = (all(dim % per16 == 0 for dim in (D, Dv, De))
           and all(t.data_ptr() % 16 == 0 for t in pools))
    kv_same = (v.data_ptr() == k.data_ptr() and v.shape == k.shape
               and v.stride() == k.stride())
    aligned = all(t.data_ptr() % 16 == 0
                  for t in (q,) + ((q_extra,) if De else ()))
    chosen = instance(G, D, Dv, De, page, q.dtype, kv_same, aligned, vec)
    if chosen == "tiled" and not vec:
        raise ValueError(f"the head-tiled paged decode kernel takes head "
                         f"dims of whole 16-byte units and 16-byte aligned "
                         f"pools: D={D} Dv={Dv} De={De} {q.dtype}")
    smem = smem_bytes(chosen, G, D, Dv, De, page, q.element_size(), kv_same)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"paged decode kernel needs {smem} bytes of shared "
                         f"memory per block (> {MAX_SMEM_BYTES}): G={G} "
                         f"D={D} Dv={Dv} De={De} page={page}")
    n_cols = table.shape[1]
    per_split = MLA_PAGES_PER_SPLIT if chosen == "mla" else PAGES_PER_SPLIT
    n_splits = -(-n_cols // per_split)
    if n_splits > 65535:
        raise ValueError(f"paged decode kernel takes at most "
                         f"{65535 * per_split} table columns: {n_cols}")
    # the head-tiled instances keep partials per head tile
    heads = {"split": G, "wide": G, "tiled": TILE_HEADS,
             "mla": MLA_HEADS}[chosen]
    groups = B * Hkv * -(-G // heads)
    out = torch.empty((B, 1, Hq, Dv), dtype=q.dtype, device=q.device)
    part_floats = int(_lib().paged_attention_part_floats(heads, Dv))
    part = torch.empty(groups * n_splits * part_floats, dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        counter = _counters_for(q.device, stream, B * Hkv)
        err = _lib().paged_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            table.data_ptr(), q_pos.data_ptr(),
            q_extra.data_ptr() if De else None,
            k_extra.data_ptr() if De else None, out.data_ptr(),
            part.data_ptr(), counter.data_ptr(),
            B, Hkv, G, D, Dv, De, page, n_cols, N, float(scale),
            int(window), float(softcap), _DTYPES[q.dtype], int(vec),
            _INSTANCES[chosen], int(kv_same), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_fwd: CUDA launch failed "
                           f"(cudaError_t {err})")
    paged_attention_fwd.launches += 1
    paged_attention_fwd.instance_launches[chosen] += 1
    if window > 0:
        paged_attention_fwd.window_launches += 1
    return out


@_paged_attention_cuda.register_fake
def _(q, k, v, pos, table, q_pos, q_extra, k_extra, scale, window, softcap):
    B, _, Hq, _ = q.shape
    return q.new_empty((B, 1, Hq, v.shape[-1]))


def paged_attention_flops(B: int, Hq: int, n_cols: int, page: int, D: int,
                          Dv: int, De: int = 0) -> int:
    """The matmul FLOPs ``FlopCounterMode`` counts for the plain version:
    per table column, the scores (D, plus De for the second contraction)
    and the value product, over every column the table has."""
    return 2 * B * Hq * n_cols * page * (D + De + Dv)


@register_flop_formula(torch.ops.repro_torch.paged_attention)
def _(q_shape, k_shape, v_shape, pos_shape, table_shape, q_pos_shape,
      q_extra_shape, k_extra_shape, *args, out_shape=None, **kwargs) -> int:
    De = 0 if q_extra_shape is None else q_extra_shape[-1]
    return paged_attention_flops(q_shape[0], q_shape[2], table_shape[1],
                                 k_shape[1], q_shape[3], v_shape[3], De)
