"""Architecture registry of the port: the configs whose serving path is
ported — the dense full-attention ones (``gpt3-24l``, ``qwen3-8b``,
``llama3-405b``, ``qwen1.5-32b``, ``bert-large``), the attention + MoE
``qwen3-moe-235b-a22b``, the frontend-stub backbones
``llava-next-mistral-7b`` and ``musicgen-medium`` (precomputed patch /
frame embeddings through ``ext_proj``; their engines take tokens), the
attention-free ``rwkv6-7b``, the Mamba + attention + MoE hybrid
``jamba-1.5-large-398b``, the MLA + MoE + MTP ``deepseek-v3-671b`` and
``gemma3-12b`` (five sliding-window layers to one global one).

Each ``<arch>.py`` module exports ``CONFIG`` (the exact spec, source
cited) and ``SMOKE`` (a reduced same-family variant runnable on the CPU).
Every arch of the JAX package is ported.  ``INPUT_SHAPES`` and
``baseline_pairs`` are the dry-run's matrix (``launch/dryrun.py``).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "qwen3-8b": "qwen3_8b",
    "gpt3-24l": "gpt3_24l",
    "llama3-405b": "llama3_405b",
    "qwen1.5-32b": "qwen1_5_32b",
    "rwkv6-7b": "rwkv6_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "bert-large": "bert_large",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "musicgen-medium": "musicgen_medium",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "gemma3-12b": "gemma3_12b",
}

ALL_ARCHS: Tuple[str, ...] = tuple(_ARCH_MODULES)

# the ten assigned architectures of ``repro.configs`` in its order (the
# dry-run's baseline matrix); the paper's own bert-large and gpt3-24l
# are not among them
ASSIGNED_ARCHS: Tuple[str, ...] = (
    "jamba-1.5-large-398b", "gemma3-12b", "qwen1.5-32b",
    "llava-next-mistral-7b", "musicgen-medium", "qwen3-moe-235b-a22b",
    "rwkv6-7b", "qwen3-8b", "llama3-405b", "deepseek-v3-671b")


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) is part of the baseline matrix.
    long_500k needs a sub-quadratic decode path (SSM / hybrid / SWA) —
    pure full-attention archs are skipped per the assignment carve-out."""
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return False, "pure full-attention arch: no sub-quadratic long-context path"
    return True, ""


def baseline_pairs():
    """All (arch, shape) pairs in the baseline matrix, plus skip notes."""
    pairs, skips = [], []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in INPUT_SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            (pairs if ok else skips).append((arch, shape.name) if ok
                                            else (arch, shape.name, why))
    return pairs, skips
