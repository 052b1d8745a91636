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
Every arch of the JAX package is ported.
"""
from __future__ import annotations

import importlib
from typing import Tuple

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


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
