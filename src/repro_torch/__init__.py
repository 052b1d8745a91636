"""PyTorch/CUDA port of ``repro``: its serving engine and its training
stack.

The package mirrors ``repro``'s layout (``models``, ``configs``,
``kernels``, ``serve``, ``train``, ``optim``, ``data``, ``checkpoint``,
``launch``) and imports neither JAX nor anything from ``repro``.  Entry points run on the CUDA device unless the caller
passes ``device="cpu"``; with no GPU and no explicit CPU request they
raise instead of silently running on the host.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, whatever the
    caller names otherwise.  Raises when CUDA is asked for (explicitly or
    by default) but no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run on the host explicitly")
    return dev


def device_of(tree) -> Optional[torch.device]:
    """Device of the first tensor in a nested dict/tuple tree."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else tree
    for v in items:
        d = device_of(v)
        if d is not None:
            return d
    return None
