"""Convert the JAX package's parameter, cache and optimizer-state trees
into the port's tensors, key for key.

Callers hand over numpy leaves (``jax.tree.map(np.asarray, tree)``), so
this module needs no JAX.  bfloat16 arrives as an ``ml_dtypes`` array,
which ``torch.from_numpy`` rejects: its bits travel through a ``uint16``
view and are reinterpreted as ``torch.bfloat16`` — exact.  Every leaf is
copied into storage of its own (broadcast JAX caches would otherwise
alias their periods).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.tree import leaves


def tensor_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _convert(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_convert(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def params_from_jax(tree, device: DeviceLike = None) -> dict:
    """JAX ``init_params`` tree (numpy leaves) -> the port's params."""
    return _convert(tree, resolve_device(device))


def caches_from_jax(tree, device: DeviceLike = None) -> dict:
    """JAX ``init_cache`` / engine cache tree (numpy leaves) -> the port's
    caches, each leaf with storage of its own."""
    return _convert(tree, resolve_device(device))


def opt_state_from_jax(state, device: DeviceLike = None) -> dict:
    """JAX optimizer state (numpy leaves) -> the port's: ``adamw``'s
    {"step", "master", "mu", "nu"} (8-bit moments as {"q", "s"} leaves)
    or ``sgd``'s {"step", "vel"}, structure and dtypes kept."""
    return _convert(state, resolve_device(device))


def executor_params_from_jax(tree, device: DeviceLike = None) -> dict:
    """A JAX ``SubDagExecutor``'s params ({op name: {"norm", "op"} or
    {"embed"} / {"norm", "head"}}, numpy leaves) -> the port's executor
    params: the same tree, floating leaves ready for autograd (leaves
    that require grad), as ``repro_torch.core.executor`` keeps them."""
    out = _convert(tree, resolve_device(device))
    for t in leaves(out):
        if t.is_floating_point():
            t.requires_grad_(True)
    return out
