"""Checkpointing: tree <-> npz with a JSON manifest, step-numbered
directories, retention policy and atomic writes (write to a temporary
directory, rename) — the counterpart of ``repro.checkpoint.store``, in
the same on-disk format: ``arrays.npz`` holds leaf i as ``a<i>``
(bfloat16 stored as float32) in JAX's flatten order, and
``manifest.json`` its ``keys`` (paths) and ``dtypes``.  So a checkpoint
written by either package restores in the other; this is how trained
state crosses between them.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, leaves, treedef_str, unflatten

_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
          torch.float16: "float16", torch.int32: "int32",
          torch.int64: "int64", torch.int8: "int8", torch.bool: "bool"}


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """bfloat16 has no numpy dtype npz can store: float32 instead (the
    manifest keeps the original dtype)."""
    leaf = leaf.detach()
    if leaf.dtype == torch.bfloat16:
        leaf = leaf.float()
    return leaf.cpu().numpy()


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomically write ``tree`` under ckpt_dir/step_<n>/; prune old."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = flatten_with_paths(tree)
    arrays = {f"a{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(flat)}
    manifest = {
        "step": step,
        "keys": [k for k, _ in flat],
        "treedef": treedef_str(tree),
        "dtypes": [_NAMES[leaf.dtype] for _, leaf in flat],
    }
    tmp = tempfile.mkdtemp(dir=ckpt_dir)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def restore(ckpt_dir: str, tree_like, step: Optional[int] = None):
    """Restore into the structure of ``tree_like``: (tree, step).  Each
    leaf takes the dtype and device of its counterpart in ``tree_like``;
    the leaf count and every shape must match."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    refs = list(leaves(tree_like))
    if len(manifest["keys"]) != len(refs):
        raise ValueError(f"checkpoint has {len(manifest['keys'])} leaves, "
                         f"expected {len(refs)}")
    out = []
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for i, ref in enumerate(refs):
            arr = data[f"a{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch at {manifest['keys'][i]}: "
                                 f"{arr.shape} vs {tuple(ref.shape)}")
            out.append(torch.from_numpy(arr).to(device=ref.device,
                                                dtype=ref.dtype))
    return unflatten(tree_like, iter(out)), step
