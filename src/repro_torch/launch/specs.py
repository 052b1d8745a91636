"""Stand-ins for every model input of the dry-run: fake tensors (shape,
dtype and device, no storage) built by the port's own initializers under
a ``FakeTensorMode`` — the counterpart of ``repro.launch.specs``'s
``ShapeDtypeStruct`` trees.  Leaf paths, shapes and dtypes equal the JAX
package's ``jax.eval_shape`` trees.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_cache, init_params
from repro_torch.optim.adamw import adamw
from repro_torch.tree import tree_map


def batch_sds(cfg: ModelConfig, batch: int, seq: int, *, kind: str,
              device) -> Dict:
    """Training/prefill batches carry (B, S); decode carries (B, 1).
    VLM/audio backbones receive stub frontend embeddings for the prompt
    (prefill/train) and token ids during decode."""
    i32 = dict(dtype=torch.int32, device=device)
    if kind == "decode":
        return {"tokens": torch.empty((batch, 1), **i32)}
    out: Dict = {}
    if cfg.ext_embed_dim:
        out["embeds"] = torch.empty((batch, seq, cfg.ext_embed_dim),
                                    dtype=torch.float32, device=device)
    else:
        out["tokens"] = torch.empty((batch, seq), **i32)
    if kind == "train":
        out["labels"] = torch.empty((batch, seq), **i32)
    return out


def _on(tree, device) -> dict:
    """A fake tree made on the CPU, remade on ``device``: a fake copy
    moves no values, and needs no driver (the port's initializers insist
    on a real device for "cuda")."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=device), tree)


def params_sds(cfg: ModelConfig, device) -> dict:
    """The port's ``init_params`` tree (drawn on the CPU under the fake
    mode: a generator needs a real device), on ``device``."""
    return _on(init_params(0, cfg, device="cpu"), device)


def opt_state_sds(params: dict, optimizer=None) -> dict:
    bits = int(os.environ.get("REPRO_OPT_BITS", "32"))
    opt = optimizer or adamw(1e-4, state_bits=bits)
    return opt.init(params)


def caches_sds(cfg: ModelConfig, batch: int, cache_len: int, *, device,
               paged: bool = False, page_size: int = 16) -> dict:
    nb = max(1, -(-batch * cache_len // page_size))
    # one block-id space for every attention-family kind, as the JAX
    # package's default (num_blocks_swa=None)
    return _on(init_cache(cfg, batch, cache_len, paged=paged,
                          page_size=page_size, num_blocks=nb,
                          num_blocks_swa=nb, device="cpu"), device)


def positions_sds(batch: int, seq: int, device) -> torch.Tensor:
    return torch.empty((batch, seq), dtype=torch.int32, device=device)


def block_table_sds(batch: int, cache_len: int, page_size: int,
                    device) -> torch.Tensor:
    """(slots, n_cols) int32 block table for the paged engine step."""
    return torch.empty((batch, max(1, -(-cache_len // page_size))),
                       dtype=torch.int32, device=device)


def sampling_sds(cfg: ModelConfig, batch: int, device) -> Dict:
    """Per-slot sampling operands of the engine step: counter-based PRNG
    key data, temperature / top-p / top-k / repetition-penalty vectors,
    and the (slots, vocab) seen-token mask the penalty reads."""
    def e(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)
    return {"rng_keys": e((batch, 2), torch.uint32),
            "temperature": e((batch,), torch.float32),
            "top_p": e((batch,), torch.float32),
            "top_k": e((batch,), torch.int32),
            "rep_penalty": e((batch,), torch.float32),
            "seen": e((batch, cfg.vocab_size), torch.bool)}


def input_specs(arch: str, shape_name, *, paged: bool = False,
                page_size: int = 16, device: str = "cuda",
                mode: Optional[FakeTensorMode] = None) -> Dict:
    """All dry-run inputs for one (architecture, input-shape) pair (a
    name of ``INPUT_SHAPES``, or an ``InputShape`` of one's own), as
    fake tensors of ``mode`` (a new ``FakeTensorMode`` by default; it is
    returned as "mode", and the step that uses them must run under it).

    train  -> {params, opt_state, batch}
    prefill-> {params, caches, batch, positions}
    decode -> {params, caches, batch, positions}  (batch = one token)

    ``paged=True`` (decode only) swaps the dense caches for block pools
    and adds the engine-step operands: ``table`` plus the per-slot
    sampling vectors (see ``repro_torch.serve.engine.make_engine_step``).
    """
    cfg = get_config(arch)
    shape = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    B, S = shape.global_batch, shape.seq_len
    mode = mode or FakeTensorMode(allow_non_fake_inputs=True)
    dev = torch.device(device)
    with mode:
        out = {"cfg": cfg, "shape": shape, "mode": mode,
               "params": params_sds(cfg, dev)}
        if shape.kind == "train":
            out["opt_state"] = opt_state_sds(out["params"])
            out["batch"] = batch_sds(cfg, B, S, kind="train", device=dev)
        elif shape.kind == "prefill":
            out["caches"] = caches_sds(cfg, B, S, device=dev)
            out["batch"] = batch_sds(cfg, B, S, kind="prefill", device=dev)
            out["positions"] = positions_sds(B, S, dev)
        else:  # decode: one new token against a seq_len cache
            out["caches"] = caches_sds(cfg, B, S, device=dev, paged=paged,
                                       page_size=page_size)
            out["batch"] = batch_sds(cfg, B, 1, kind="decode", device=dev)
            out["positions"] = positions_sds(B, 1, dev)
            if paged:
                out["table"] = block_table_sds(B, S, page_size, dev)
                out["sampling"] = sampling_sds(cfg, B, dev)
    return out
