"""Decoder model of the port: full-attention (GQA or MLA), sliding-window,
Mamba or RWKV6 layers with SwiGLU or mixture-of-experts FFNs, the embedding frontend
stub and the multi-token-prediction head, built from a ``ModelConfig``
like ``repro.models.transformer``.

Parameters and decode caches are nested dicts under the JAX package's
key names.  Stack leaves carry a leading ``n_periods`` axis; ``forward``
loops over it in Python (the JAX version's ``lax.scan``), and the cache
of period i is a view into the stacked storage, written in place.
Without a cache the forward is differentiable: ``remat`` recomputes each
period in the backward pass, as the JAX version's ``jax.checkpoint``.
``Transformer`` is the ``nn.Module`` that owns such a parameter tree.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                      create_selective_checkpoint_contexts)

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import mla, ssm
from repro_torch.models import hints
from repro_torch.models.hints import constrain
from repro_torch.models.config import (ATTN, DENSE, MAMBA, MOE, RWKV, SWA,
                                       ModelConfig)
from repro_torch.models.layers import (attn_apply, attn_init, cache_init,
                                       dense_init, embed_init, ffn_apply,
                                       ffn_init, moe_apply, moe_init,
                                       paged_cache_init, rmsnorm,
                                       rmsnorm_init)
from repro_torch.tree import leaves


def _check_layer(spec) -> None:
    if spec.mixer not in (ATTN, SWA, MAMBA, RWKV) or spec.ffn not in (DENSE,
                                                                       MOE):
        raise NotImplementedError(
            f"repro_torch: layer {spec} is not ported (full-attention, "
            f"sliding-window, Mamba and RWKV6 layers with dense or MoE FFNs "
            f"only)")


def check_ported(cfg: ModelConfig) -> None:
    for spec in tuple(cfg.prefix_layers) + tuple(cfg.period):
        _check_layer(spec)


# ---------------------------------------------------------------------------
# Per-layer init / apply
# ---------------------------------------------------------------------------

def layer_init(gen: torch.Generator, spec, cfg: ModelConfig, lead=(),
               device=None) -> dict:
    _check_layer(spec)
    attn = mla.mla_init if cfg.use_mla else attn_init
    mixer_init = {ATTN: attn, SWA: attn, MAMBA: ssm.mamba_init,
                  RWKV: ssm.rwkv_init}[spec.mixer]
    mixer = mixer_init(gen, cfg, lead, device)      # drawn before the FFN
    ffn = (moe_init(gen, cfg, lead, device) if spec.ffn == MOE
           else ffn_init(gen, cfg, lead=lead, device=device))
    return {"norm1": rmsnorm_init(cfg.d_model, lead, device),
            "norm2": rmsnorm_init(cfg.d_model, lead, device),
            "mixer": mixer, "ffn": ffn}


def layer_cache_init(spec, cfg: ModelConfig, batch: int, cache_len: int,
                     dtype=torch.bfloat16, *, paged: bool = False,
                     page_size: int = 16, num_blocks: int = 0,
                     num_blocks_swa: Optional[int] = None, lead=(),
                     device=None) -> dict:
    """Dense per-slot KV cache, or (``paged=True``) a block pool of
    ``num_blocks`` pages shared through the block table.  Mamba and RWKV
    state is per slot either way (a recurrent carry has no sequence axis
    to page).  MLA layers keep the latent cache ("ckv", "krope", "pos").
    A sliding-window layer keeps a dense ring of ``min(window,
    cache_len)`` entries, or a pool of ``num_blocks_swa`` pages, its own
    block-id space (required when ``paged``)."""
    _check_layer(spec)
    if spec.mixer == MAMBA:
        return ssm.mamba_cache_init(batch, cfg, dtype, lead, device)
    if spec.mixer == RWKV:
        return ssm.rwkv_cache_init(batch, cfg, dtype, lead, device)
    if spec.mixer == SWA:
        if paged:
            if num_blocks_swa is None:
                raise ValueError("a paged sliding-window layer needs "
                                 "num_blocks_swa, its ring pool's pages")
            num_blocks = num_blocks_swa
        else:
            cache_len = min(cfg.sliding_window, cache_len)
    if cfg.use_mla:
        if paged:
            return mla.mla_paged_cache_init(num_blocks, page_size, cfg,
                                            dtype, lead, device)
        return mla.mla_cache_init(batch, cache_len, cfg, dtype, lead, device)
    if paged:
        return paged_cache_init(num_blocks, page_size, cfg.n_kv_heads,
                                cfg.head_dim, dtype, lead, device)
    return cache_init(batch, cache_len, cfg.n_kv_heads, cfg.head_dim, dtype,
                      lead, device)


def layer_apply(lp: dict, spec, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[dict], *,
                decode: bool = False, kv_chunk: int = 1024,
                masked_slots: bool = False, block_table=None,
                use_kernel: bool = False,
                scan_kernel: Optional[bool] = None):
    """Pre-norm residual block: x + mixer(norm1(x)), then + ffn(norm2(x)).
    Returns (x, cache, aux_loss); the cache is written in place.
    ``decode``: single-token cache paths (MLA's absorbed attention).

    ``masked_slots``: rows whose positions are all < 0 (idle serving
    slots) keep their cache bit for bit — attention caches entry-wise
    through the masked cache write, Mamba and RWKV state row-wise (they
    ran the scan on padding).  ``use_kernel``: paged single-token decode
    attention runs the paged-decode kernel; the Mamba and RWKV
    recurrences run the ``mamba_scan`` / ``rwkv_scan`` kernels at every
    S, unless ``scan_kernel`` (None: as ``use_kernel``) is False.  MoE
    FFNs return their load-balance loss as ``aux_loss``."""
    _check_layer(spec)
    x = constrain(x, "residual")
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    if spec.mixer in (MAMBA, RWKV):
        valid = ((positions >= 0).any(dim=1)
                 if masked_slots and cache is not None else None)
        apply = ssm.mamba_apply if spec.mixer == MAMBA else ssm.rwkv_apply
        h, cache = apply(lp["mixer"], h, cfg, cache=cache, valid=valid,
                         use_kernel=(use_kernel if scan_kernel is None
                                     else scan_kernel))
    elif cfg.use_mla:
        h, cache = mla.mla_apply(lp["mixer"], h, cfg, positions=positions,
                                 cache=cache, decode=decode,
                                 kv_chunk=kv_chunk,
                                 masked_slots=masked_slots,
                                 table=block_table, use_kernel=use_kernel)
    else:
        window = cfg.sliding_window if spec.mixer == SWA else 0
        h, cache = attn_apply(lp["mixer"], h, cfg, positions=positions,
                              cache=cache, window=window, kv_chunk=kv_chunk,
                              masked_slots=masked_slots, table=block_table,
                              use_kernel=use_kernel)
    x = x + h
    h = rmsnorm(x, lp["norm2"], cfg.norm_eps)
    if spec.ffn == MOE:
        h, aux = moe_apply(lp["ffn"], h, cfg)
    else:
        h = ffn_apply(lp["ffn"], h)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # the residual leaves the layer in its hinted layout too, so that no
    # partial sum (a row-split projection's) crosses a remat boundary
    return constrain(x + h, "residual"), cache, aux


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def init_params(seed: int, cfg: ModelConfig, *,
                device: DeviceLike = None) -> dict:
    """Random parameters drawn on ``device`` (cuda unless "cpu" is asked
    for) from a generator seeded with ``seed``: the shapes, scales and
    dtypes of ``repro.models.transformer.init_params``, not its numbers
    (parity tests convert the JAX package's parameters instead)."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model,
                                  device=dev),
              "final_norm": rmsnorm_init(cfg.d_model, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       device=dev)
    if cfg.ext_embed_dim:
        params["ext_proj"] = dense_init(gen, cfg.ext_embed_dim, cfg.d_model,
                                        device=dev)
    if cfg.prefix_layers:
        params["prefix"] = tuple(layer_init(gen, spec, cfg, device=dev)
                                 for spec in cfg.prefix_layers)
    for stack in cfg.stacks:
        params["stack"] = tuple(
            layer_init(gen, spec, cfg, lead=(stack.n_periods,), device=dev)
            for spec in stack.period)
    if cfg.mtp_depth:
        params["mtp"] = {
            "norm_h": rmsnorm_init(cfg.d_model, device=dev),
            "norm_e": rmsnorm_init(cfg.d_model, device=dev),
            "proj": dense_init(gen, 2 * cfg.d_model, cfg.d_model, device=dev),
            "layer": layer_init(gen, cfg.period[-1], cfg, device=dev),
        }
    return params


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, *, paged: bool = False,
               page_size: int = 16, num_blocks: Optional[int] = None,
               num_blocks_swa: Optional[int] = None,
               device: DeviceLike = None) -> dict:
    """Decode-cache tree.  ``paged=True`` replaces the dense per-slot
    (batch, cache_len, ...) caches with per-layer block pools of
    ``num_blocks`` pages (default: the dense cache's memory);
    ``num_blocks_swa`` sizes the sliding-window pools, a block-id space
    of their own (required when ``paged`` and the model has such layers).  Stack leaves get REAL per-period storage (n_periods,
    ...): an ``expand`` would alias every period and in-place writes
    would corrupt them."""
    check_ported(cfg)
    dev = resolve_device(device)
    if num_blocks is None:
        num_blocks = max(1, -(-batch * cache_len // page_size))
    kw = dict(paged=paged, page_size=page_size, num_blocks=num_blocks,
              num_blocks_swa=num_blocks_swa, device=dev)
    caches = {}
    if cfg.prefix_layers:
        caches["prefix"] = tuple(
            layer_cache_init(spec, cfg, batch, cache_len, dtype, **kw)
            for spec in cfg.prefix_layers)
    for stack in cfg.stacks:
        caches["stack"] = tuple(
            layer_cache_init(spec, cfg, batch, cache_len, dtype,
                             lead=(stack.n_periods,), **kw)
            for spec in stack.period)
    return caches


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def embed_inputs(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: {"tokens": (B,S) int} and / or {"embeds": (B,S,ext_dim)}:
    the frontend stub's precomputed embeddings go through ``ext_proj`` in
    bf16, plus the token embeddings when both are given."""
    if "embeds" in batch:
        x = (batch["embeds"].to(torch.bfloat16)
             @ params["ext_proj"].to(torch.bfloat16))
        if "tokens" in batch:
            x = x + _lookup(params["embed"], batch["tokens"])
        return x
    return _lookup(params["embed"], batch["tokens"])


def _lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table (``_lookup_sharded`` for a DTensor
    table: a dry-run on a mesh)."""
    if isinstance(embed, DTensor):
        return _lookup_sharded(embed, tokens)
    return embed[tokens.long()]


def _lookup_sharded(embed, tokens):
    """Vocabulary-parallel lookup (Megatron's): a mesh dim that splits the
    table's rows looks up only the ids it holds, zeros the others and
    leaves the rows a partial sum there; one that splits its columns
    splits the rows' width; any other follows the ids' layout."""
    from torch.distributed.tensor import Partial, Shard
    mesh = embed.device_mesh
    R = Replicate()
    ids_pl = list(tokens.placements) if isinstance(tokens, DTensor) else (
        [R] * mesh.ndim)
    tok, out, vocab = [], [], []
    for i, p in enumerate(embed.placements):
        if isinstance(p, Shard) and p.dim == 0:
            tok.append(R), out.append(Partial()), vocab.append(i)
        elif isinstance(p, Shard):
            tok.append(R), out.append(Shard(tokens.ndim))
        elif (isinstance(ids_pl[i], Shard)
              and tokens.shape[ids_pl[i].dim] % mesh.size(i) == 0):
            tok.append(ids_pl[i]), out.append(ids_pl[i])
        else:
            tok.append(R), out.append(R)
    split = [i for i, p in enumerate(out) if not isinstance(p, Replicate)]
    ids = hints.to_local(tokens.long(), mesh, tok)
    # a negative id counts from the end, as the plain lookup's index
    ids = torch.where(ids < 0, ids + embed.shape[0], ids)
    table = hints.to_local(embed, mesh, list(embed.placements), split)
    n = table.shape[0]
    coord, chunk = mesh.get_coordinate(), 0
    for i in vocab:                      # the rows split major to minor
        chunk = chunk * mesh.size(i) + coord[i]
    local = ids - chunk * n
    mine = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), table) * mine[..., None]
    return hints.from_local(rows, mesh, out,
                            (*tokens.shape, embed.shape[-1]))


def unembed(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Logits in float32 from a matmul in h.dtype (bf16): casting only
    after the product keeps the JAX version's rounding."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (h @ head.to(h.dtype)).float()


def _period(tree, i: int):
    """Period i of a stacked (n_periods, ...) tree: views, no copies."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _period(v, i) for k, v in tree.items()}
    return tuple(_period(v, i) for v in tree)


# the matmuls whose outputs a selective remat policy keeps: "dots" every
# one (JAX's ``checkpoint_dots``), "dots_no_batch" those without a batch
# dimension (``dots_with_no_batch_dims_saveable``): the projections, which
# ``x @ w`` lowers to ``mm`` / ``addmm``, and not the attention scores or
# the MoE expert products, which ``einsum`` / batched ``matmul`` lower to
# ``bmm`` / ``baddbmm``
_aten = torch.ops.aten
_SAVED_MATMULS = {
    "dots": {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default},
    "dots_no_batch": {_aten.mm.default, _aten.addmm.default},
}


def _selective_context(remat_policy: str):
    saved = _SAVED_MATMULS[remat_policy]

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _remat_wrap(body, remat: bool, remat_policy: str):
    """``remat_policy`` "full": recompute each period's activations in the
    backward pass (``jax.checkpoint`` with no policy in the JAX package);
    "dots" / "dots_no_batch": recompute them but keep the outputs of the
    matmuls named in ``_SAVED_MATMULS`` (``torch.utils.checkpoint``'s
    selective checkpointing; a kernel launched through ctypes inside the
    period, as flash attention's, dispatches no matmul and is run again);
    "none" is another way of saying ``remat=False``: keep them all.  That
    is the meaning ``core/workload.py`` gives "none"; the JAX forward
    itself falls through to a full checkpoint for it.  Sharding hints
    active at the forward are active in the recompute too."""
    if remat_policy not in ("full", "none", *_SAVED_MATMULS):
        raise ValueError(f"unknown remat_policy {remat_policy!r}")
    if not remat or remat_policy == "none":
        return body
    ctx, plain = hints.current(), body
    if ctx is not None:
        def body(*args):          # the recompute runs on an autograd thread
            with hints.restored(ctx):
                return plain(*args)
    if remat_policy == "full":
        return lambda *args: checkpoint(body, *args, use_reentrant=False)
    return lambda *args: checkpoint(
        body, *args, use_reentrant=False,
        context_fn=lambda: _selective_context(remat_policy))


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            caches: Optional[dict] = None,
            positions: Optional[torch.Tensor] = None,
            remat: bool = False, kv_chunk: int = 1024,
            compute_logits: bool = True, masked_slots: bool = False,
            remat_policy: str = "full", block_table=None,
            use_kernel: bool = False, decode: bool = False,
            scan_kernel: Optional[bool] = None):
    """Run the decoder.  Returns (logits_or_hidden, aux_loss, caches);
    ``caches`` is updated in place and returned.  ``positions`` defaults
    to arange(S) per row.  ``decode=True`` selects the single-token cache
    paths (MLA's absorbed attention).  ``block_table`` marks ``caches`` as
    paged pools; ``use_kernel=True`` runs each mixer's Hopper kernel where the
    port has one (paged single-token decode attention, self-attention
    with no cache, the Mamba and RWKV recurrences).  ``scan_kernel``
    (None: as ``use_kernel``) decides the recurrences apart: the scan
    kernels have no backward and refuse inputs that require grad, so the
    training path passes False and keeps them plain.  ``remat`` recomputes
    each period's activations in the backward pass (see ``_remat_wrap``)."""
    x = embed_inputs(params, cfg, batch)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
    elif use_kernel and caches is None and cfg.n_heads:
        raise ValueError(
            "repro_torch: with no cache, use_kernel runs the flash kernel, "
            "which masks by index: leave positions at its default arange(S)")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = dict(decode=decode, kv_chunk=kv_chunk, masked_slots=masked_slots,
              block_table=block_table, use_kernel=use_kernel,
              scan_kernel=scan_kernel)
    for i, spec in enumerate(cfg.prefix_layers):
        c = caches["prefix"][i] if caches is not None else None
        x, _, a = layer_apply(params["prefix"][i], spec, cfg, x, positions,
                              c, **kw)
        aux = aux + a
    for stack in cfg.stacks:
        def period_apply(x, t):
            pp = _period(params["stack"], t)
            pc = _period(caches["stack"], t) if caches is not None else None
            a_tot = torch.zeros((), dtype=torch.float32, device=x.device)
            for j, spec in enumerate(stack.period):
                x, _, a = layer_apply(pp[j], spec, cfg, x, positions,
                                      pc[j] if pc is not None else None, **kw)
                a_tot = a_tot + a
            return x, a_tot

        body = _remat_wrap(period_apply, remat, remat_policy)
        for t in range(stack.n_periods):
            x, a = body(x, t)
            aux = aux + a
    h = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    out = unembed(params, cfg, h) if compute_logits else h
    return out, aux, caches


# ---------------------------------------------------------------------------
# Multi-token prediction head (DeepSeek-V3 MTP, depth 1; training only)
# ---------------------------------------------------------------------------

def mtp_hidden(params: dict, cfg: ModelConfig, h: torch.Tensor,
               next_tokens: torch.Tensor, positions: torch.Tensor, *,
               use_kernel: bool = False, scan_kernel: Optional[bool] = None):
    """DeepSeek-style MTP module: predict token t+2 from hidden h_t fused
    with the embedding of token t+1.  h: (B,S,d) final hidden (pre-head);
    next_tokens: (B,S) = token t+1.  Returns (hidden for the shared head,
    aux loss).  ``use_kernel`` / ``scan_kernel`` as in ``forward``."""
    mp = params["mtp"]
    e = _lookup(params["embed"], next_tokens)
    z = torch.cat([rmsnorm(h, mp["norm_h"], cfg.norm_eps),
                   rmsnorm(e, mp["norm_e"], cfg.norm_eps)], dim=-1)
    z = z @ mp["proj"].to(z.dtype)
    z, _, a = layer_apply(mp["layer"], cfg.period[-1], cfg, z, positions,
                          None, use_kernel=use_kernel,
                          scan_kernel=scan_kernel)
    return rmsnorm(z, params["final_norm"], cfg.norm_eps), a


def mtp_logits(params: dict, cfg: ModelConfig, h: torch.Tensor,
               next_tokens: torch.Tensor, positions: torch.Tensor):
    hN, a = mtp_hidden(params, cfg, h, next_tokens, positions)
    return unembed(params, cfg, hN), a


def trainable(params: dict) -> dict:
    """Mark every leaf of a parameter tree as requiring gradients, in
    place, and return the tree.  Gradients of stacked (n_periods, ...)
    leaves flow through ``_period``'s views into the stacked tensors."""
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    return params


class _Node(nn.Module):
    """One dict level of a parameter tree: tensors become frozen
    ``nn.Parameter``s, sub-dicts submodules, tuples ``ModuleList``s."""

    def __init__(self, tree: dict):
        super().__init__()
        self._kinds = {}
        for k, v in tree.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
                self._kinds[k] = "leaf"
            elif isinstance(v, dict):
                self.add_module(k, _Node(v))
                self._kinds[k] = "dict"
            else:
                self.add_module(k, nn.ModuleList(_Node(x) for x in v))
                self._kinds[k] = "tuple"

    def as_dict(self) -> dict:
        out = {}
        for k, kind in self._kinds.items():
            sub = getattr(self, k)
            out[k] = (sub if kind == "leaf" else sub.as_dict()
                      if kind == "dict" else tuple(n.as_dict() for n in sub))
        return out


class Transformer(_Node):
    """Owns a parameter tree, so ``state_dict`` keys are the JAX key
    paths ("stack.0.mixer.wq", ...).  ``params()`` hands the functional
    code the same tensors as a nested dict — no copies.  The parameters
    stay frozen (serving); training works on the plain tree made
    ``trainable``."""

    def __init__(self, cfg: ModelConfig, params: dict):
        check_ported(cfg)
        super().__init__(params)
        self.cfg = cfg

    def params(self) -> dict:
        return self.as_dict()

    def forward(self, batch: dict, **kw):
        return forward(self.params(), self.cfg, batch, **kw)
