"""Train-step builder: loss -> grads -> optimizer, with activation
recomputation over layer periods, token-chunked cross entropy, the
optional MTP auxiliary loss (DeepSeek-V3) and microbatch gradient
accumulation — the counterpart of
``repro.train.step``.  PyTorch runs eagerly, so the builders return
plain functions (the JAX version's are meant for ``jax.jit``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch import tracing
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import forward, mtp_hidden
from repro_torch.train.loss import cross_entropy_chunked
from repro_torch.tree import leaves, unflatten


def _head_matrix(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = True, mtp_coef: float = 0.3, ce_chunk: int = 512,
            remat_policy: str = "full", use_kernel: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, {"ce", "aux", "acc"[, "ce_mtp"]}) of one batch {"tokens",
    "labels"} (plus "embeds" for frontend-stub models).  With an MTP head
    (``cfg.mtp_depth`` and ``params["mtp"]``) and tokens in the batch, the
    depth-1 MTP loss — token t+2 from h_t and token t+1 (== labels_t) —
    adds ``mtp_coef`` x its cross entropy and its aux loss.
    ``use_kernel`` runs the attention through the flash kernel; the Mamba
    and RWKV scans stay plain (their kernels have no backward)."""
    h, aux, _ = forward(params, cfg, batch, remat=remat, compute_logits=False,
                        remat_policy=remat_policy, use_kernel=use_kernel,
                        scan_kernel=False)
    head = _head_matrix(params, cfg)
    ce, acc = cross_entropy_chunked(h, head, batch["labels"], chunk=ce_chunk)
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux, "acc": acc}
    if _has_mtp(params, cfg) and "tokens" in batch:
        B, S = batch["labels"].shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S)
        h_mtp, aux_m = mtp_hidden(params, cfg, h, batch["labels"], positions,
                                  use_kernel=use_kernel, scan_kernel=False)
        lbl_mtp = torch.cat([batch["labels"][:, 1:],
                             torch.full_like(batch["labels"][:, :1], -1)],
                            dim=1)
        ce_m, _ = cross_entropy_chunked(h_mtp, head, lbl_mtp, chunk=ce_chunk)
        loss = loss + mtp_coef * ce_m + aux_m
        metrics["ce_mtp"] = ce_m
    return loss, metrics


def _has_mtp(params, cfg: ModelConfig) -> bool:
    return bool(cfg.mtp_depth) and "mtp" in params


def grads_of(params, loss: torch.Tensor):
    """d loss / d params as a tree of params' structure; a param the loss
    does not reach (the token embedding of a batch of frontend
    embeddings only) gets zeros, as ``jax.grad`` gives."""
    flat = list(leaves(params))
    return unflatten(params, iter(torch.autograd.grad(
        loss, flat, allow_unused=True, materialize_grads=True)))


def make_train_step(cfg: ModelConfig, optimizer, *, microbatches: int = 1,
                    remat: bool = True, mtp_coef: float = 0.3,
                    ce_chunk: int = 512, remat_policy: str = "full",
                    use_kernel: bool = False) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``; the optimizer updates params and state in
    place.  ``microbatches > 1`` accumulates the gradients of equal batch
    slices in float32, averaged, as the JAX version's scan does;
    ``remat_policy``: full | dots | dots_no_batch | none (see
    ``transformer._remat_wrap``).
    The params must require gradients (``transformer.trainable``).
    A step runs in ``tracing`` spans: ``train.step`` around
    ``train.forward`` and ``train.backward`` (once per microbatch) and
    ``train.optimizer``."""
    def grad_fn(params, batch):
        with tracing.span("train.forward"):
            loss, metrics = loss_fn(params, cfg, batch, remat=remat,
                                    mtp_coef=mtp_coef, ce_chunk=ce_chunk,
                                    remat_policy=remat_policy,
                                    use_kernel=use_kernel)
        with tracing.span("train.backward"):
            grads = grads_of(params, loss)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params, opt_state, batch):
        with tracing.span("train.step"):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            B = batch["labels"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} is not a multiple of "
                                 f"microbatches {microbatches}")
            n = B // microbatches
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves(params)]
            names = ("ce", "aux", "acc") + (
                ("ce_mtp",) if _has_mtp(params, cfg) else ())
            metrics = {k: torch.zeros((), dtype=torch.float32,
                                      device=batch["labels"].device)
                       for k in names}
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["labels"].device)
            for i in range(microbatches):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, m, g = grad_fn(params, mb)
                for acc, gi in zip(grads, leaves(g)):
                    acc.add_(gi.float() / microbatches)
                for k in metrics:
                    metrics[k] = metrics[k] + m[k].float() / microbatches
                loss = loss + l / microbatches
                del g
            grads = unflatten(params, iter(grads))
        with tracing.span("train.optimizer"):
            params, opt_state, opt_metrics = optimizer.update(
                grads, opt_state, params)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *, ce_chunk: int = 512) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, cfg, batch, remat=False,
                             ce_chunk=ce_chunk)
        return metrics
    return eval_step
