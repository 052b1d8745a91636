"""Deterministic synthetic data pipeline — the counterpart of
``repro.data.synthetic``, with the DHT-backed ``DataProvider`` of the
decentralized plane (§3.9).

Token streams come from a seeded Markov-ish process with learnable
structure: each token is mostly a hash of the previous one, with a
configurable noise rate, so a correctly wired model shows a falling loss
within tens of steps.  Batches are drawn with numpy exactly as the JAX
package draws them (batch index -> content), so the two packages train
on the same bits; they arrive as tensors on the loader's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.dht import DHT


def _hash_next(tokens: np.ndarray, vocab: int) -> np.ndarray:
    """Deterministic successor function over the vocab (affine hash)."""
    return (tokens * 1103515245 + 12345) % vocab


@dataclass
class SyntheticConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    noise: float = 0.1          # fraction of uniformly random tokens
    ext_embed_dim: int = 0      # >0: emit frontend-stub embeddings too
    seed: int = 0


class SyntheticLM:
    """next-token = hash(token) with probability (1-noise); the optimal
    cross-entropy is about noise·log(V) + H(noise), so loss curves have a
    known floor.  Batches land on ``device`` (cuda unless "cpu" is asked
    for)."""

    def __init__(self, cfg: SyntheticConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def optimal_loss(self) -> float:
        p = self.cfg.noise
        v = self.cfg.vocab_size
        return -(1 - p) * math.log(1 - p + 1e-12) - p * math.log(
            max(p, 1e-12) / v)

    def batch(self, step: int, *, batch_slice: Optional[slice] = None
              ) -> Dict[str, torch.Tensor]:
        """{"tokens", "labels"} int32 (B, S) on the device (and "embeds"
        float32 (B, S, ext_embed_dim) when the config asks for them),
        drawn as the JAX package draws batch ``step``."""
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + step) % 2**31)
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.randint(0, V, size=B)
        for t in range(1, S + 1):
            nxt = _hash_next(toks[:, t - 1], V)
            noise_mask = rng.random_sample(B) < cfg.noise
            nxt = np.where(noise_mask, rng.randint(0, V, size=B), nxt)
            toks[:, t] = nxt
        if batch_slice is not None:
            toks = toks[batch_slice]
        out = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
               "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}
        if cfg.ext_embed_dim:
            out["embeds"] = torch.from_numpy(rng.standard_normal(
                (toks.shape[0], S, cfg.ext_embed_dim)).astype(np.float32))
        return {k: v.to(self.device) for k, v in out.items()}

    def iterate(self, n_steps: int, start: int = 0) -> Iterator[dict]:
        for step in range(start, start + n_steps):
            yield self.batch(step)


def loader_for(cfg_model, shape, *, noise: float = 0.1, seed: int = 0,
               batch_override: Optional[int] = None,
               device: DeviceLike = None) -> SyntheticLM:
    """Build a loader matched to a ModelConfig + InputShape."""
    return SyntheticLM(SyntheticConfig(
        vocab_size=cfg_model.vocab_size,
        seq_len=shape.seq_len,
        global_batch=batch_override or shape.global_batch,
        noise=noise,
        ext_embed_dim=cfg_model.ext_embed_dim,
        seed=seed), device=device)


# ---------------------------------------------------------------------------
# DHT-backed data provider (paper §3.9): supernodes host dataset shards;
# compnodes holding Input/Label placeholders fetch from the DHT.
# ---------------------------------------------------------------------------

class DataProvider:
    """Batches published into the DHT as numpy arrays (what a peer would
    store and ship); ``fetch`` returns tensors on the loader's device."""

    def __init__(self, lm: SyntheticLM, dht: DHT, *, shard_batches: int = 8):
        self.lm = lm
        self.dht = dht
        self.shard_batches = shard_batches

    def publish(self, start_step: int, n_steps: int) -> int:
        """Precompute batches into the DHT; returns #keys written."""
        n = 0
        for step in range(start_step, start_step + n_steps):
            batch = self.lm.batch(step)
            self.dht.put(f"data/{self.lm.cfg.seed}/{step}",
                         {k: v.cpu().numpy() for k, v in batch.items()})
            n += 1
        return n

    def fetch(self, step: int) -> dict:
        got = self.dht.get(f"data/{self.lm.cfg.seed}/{step}")
        if got is None:      # cache miss: regenerate deterministically
            return self.lm.batch(step)
        return {k: torch.from_numpy(v).to(self.lm.device)
                for k, v in got.items()}
