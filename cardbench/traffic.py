"""The general traffic generator: every mix is a data file
(``traffic/<mix>.json``) of parameters that this module reads.

``lm_batches``: training batches of ``batch`` x ``seq_len`` tokens (a
frozen copy of the port's ``SyntheticLM`` arithmetic: each token is
``(prev * 1103515245 + 12345) % vocab`` with probability 1 - ``noise``,
else uniform), drawn with numpy from the seed.
"""
from __future__ import annotations

import numpy as np

HASH_MUL, HASH_ADD = 1103515245, 12345


def rng_of(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, stream])


def lm_batches(mix: dict, seed: int, n_batches: int, vocab: int) -> np.ndarray:
    """(n_batches, batch, seq_len + 1) int64 token rows, all distinct
    draws: inputs are ``[..., :-1]``, labels ``[..., 1:]``."""
    B, S, p = mix["batch"], mix["seq_len"], mix["noise"]
    rng = rng_of(seed, 1)
    N = n_batches * B
    toks = np.empty((N, S + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, N)
    noise = rng.random((N, S)) < p
    rnd = rng.integers(0, vocab, (N, S))
    for t in range(1, S + 1):
        nxt = (toks[:, t - 1] * HASH_MUL + HASH_ADD) % vocab
        toks[:, t] = np.where(noise[:, t - 1], rnd[:, t - 1], nxt)
    return toks.reshape(n_batches, B, S + 1)
