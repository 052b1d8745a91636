"""The general traffic generator: deterministic per seed, distinct rows,
and seeds past 32 bits."""
import numpy as np
import pytest

from cardbench import manifest, traffic

SEEDS = [0, 7, 2**31 + 11, 2**40 + 3]


def _mix(name):
    return manifest.read_json("traffic", name)


@pytest.mark.parametrize("seed", SEEDS)
def test_lm_batches(seed):
    mix = dict(_mix("lm-2x4096"), seq_len=64)
    a = traffic.lm_batches(mix, seed, 5, 151936)
    assert a.shape == (5, 2, 65)
    assert np.array_equal(a, traffic.lm_batches(mix, seed, 5, 151936))
    nxt = (a[..., :-1] * traffic.HASH_MUL + traffic.HASH_ADD) % 151936
    hit = (a[..., 1:] == nxt).mean()
    assert 0.9 < hit < 0.99                 # noise 0.05
    rows = a.reshape(10, 65)
    assert len({r.tobytes() for r in rows}) == 10
    assert a.min() >= 0 and a.max() < 151936


def test_lm_batches_differ_by_seed():
    mix = dict(_mix("lm-2x4096"), seq_len=64)
    a = traffic.lm_batches(mix, SEEDS[2], 3, 151936)
    b = traffic.lm_batches(mix, SEEDS[2] + 1, 3, 151936)
    assert not np.array_equal(a, b)
