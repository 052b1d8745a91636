"""The port's compression toolbox (``repro_torch.core.compression``, paper
§2.3) against ``repro.core.compression`` on the same numpy inputs.

Tolerances: top-k values and indices exactly, on inputs whose magnitudes
are distinct (``jax.lax.top_k`` and ``torch.topk`` may order ties
differently; with ties the kept magnitudes are compared as sets);
error feedback within 2e-5 in float32 (the same sums, rounded alike);
int8 block coding bit for bit (the division of both sources, see
``test_torch_quantize.py``); byte pricing exactly.  QSGD draws its coin
flips from a ``torch.Generator`` where JAX takes a key, so it is held to
its law: unbiased, codes in range and one bucket apart from the scaled
magnitude, the scale equal to JAX's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import compression as JC  # noqa: E402
from repro_torch.convert import tensor_from_numpy  # noqa: E402
from repro_torch.core import compression as TC  # noqa: E402

CPU = torch.device("cpu")


def _distinct(n, seed):
    """n values of distinct magnitude, random signs and order."""
    rng = np.random.RandomState(seed)
    mags = (np.arange(1, n + 1) * 0.37 + 0.01).astype(np.float32)
    return (rng.permutation(mags) * rng.choice([-1.0, 1.0], n)).astype(np.float32)


@pytest.mark.parametrize("n,ratio,seed", [(10, 0.3, 0), (100, 0.05, 1),
                                          (500, 0.5, 2), (2048, 0.01, 3)])
def test_topk_matches_jax(n, ratio, seed):
    g = _distinct(n, seed).reshape(-1, 2) if n % 2 == 0 else _distinct(n, seed)
    vj, ij = JC.topk_encode(jnp.asarray(g), ratio)
    v, i = TC.topk_encode(torch.from_numpy(g), ratio)
    np.testing.assert_array_equal(v.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(
        TC.topk_decode(v, i, g.shape).numpy(),
        np.asarray(JC.topk_decode(vj, ij, g.shape)))
    assert TC.topk_bytes(n, ratio) == JC.topk_bytes(n, ratio)


def test_topk_ties_keep_the_same_magnitudes():
    g = np.repeat(np.float32([3.0, -2.0, 1.0, 0.5]), 25)
    np.random.RandomState(0).shuffle(g)
    vj, _ = JC.topk_encode(jnp.asarray(g), 0.3)          # 30 of 100: 25 + 5 ties
    v, i = TC.topk_encode(torch.from_numpy(g), 0.3)
    np.testing.assert_array_equal(np.sort(np.abs(v.numpy())),
                                  np.sort(np.abs(np.asarray(vj))))
    np.testing.assert_array_equal(v.numpy(), g[i.numpy()])


def test_error_feedback_matches_jax():
    g = np.random.RandomState(1).standard_normal((100,)).astype(np.float32)
    ef_j, ef_t = JC.ErrorFeedback(ratio=0.1), TC.ErrorFeedback(ratio=0.1)
    rj, rt = ef_j.init(jnp.asarray(g)), ef_t.init(torch.from_numpy(g))
    total = np.zeros(100)
    for _ in range(50):
        sj, rj = ef_j.step(jnp.asarray(g), rj)
        st, rt = ef_t.step(torch.from_numpy(g), rt)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=2e-5)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=2e-5)
        total += st.numpy()
    # the EF property of tests/test_core.py: total sent ~ T*g
    assert np.abs(total / 50 - g).max() < np.abs(g).max()


@pytest.mark.parametrize("levels", [16, 256])
def test_qsgd_by_its_law(levels):
    g = np.random.RandomState(0).standard_normal((2000,)).astype(np.float32)
    gt = torch.from_numpy(g)
    gen = torch.Generator().manual_seed(0)
    _, sj = JC.qsgd_encode(jax.random.PRNGKey(0), jnp.asarray(g), levels)
    decs = []
    for _ in range(64):
        codes, scale = TC.qsgd_encode(gen, gt, levels)
        assert codes.dtype == torch.int32
        assert scale.item() == float(sj)                 # deterministic part
        y = np.abs(g) / scale.item() * (levels - 1)
        mag = codes.abs().numpy()
        assert mag.max() <= levels - 1
        assert np.all((mag == np.floor(y)) | (mag == np.floor(y) + 1))
        assert np.all((codes.numpy() <= 0) | (g > 0))    # the sign is kept
        dec = TC.qsgd_decode(codes, scale, levels)
        np.testing.assert_array_equal(
            dec.numpy(), np.asarray(JC.qsgd_decode(jnp.asarray(codes.numpy()),
                                                   jnp.asarray(scale.numpy()),
                                                   levels)))
        decs.append(dec.numpy())
    step = scale.item() / (levels - 1)
    # unbiasedness: the mean of 64 draws within a few standard errors of g
    assert np.abs(np.stack(decs).mean(0) - g).max() < 4 * step
    assert TC.qsgd_bytes(2000, levels) == JC.qsgd_bytes(2000, levels)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("shape,block", [((1000,), 128), ((7, 300), 256),
                                         ((64, 64), 256)])
def test_int8_block_coding_matches_jax_bit_for_bit(shape, block, dtype):
    g = (np.random.RandomState(2).standard_normal(shape) * 3).astype(dtype)
    qj, sj = JC.int8_block_encode(jnp.asarray(g), block)
    q, s = TC.int8_block_encode(tensor_from_numpy(g, CPU), block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    dec = TC.int8_block_decode(q, s, shape)
    assert dec.dtype == torch.float32 and dec.shape == shape
    np.testing.assert_array_equal(dec.numpy(),
                                  np.asarray(JC.int8_block_decode(qj, sj, shape)))
    # the bound of tests/test_core.py::test_int8_block_roundtrip_bound
    err = np.abs(dec.numpy() - g.astype(np.float32))
    assert err.max() <= float(np.abs(g.astype(np.float32)).max()) / 127 + 1e-6


@pytest.mark.parametrize("n", [1, 255, 256, 10**6, 2_787_958_784])
def test_byte_pricing_matches_jax(n):
    specs = [("none", {}), ("topk", {"ratio": 0.01}), ("qsgd", {"levels": 16}),
             ("int8", {}), ("local_sgd", {"period": 8})]
    for kind, kw in specs:
        assert TC.CompressionSpec(kind, **kw).bytes(n) == \
            JC.CompressionSpec(kind, **kw).bytes(n), kind
        assert TC.CompressionSpec(kind, **kw).bytes(n, 2.0 * n) == \
            JC.CompressionSpec(kind, **kw).bytes(n, 2.0 * n), kind
    assert TC.int8_bytes(n) == JC.int8_bytes(n)
    assert TC.int8_bytes(n, 128) == JC.int8_bytes(n, 128)
    # what int8_block_encode emits for n elements: n codes that carry data
    # plus a float32 scale per block
    assert TC.int8_bytes(n) == n + 4 * -(-n // 256)


def test_pricing_is_monotone_and_local_sgd_gates():
    n = 10**6
    raw = TC.CompressionSpec("none").bytes(n)
    assert TC.CompressionSpec("topk", ratio=0.01).bytes(n) < raw / 10
    assert TC.CompressionSpec("int8").bytes(n) < raw / 3
    assert TC.CompressionSpec("local_sgd", period=8).bytes(n) == raw / 8
    lt, lj = TC.LocalSGD(period=4), JC.LocalSGD(period=4)
    assert [lt.should_sync(s) for s in range(12)] == \
        [lj.should_sync(s) for s in range(12)]
    assert lt.bytes_per_step(1e9) == lj.bytes_per_step(1e9)
    with pytest.raises(ValueError):
        TC.CompressionSpec("gzip").bytes(n)
