"""The port's threefry sampling (``repro_torch.prng`` and the engine's
``topp_sample`` / ``sample`` / ``generate``) against ``jax.random`` and the
JAX package's engine on the same keys.

Keys, counters, bits and uniforms must be JAX's bit for bit.  Gumbel
noise applies two logs, which XLA's CPU code and torch's may round one
ulp apart: each value must lie within 2.4e-7 x max(1, |g|) of JAX's (two
ulps of 1 below |g| = 1, where the error of log(-log u) is absolute, two
ulps of g above).  Tokens are compared exactly.  The engine and
``generate`` run in float32 activations (embedding and caches in
float32), where the two packages' logits differ by summation order only.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax._src import prng as jax_prng  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import init_params as jax_init  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

GUMBEL_TOL = 2.4e-7


def _keys(seed, n):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _same_floats(t, j):
    np.testing.assert_array_equal(t.numpy().view(np.uint32),
                                  np.asarray(j).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_threefry2x32_matches_jax_bitwise(seed):
    rng = np.random.RandomState(seed)
    k = _keys(seed, 1)[0]
    x = rng.randint(0, 2 ** 32, (2, 37), dtype=np.uint64).astype(np.uint32)
    j1, j2 = jax_prng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                          jnp.asarray(x[0]), jnp.asarray(x[1]))
    t1, t2 = prng.threefry2x32(torch.tensor(int(k[0])),
                               torch.tensor(int(k[1])), _t(x[0]), _t(x[1]))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(t2.numpy(), np.asarray(j2))


@pytest.mark.parametrize("seed", [0, 7, 123456789, -1, 2 ** 32 + 5])
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 8])
def test_split_and_fold_in_match_jax(num):
    for k in _keys(num, 3):
        jk, tk = jnp.asarray(k), _t(k)
        np.testing.assert_array_equal(prng.split(tk, num).numpy(),
                                      np.asarray(jax.random.split(jk, num)))
        for data in (0, num, 2 ** 31 + 11):
            np.testing.assert_array_equal(
                prng.fold_in(tk, data).numpy(),
                np.asarray(jax.random.fold_in(jk, data)))
    # a chain as generate() walks it
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    for _ in range(4):
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        np.testing.assert_array_equal(tsub.numpy(), np.asarray(jsub))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (1001,), (151936,)])
def test_bits_and_uniform_match_jax_bitwise(shape):
    k = _keys(len(shape), 1)[0]
    jk, tk = jnp.asarray(k), _t(k)
    np.testing.assert_array_equal(
        prng.random_bits(tk, shape).numpy(),
        np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    _same_floats(prng.uniform(tk, shape), jax.random.uniform(jk, shape))
    tiny = float(np.finfo(np.float32).tiny)
    _same_floats(prng.uniform(tk, shape, minval=tiny),
                 jax.random.uniform(jk, shape, minval=tiny))
    _same_floats(prng.uniform(tk, shape, -2.0, 3.0),
                 jax.random.uniform(jk, shape, minval=-2.0, maxval=3.0))


def test_batched_keys_are_jax_vmap_rows():
    """(8, 151936) draws from 8 keys: each row is JAX's vmapped draw, bits
    and uniforms bit for bit, gumbel within GUMBEL_TOL."""
    keys = _keys(11, 8)
    V = 151936
    jb = jax.vmap(lambda k: jax.random.bits(k, (V,), jnp.uint32))(
        jnp.asarray(keys))
    np.testing.assert_array_equal(prng.random_bits(_t(keys), (V,)).numpy(),
                                  np.asarray(jb))
    ju = jax.vmap(lambda k: jax.random.uniform(k, (V,)))(jnp.asarray(keys))
    _same_floats(prng.uniform(_t(keys), (V,)), ju)
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(
        jnp.asarray(keys)))
    tg = prng.gumbel(_t(keys), (V,)).numpy()
    err = np.abs(tg.astype(np.float64) - jg) / np.maximum(1.0, np.abs(jg))
    assert err.max() <= GUMBEL_TOL, err.max()


@pytest.mark.parametrize("shape", [(5, 1000), (4, 1, 333)])
def test_categorical_matches_jax(shape):
    rng = np.random.RandomState(shape[-1])
    logits = (rng.randn(*shape) * 2).astype(np.float32)
    k = _keys(shape[-1], shape[0])
    got = prng.categorical(_t(k[0]), torch.from_numpy(logits))
    exp = jax.random.categorical(jnp.asarray(k[0]), jnp.asarray(logits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    rows = prng.categorical(_t(k), torch.from_numpy(logits))
    exp = jax.vmap(jax.random.categorical)(jnp.asarray(k),
                                           jnp.asarray(logits))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(exp))


@pytest.mark.parametrize("V", [64, 1001, 151936])
def test_topp_sample_matches_jax_tokens(V):
    """Mixed rows (plain temperature, nucleus, top-k, both, near-greedy)
    over 12 draws of fresh raw keys: JAX's ``topp_sample`` tokens."""
    rng = np.random.RandomState(V)
    B = 6
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    temp = np.asarray([1.0, 0.7, 1.5, 0.8, 1.0, 0.05], np.float32)
    top_p = np.asarray([1.0, 0.9, 1.0, 0.95, 0.3, 1.0], np.float32)
    top_k = np.asarray([0, 0, 16, 50, 5, 0], np.int32)
    jargs = [jnp.asarray(a) for a in (logits, temp, top_p, top_k)]
    targs = [torch.from_numpy(a) for a in (logits, temp, top_p, top_k)]
    jfn = jax.jit(JE.topp_sample)
    seen = set()
    for draw in range(12 if V < 10 ** 5 else 3):
        k = _keys(1000 * draw + V, B)
        exp = np.asarray(jfn(jnp.asarray(k), *jargs))
        got = TE.topp_sample(_t(k), *targs)
        assert got.dtype == torch.int32 and got.shape == (B, 1)
        np.testing.assert_array_equal(got.numpy(), exp)
        seen.update((b, int(exp[b, 0])) for b in range(B))
    assert len(seen) > B                          # it does sample


def _f32(jp, tp):
    """Float32 activations: the embedding upcast in both packages."""
    return (dict(jp, embed=jp["embed"].astype(jnp.float32)),
            dict(tp, embed=tp["embed"].float()))


@pytest.fixture
def f32_caches(monkeypatch):
    monkeypatch.setattr(JE, "init_cache",
                        partial(JE.init_cache, dtype=jnp.float32))
    monkeypatch.setattr(TE, "init_cache",
                        partial(TE.init_cache, dtype=torch.float32))


@pytest.mark.parametrize("arch,temperature,seed", [
    ("gpt3-24l", 1.0, 0), ("qwen3-8b", 0.7, 5), ("gpt3-24l", 0.0, 1)])
def test_generate_matches_jax_generate(f32_caches, arch, temperature, seed):
    cfg = jax_smoke(arch)
    jp = jax_init(jax.random.PRNGKey(seed), cfg)
    jp, tp = _f32(jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    prompts = np.random.RandomState(seed).randint(
        0, cfg.vocab_size, (3, 6)).astype(np.int32)
    exp = np.asarray(JE.generate(jp, cfg, jnp.asarray(prompts), max_new=8,
                                 temperature=temperature, seed=seed))
    got = TE.generate(tp, cfg, prompts, max_new=8, temperature=temperature,
                      seed=seed)
    np.testing.assert_array_equal(got.numpy(), exp)
    if temperature > 0:      # the draw is not the greedy choice throughout
        greedy = TE.generate(tp, cfg, prompts, max_new=8)
        assert not torch.equal(got, greedy)


def _serve(mod, params, cfg, reqs, **kw):
    eng = mod.ServingEngine(params, cfg, **kw)
    for r in reqs:
        eng.submit(mod.Request(**r))
    return {r.req_id: list(r.generated) for r in eng.run()}, eng.stats


def test_engine_sampled_requests_match_jax_engine(f32_caches):
    """gpt3-24l's smoke config, 3 slots over 6 requests (four sampled:
    temperature, nucleus, top-k, a repetition penalty beside them), paged,
    chunk 4: every token of every request equals the JAX engine's.  Where
    a token differs, the JAX engine is run again, and the port's tokens
    must equal that run's while the two JAX runs differ from each other:
    the JAX engine strays under parallel load (ROADMAP, Queue 3), and only
    such a difference is accepted."""
    cfg = jax_smoke("gpt3-24l")
    jp = jax_init(jax.random.PRNGKey(4), cfg)
    jp, tp = _f32(jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    rng = np.random.RandomState(4)
    hot = [dict(temperature=1.0), dict(temperature=0.8, top_p=0.9),
           dict(temperature=1.2, top_k=20),
           dict(temperature=0.9, top_p=0.95, top_k=50, rep_penalty=1.3)]
    reqs = []
    for i in range(6):
        kw = hot[i - 1] if 1 <= i <= 4 else {}
        reqs.append(dict(req_id=i, max_new=7, **kw,
                         prompt=rng.randint(0, cfg.vocab_size,
                                            3 + 5 * i).tolist()))
    kw = dict(slots=3, cache_len=64, chunk=4, paged=True, page_size=8,
              seed=9)
    tdone, tstats = _serve(TE, tp, cfg, reqs, use_kernel=True, device="cpu",
                           **kw)
    jdone, jstats = _serve(JE, jp, cfg, reqs, **kw)
    assert tstats["decode_calls"] == jstats["decode_calls"]
    if tdone != jdone:
        again, _ = _serve(JE, jp, cfg, reqs, **kw)
        assert again != jdone and tdone == again, (tdone, jdone, again)
    greedy, _ = _serve(TE, tp, cfg, [dict(r, temperature=0.0) for r in reqs],
                       use_kernel=True, device="cpu", **kw)
    assert all(tdone[i] != greedy[i] for i in (1, 2, 3))
    assert tdone[0] == greedy[0] and tdone[5] == greedy[5]
