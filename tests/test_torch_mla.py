"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's ``mla_apply`` on one layer of the
``deepseek-v3-671b`` smoke config, with parameters carried across by
``convert.py``: the naive path with no cache, the dense latent cache
(per-row masked write, prefill then absorbed decode), and the paged
latent pool (gathered prefill, then absorbed decode through the scan
path and through the paged-decode kernel — its plain version on the CPU,
the Pallas kernel in interpret mode in JAX).  And the whole deepseek
smoke parameter tree, MTP head included, crossing key for key.

Inputs are drawn with numpy from a seed and handed to both packages.  In
float32 activations (float32 caches, bf16 weights upcast exactly) the
two differ by float32 summation order only: outputs and cached latents
within 2e-5 of their scale.  In bfloat16 they round at other places:
within 2e-2 of the scale.  Cached positions are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import mla as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.convert import caches_from_jax, params_from_jax  # noqa: E402
from repro_torch.models import mla as TM  # noqa: E402

ARCH = "deepseek-v3-671b"
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, S0 = 2, 7


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_at_scale(t, j, tol):
    j = np.asarray(j, np.float32)
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t.float().numpy(), j, atol=tol * scale, rtol=0)


def _caches_close(tc, jc, tol):
    assert set(tc) == set(jc) == {"ckv", "krope", "pos"}
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for name in ("ckv", "krope"):
        _close_at_scale(tc[name], jc[name], tol)


@pytest.fixture(scope="module")
def layer():
    cfg = jax_smoke(ARCH)
    jp = JM.mla_init(jax.random.PRNGKey(3), cfg)
    return cfg, jp, params_from_jax(_np(jp), "cpu")


def _x(cfg, S, seed):
    return np.random.RandomState(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _both(layer, dtype, x, pos, jc=None, tc=None, **kw):
    cfg, jp, tp = layer
    jdt, tdt, _ = DTYPES[dtype]
    jt = kw.pop("table", None)
    jo, jc = JM.mla_apply(jp, jnp.asarray(x, jdt), cfg,
                          positions=jnp.asarray(pos), cache=jc,
                          table=None if jt is None else jnp.asarray(jt), **kw)
    to, tc = TM.mla_apply(tp, torch.from_numpy(x).to(tdt), cfg,
                          positions=torch.from_numpy(pos), cache=tc,
                          table=None if jt is None else torch.from_numpy(jt),
                          **kw)
    assert to.dtype == tdt and tuple(to.shape) == x.shape
    _close_at_scale(to, jo, DTYPES[dtype][2])
    if tc is not None:
        _caches_close(tc, jc, DTYPES[dtype][2])
    return jc, tc


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_naive_path_without_cache(layer, dtype):
    pos = np.broadcast_to(np.arange(S0, dtype=np.int32), (B, S0)).copy()
    _both(layer, dtype, _x(layer[0], S0, 0), pos)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dense_cache_masked_prefill_then_absorbed_decode(layer, dtype):
    """Row 1's prompt is 3 tokens shorter: its last positions are -1 and
    write nothing (the per-row masked write); then two absorbed decode
    steps, the second with row 0 idle."""
    cfg = layer[0]
    jdt = DTYPES[dtype][0]
    jc = JM.mla_cache_init(B, 16, cfg, jdt)
    tc = caches_from_jax(_np(jc), "cpu")
    pos = np.broadcast_to(np.arange(S0, dtype=np.int32), (B, S0)).copy()
    pos[1, 4:] = -1
    jc, tc = _both(layer, dtype, _x(cfg, S0, 1), pos, jc, tc,
                   masked_slots=True)
    for step, dpos in enumerate(([[7], [4]], [[-1], [5]])):
        jc, tc = _both(layer, dtype, _x(cfg, 1, 2 + step),
                       np.asarray(dpos, np.int32), jc, tc, decode=True,
                       masked_slots=True)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_pool_gathered_prefill_then_absorbed_decode(layer, dtype,
                                                          use_kernel):
    """A shuffled pool of 4-position pages: the prompt scatters through
    the table and the naive path reads the gathered view; decode reads
    the pool page by page (the kernel walks it with the latent pool as
    both K and V)."""
    cfg = layer[0]
    jdt = DTYPES[dtype][0]
    jc = JM.mla_paged_cache_init(11, 4, cfg, jdt)
    tc = caches_from_jax(_np(jc), "cpu")
    table = np.array([[7, 2, 5, -1], [1, 9, 3, 4]], np.int32)
    pos = np.broadcast_to(np.arange(S0, dtype=np.int32), (B, S0)).copy()
    pos[0, 5:] = -1
    jc, tc = _both(layer, dtype, _x(cfg, S0, 4), pos, jc, tc, table=table,
                   masked_slots=True)
    for step, dpos in enumerate(([[5], [7]], [[6], [8]])):
        jc, tc = _both(layer, dtype, _x(cfg, 1, 5 + step),
                       np.asarray(dpos, np.int32), jc, tc, table=table,
                       decode=True, masked_slots=True, use_kernel=use_kernel)


def test_params_from_jax_carries_deepseek_smoke_tree_with_mtp():
    cfg = jax_smoke(ARCH)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(_np(jp), "cpu")
    assert "mtp" in tp and set(tp["mtp"]) == {"norm_h", "norm_e", "proj",
                                              "layer"}
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == j.dtype.name
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j, np.float32))
