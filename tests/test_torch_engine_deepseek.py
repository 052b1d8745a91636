"""The port's ``ServingEngine`` on the ``deepseek-v3-671b`` smoke config
(MLA latent cache, MoE with a shared expert) against JAX ``generate()``,
and against itself across cache layouts.

The scenarios of the JAX package's ``test_serving_engine.py::
test_mla_latent_cache_parity`` (dense latent cache, per-row masked
write, absorbed decode), ``test_paged_engine.py::
test_paged_mla_latent_pool_parity`` (paged latent pool: gathered prefill,
page-wise absorbed decode) and ``test_paged_kernel.py::
test_kernel_engine_matches_scan_engine_and_generate[deepseek-v3-671b]``
(the paged-decode kernel's path, its plain version on the CPU): MoE
capacity depends on the call's tokens, so admission takes the whole
prompt in one call on one slot, as ``generate()``'s prefill does.  As
for jamba (``test_torch_engine_jamba.py``), MoE routing turns bfloat16
rounding into another expert now and then, so the model runs in float32
activations (the embedding upcast, every cache built in float32), where
the two packages differ by summation order only and greedy tokens must
be equal.

Then a run of three slots over seven requests, the paged latent pool
shared by the slots and slots recycled while others hold pages: the
paged kernel path, the paged scan path and the dense engine must give
the same tokens.  The latent pools are block-indexed: a slot reset that
took them for per-slot state (``POOL_LEAVES`` without "ckv" / "krope")
would zero another slot's page, and the run shows it.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import init_params as jax_init  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention_fwd)
from repro_torch.serve import engine as TE  # noqa: E402

ARCH = "deepseek-v3-671b"
MAX_NEW = 4
PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9], [9, 8, 7, 6, 5, 4, 3, 2, 1]]


@pytest.fixture(scope="module")
def model():
    """Float32 activations: the embedding upcast in both packages (the
    caches follow in ``f32_caches``)."""
    cfg = jax_smoke(ARCH)
    jp = jax_init(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return (cfg, dict(jp, embed=jp["embed"].astype(jnp.float32)),
            dict(tp, embed=tp["embed"].float()))


@pytest.fixture
def f32_caches(monkeypatch):
    monkeypatch.setattr(JE, "init_cache",
                        partial(JE.init_cache, dtype=jnp.float32))
    monkeypatch.setattr(TE, "init_cache",
                        partial(TE.init_cache, dtype=torch.float32))


def _serve(tp, cfg, prompts, max_new=MAX_NEW, **kw):
    eng = TE.ServingEngine(tp, cfg, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(TE.Request(i, list(p), max_new=max_new))
    done = {r.req_id: list(r.generated) for r in eng.run()}
    return done, eng


@pytest.mark.parametrize("prompt", PROMPTS,
                         ids=[str(len(p)) for p in PROMPTS])
def test_engines_match_jax_generate(model, f32_caches, prompt):
    """One slot, the whole prompt in one call: the dense latent cache, the
    paged pool (4-position pages) through the scan path and through the
    kernel path all emit ``generate()``'s greedy tokens."""
    cfg, jp, tp = model
    ref = np.asarray(JE.generate(jp, cfg, jnp.asarray([prompt], jnp.int32),
                                 max_new=MAX_NEW))[0, len(prompt):].tolist()
    kw = dict(slots=1, cache_len=64)
    dense = _serve(tp, cfg, [prompt], chunk=len(prompt), **kw)[0]
    scan = _serve(tp, cfg, [prompt], chunk=len(prompt), paged=True,
                  page_size=4, **kw)[0]
    paged_attention_fwd.launches = 0
    kern, eng = _serve(tp, cfg, [prompt], chunk=16, paged=True, page_size=4,
                       use_kernel=True, **kw)
    assert dense[0] == scan[0] == kern[0] == ref
    assert eng.stats["prefill_calls"] == 1
    assert paged_attention_fwd.launches == 0      # CPU: the plain version


def _recycling_run(tp, cfg, **kw):
    prompts = [[(7 * i + 3 * j) % cfg.vocab_size for j in range(n)]
               for i, n in enumerate((6, 3, 11, 5, 8, 2, 9))]
    return _serve(tp, cfg, prompts, max_new=5, slots=3, cache_len=32,
                  chunk=4, page_size=4, **kw)


def test_multi_slot_paged_latent_pool_recycles_slots(model, f32_caches,
                                                     monkeypatch):
    cfg, _, tp = model
    dense, _ = _recycling_run(tp, cfg)
    scan, eng = _recycling_run(tp, cfg, paged=True)
    kern, _ = _recycling_run(tp, cfg, paged=True, use_kernel=True)
    assert eng.stats["admitted"] == 7 and eng.stats["shared_pages"] == 0
    assert all(len(g) == 5 for g in dense.values())
    assert kern == scan == dense
    # the run depends on the latent pools being block-indexed
    monkeypatch.setattr(TE, "POOL_LEAVES", ("k", "v", "pos"))
    assert _recycling_run(tp, cfg, paged=True)[0] != dense


def test_latent_pool_leaves_are_blocks_and_warmup_writes_nothing(model):
    """A paged deepseek engine holds only pool leaves ("ckv", "krope",
    "pos"); ``warmup`` runs both engine shapes with every position -1 and
    leaves every pool bit for bit as it was (random here)."""
    cfg, _, tp = model
    eng = TE.ServingEngine(tp, cfg, slots=2, cache_len=16, chunk=4,
                           paged=True, page_size=4, use_kernel=True,
                           device="cpu")
    layers = list(eng.caches["prefix"]) + list(eng.caches["stack"])
    assert all(set(layer) == {"ckv", "krope", "pos"} for layer in layers)
    assert set(TE.POOL_LEAVES) >= {"ckv", "krope", "pos"}
    g = torch.Generator().manual_seed(0)
    for layer in layers:
        for name in ("ckv", "krope"):
            layer[name].copy_(torch.randn(layer[name].shape, generator=g))
    before = [{k: v.clone() for k, v in layer.items()} for layer in layers]
    eng.warmup()
    for layer, old in zip(layers, before):
        for k, v in layer.items():
            assert torch.equal(v, old[k]), k
