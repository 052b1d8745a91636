"""The configs the port admits with its MLA and sliding-window slices,
against the JAX package: qwen3-moe-235b-a22b (attention + top-8 MoE),
bert-large (dense MHA, used causally), llava-next-mistral-7b and
musicgen-medium (the frontend stub's precomputed embeddings through
``ext_proj``), deepseek-v3-671b (MLA + MoE + MTP) and gemma3-12b (five
sliding-window layers to one global one).

Full and smoke configs equal the JAX ones field by field.  One smoke
forward's logits equal JAX's on converted parameters, with "embeds" fed
(beside the tokens) for the frontend-stub models: bfloat16 within 2e-2
of the logits' scale; the MoE model in float32 activations (the
embedding upcast), within 2e-5, since MoE routing turns bfloat16
rounding into another expert now and then.  The dense models' greedy
engine tokens (tokens only, as the JAX engine serves them) equal JAX
``generate()``'s.
"""
from dataclasses import asdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_full  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.configs import (ALL_ARCHS, get_config,  # noqa: E402
                                 get_smoke_config)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

NEW = ["qwen3-moe-235b-a22b", "bert-large", "llava-next-mistral-7b",
       "musicgen-medium", "deepseek-v3-671b", "gemma3-12b"]
DENSE = ["bert-large", "llava-next-mistral-7b", "musicgen-medium",
         "gemma3-12b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", NEW)
def test_configs_equal_the_jax_ones(arch):
    assert arch in ALL_ARCHS
    assert asdict(get_config(arch)) == asdict(jax_full(arch))
    assert asdict(get_smoke_config(arch)) == asdict(jax_smoke(arch))


@pytest.mark.parametrize("arch", NEW[:4] + NEW[5:])
def test_smoke_forward_logits_match_jax(arch):
    cfg = jax_smoke(arch)
    jp = JT.init_params(jax.random.PRNGKey(1), cfg)
    tp = params_from_jax(_np(jp), "cpu")
    tol = 2e-2
    if cfg.n_experts:
        tol = 2e-5
        jp = dict(jp, embed=jp["embed"].astype(jnp.float32))
        tp = dict(tp, embed=tp["embed"].float())
    rng = np.random.RandomState(2)
    batch = {"tokens": rng.randint(0, cfg.vocab_size,
                                   (2, 9)).astype(np.int32)}
    if cfg.ext_embed_dim:
        assert set(tp) >= {"ext_proj"}
        batch["embeds"] = rng.standard_normal(
            (2, 9, cfg.ext_embed_dim)).astype(np.float32)
    jl, _, _ = JT.forward(jp, cfg,
                          {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _, _ = TT.forward(tp, cfg, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    assert tl.dtype == torch.float32 and tl.shape == (2, 9, cfg.vocab_size)
    jl = np.asarray(jl, np.float32)
    scale = max(1.0, float(np.abs(jl).max()))
    np.testing.assert_allclose(tl.numpy(), jl, atol=tol * scale, rtol=0)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_engine_tokens_match_jax_generate(arch):
    """Two slots over three requests (slot recycling), chunked prefill
    across chunk boundaries, the paged pool: greedy tokens equal
    ``generate()``'s on each prompt alone."""
    cfg = jax_smoke(arch)
    jp = JT.init_params(jax.random.PRNGKey(3), cfg)
    tp = params_from_jax(_np(jp), "cpu")
    prompts = [[(5 * i + 3 * j) % cfg.vocab_size for j in range(n)]
               for i, n in enumerate((6, 11, 3))]
    eng = TE.ServingEngine(tp, cfg, slots=2, cache_len=32, chunk=4,
                           paged=True, page_size=8, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(TE.Request(i, p, max_new=4))
    done = {r.req_id: r.generated for r in eng.run()}
    for i, p in enumerate(prompts):
        ref = np.asarray(JE.generate(jp, cfg, jnp.asarray([p], jnp.int32),
                                     max_new=4))[0, len(p):].tolist()
        assert done[i] == ref, (arch, i)
