"""The port's decoder (``repro_torch.models.transformer``) against the JAX
package's ``forward`` with converted parameters, on the gpt3-24l,
qwen3-8b and jamba-1.5-large-398b (Mamba + attention + MoE) smoke
configs, plus invariants that hold inside the port bit for bit (paged ==
dense, no aliasing between periods).

Logits and cached keys / values come out of bfloat16 matmuls (logits are
cast to float32 only after the product, as in the JAX version), and the
two frameworks round their inputs at different places, so every element
carries bfloat16 rounding at the scale of the largest one: they are
compared with the bfloat16 tolerance 2e-2 relative to that scale.
Cached positions are compared exactly.

Jamba routes each token to its top-2 experts, a discrete choice: in
bfloat16 activations one rounding difference can swap a token's second
expert (on this smoke model a router margin of 3.6e-3 flips in the last
MoE layer) and move its output by a whole expert's contribution, so the
logits differ by 18% of their scale although every layer agrees within
1% on the same input.  Its whole-model comparison therefore runs in
float32 activations (the embedding upcast in both packages, bfloat16
weights upcast exactly in each matmul, float32 caches), where the two
differ by summation order only: within 2e-5 of the scale (1.4e-6
seen).  Per-layer bfloat16 parity of its Mamba and MoE layers is in
``test_torch_ssm.py`` and ``test_torch_moe.py``.
"""
import copy
from dataclasses import asdict, replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import caches_from_jax, params_from_jax  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCHS = ["gpt3-24l", "qwen3-8b", "jamba-1.5-large-398b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_at_scale(t, j, tol=2e-2):
    j = np.asarray(j, np.float32)
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t.float().numpy(), j, atol=tol * scale,
                               rtol=0)


def _caches_close(tc, jc, tol=2e-2):
    for tl, jl in zip(tc["stack"], jc["stack"]):
        assert tl.keys() == jl.keys()
        if "pos" in tl:
            np.testing.assert_array_equal(tl["pos"].numpy(),
                                          np.asarray(jl["pos"]))
        for name in set(tl) - {"pos"}:
            _close_at_scale(tl[name], jl[name], tol)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = jax_smoke(request.param)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, params_from_jax(_np(jp), "cpu")


def test_smoke_and_full_configs_equal_the_jax_ones():
    from repro.configs import get_config as jax_full
    for arch in ARCHS + ["llama3-405b", "qwen1.5-32b", "gemma3-12b"]:
        assert asdict(get_config(arch)) == asdict(jax_full(arch))
        assert asdict(get_smoke_config(arch)) == asdict(jax_smoke(arch))


def test_forward_prefill_then_decode_matches_jax(model):
    """Prefill 11 tokens into a dense cache, then decode one: logits and
    caches against the JAX forward on the same converted parameters (an
    MoE model in float32 activations, see above)."""
    cfg, jp, tp = model
    tol, cache_dtype = 2e-2, jnp.bfloat16
    if cfg.n_experts:
        tol, cache_dtype = 2e-5, jnp.float32
        jp = dict(jp, embed=jp["embed"].astype(jnp.float32))
        tp = dict(tp, embed=tp["embed"].float())
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 11))
    toks = toks.astype(np.int32)
    jc = JT.init_cache(cfg, 2, 16, dtype=cache_dtype)
    tc = caches_from_jax(_np(jc), "cpu")
    jl, _, jc = JT.forward(jp, cfg, {"tokens": jnp.asarray(toks)}, caches=jc)
    tl, _, tc = TT.forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                           caches=tc)
    assert tl.dtype == torch.float32 and tl.shape == (2, 11, cfg.vocab_size)
    _close_at_scale(tl, jl, tol)
    _caches_close(tc, jc, tol)
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    pos = np.full((2, 1), 11, np.int32)
    jl, _, jc = JT.forward(jp, cfg, {"tokens": jnp.asarray(nxt)}, caches=jc,
                           positions=jnp.asarray(pos), decode=True)
    tl, _, tc = TT.forward(tp, cfg, {"tokens": torch.from_numpy(nxt)},
                           caches=tc, positions=torch.from_numpy(pos))
    _close_at_scale(tl, jl, tol)
    _caches_close(tc, jc, tol)


def test_paged_forward_equals_dense_bitwise(model):
    """Same tokens through a dense cache and a shuffled paged pool: the
    chunk partitions agree, so logits are bit for bit equal, and the
    kernel path (its plain version here) agrees on the decode step."""
    cfg, _, tp = model
    toks = torch.from_numpy(
        np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16)))
    pos = torch.arange(16, dtype=torch.int32)[None].repeat(2, 1)
    dense = TT.init_cache(cfg, 2, 32, device="cpu")
    paged = TT.init_cache(cfg, 2, 32, paged=True, page_size=8, num_blocks=9,
                          device="cpu")
    table = torch.tensor([[7, 2, 5, 0], [1, 8, 3, 4]], dtype=torch.int32)
    kw = dict(masked_slots=True, kv_chunk=8)
    dl, _, _ = TT.forward(tp, cfg, {"tokens": toks}, caches=dense,
                          positions=pos, **kw)
    pl, _, _ = TT.forward(tp, cfg, {"tokens": toks}, caches=paged,
                          positions=pos, block_table=table, **kw)
    assert torch.equal(dl, pl)
    before = copy.deepcopy(paged)             # pool state ahead of decode
    tok, dpos = toks[:, :1], torch.full((2, 1), 16, dtype=torch.int32)
    d1 = TT.forward(tp, cfg, {"tokens": tok}, caches=dense, positions=dpos,
                    **kw)[0]
    p1 = TT.forward(tp, cfg, {"tokens": tok}, caches=paged, positions=dpos,
                    block_table=table, **kw)[0]
    k1 = TT.forward(tp, cfg, {"tokens": tok}, caches=before, positions=dpos,
                    block_table=table, use_kernel=True, **kw)[0]
    assert torch.equal(d1, p1)
    assert torch.equal(k1, p1)


def test_init_cache_periods_have_their_own_storage():
    """Three one-layer periods: writing period 0 leaves the others zero."""
    cfg = get_smoke_config("qwen3-8b")
    cfg = replace(cfg, n_layers=3, period=cfg.period[:1])
    for paged in (False, True):
        c = TT.init_cache(cfg, 2, 8, paged=paged, device="cpu")
        k = c["stack"][0]["k"]
        assert k.shape[0] == cfg.stacks[0].n_periods == 3
        k[0].fill_(1.0)
        assert k[1:].abs().max().item() == 0.0


def test_init_params_shapes_and_dtypes_match_jax(model):
    cfg, _, _ = model
    shapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    tp = TT.init_params(0, cfg, device="cpu")
    jl = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tl = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, j), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == j.dtype.name


def test_transformer_module_owns_params_under_jax_keys(model):
    cfg, _, tp = model
    m = TT.Transformer(cfg, tp)
    keys = set(m.state_dict())
    assert "stack.0.mixer.wq" in keys and "embed" in keys
    assert all(not p.requires_grad for p in m.parameters())
    toks = torch.tensor([[1, 2, 3]])
    torch.testing.assert_close(m({"tokens": toks})[0],
                               TT.forward(tp, cfg, {"tokens": toks})[0],
                               atol=0, rtol=0)


def test_paged_sliding_window_cache_needs_its_own_pool():
    """A paged sliding-window layer's ring pool is a block-id space of its
    own: ``init_cache`` refuses to build one without ``num_blocks_swa``
    and sizes it by that count, the global layers by ``num_blocks``."""
    cfg = get_smoke_config("gemma3-12b")
    with pytest.raises(ValueError, match="num_blocks_swa"):
        TT.init_cache(cfg, 2, 32, paged=True, page_size=8, device="cpu")
    c = TT.init_cache(cfg, 2, 32, paged=True, page_size=8, num_blocks=9,
                      num_blocks_swa=5, device="cpu")
    sizes = sorted(layer["k"].shape[1] for layer in c["stack"])
    assert sizes == [5, 9]


@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-1.5-large-398b"])
def test_entry_points_raise_without_gpu_or_explicit_cpu(arch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = get_smoke_config(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.init_cache(cfg, 1, 8)
