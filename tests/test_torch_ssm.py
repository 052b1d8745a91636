"""The port's recurrent mixers (``repro_torch.models.ssm``) and their
place in the decoder, against the JAX package with parameters carried
across by ``convert.py``: RWKV6 on the ``rwkv6-7b`` smoke config, Mamba
on the ``jamba-1.5-large-398b`` smoke config.

Both packages round activations to bfloat16 after every op, but their
matmuls sum in different orders, so outputs that leave a bfloat16
matmul may differ by one bfloat16 step: they are compared within 2e-2
of the largest element.  The recurrent state is float32, built from
those bfloat16 projections: within 1e-4 of its largest element.  The
token-shift carry is a copy of the input and must match exactly.
Across two layers the one-step differences grow (the decay
``exp(-exp(.))`` amplifies them), so whole-model logits are compared by
their relative L2 error, within 5e-2 (2.1e-2 was the largest seen over
three seeds).

Mamba runs in float32 and in bfloat16 activations.  In float32 the two
packages differ by summation order only: outputs, the state ``h`` and
the conv history within 2e-5 of their scale.  In bfloat16 JAX rounds
inside its elementwise functions (softplus, SiLU are several bfloat16
ops there, one rounding in PyTorch), so ``dt`` and the gates differ by
a bfloat16 step here and there: outputs and ``h`` within 2e-2 of their
scale (1.4e-2 and 1.1e-2 seen).  The conv history is a copy of a
bfloat16 matmul's output: within 2e-2 too.
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
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import caches_from_jax, params_from_jax  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = "rwkv6-7b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_at_scale(t, j, tol):
    j = np.asarray(j, np.float32)
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t.float().numpy(), j, atol=tol * scale, rtol=0)


@pytest.fixture(scope="module")
def model():
    cfg = jax_smoke(ARCH)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, params_from_jax(_np(jp), "cpu")


def _layer0_mixer(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["stack"][0]["mixer"]),
            TT._period(tp["stack"], 0)[0]["mixer"])


def test_configs_equal_the_jax_ones_and_params_carry_key_for_key(model):
    """Full and smoke configs are the JAX ones; the port's own
    ``init_params`` has the JAX tree's keys, shapes and dtypes (f32
    ``mu`` / ``w0`` / ``u`` / ``ln_x``, bf16 matrices), so ``convert.py``
    needs no RWKV case."""
    cfg, jp, tp = model
    assert asdict(get_config(ARCH)) == asdict(jax_full(ARCH))
    assert asdict(get_smoke_config(ARCH)) == asdict(cfg)
    own = TT.init_params(0, cfg, device="cpu")

    def sig(tree):
        flat = {}

        def walk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, path + (k,))
            elif isinstance(t, (tuple, list)):
                for i, v in enumerate(t):
                    walk(v, path + (i,))
            else:
                flat[path] = (tuple(t.shape), str(t.dtype).split(".")[-1])
        walk(tree, ())
        return flat
    assert sig(own) == sig(tp)
    mixer = sig(tp["stack"][0]["mixer"])
    assert {k[0]: v[1] for k, v in mixer.items()} == {
        "mu": "float32", "w0": "float32", "u": "float32", "ln_x": "float32",
        "wr": "bfloat16", "wk": "bfloat16", "wv": "bfloat16",
        "wg": "bfloat16", "wo": "bfloat16", "wA": "bfloat16",
        "wB": "bfloat16"}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
def test_rwkv_apply_matches_jax(model, mode, use_kernel):
    """No cache (S = 11); a prefill of 11 tokens onto a nonzero cached
    state; one decode step (S = 1) from that state."""
    cfg, jp, tp = model
    jl, tl = _layer0_mixer(jp, tp)
    rng = np.random.RandomState(1)
    S = 1 if mode == "decode" else 11
    x = jnp.asarray(rng.randn(2, S, cfg.d_model), jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    jc = tc = None
    if mode != "no_cache":
        jc = JS.rwkv_cache_init(2, cfg)
        jc = {"state": jnp.asarray(rng.randn(*jc["state"].shape) * 0.5,
                                   jnp.float32),
              "shift": jnp.asarray(rng.randn(*jc["shift"].shape),
                                   jnp.bfloat16)}
        tc = caches_from_jax(_np(jc), "cpu")
    jo, jnc = JS.rwkv_apply(jl, x, cfg, cache=jc)
    to, tnc = TS.rwkv_apply(tl, tx, cfg, cache=tc, use_kernel=use_kernel)
    assert to.dtype == torch.bfloat16 and to.shape == (2, S, cfg.d_model)
    _close_at_scale(to, jo, 2e-2)
    if mode != "no_cache":
        assert tnc is tc                                 # written in place
        _close_at_scale(tnc["state"], jnc["state"], 1e-4)
        np.testing.assert_array_equal(tnc["shift"].float().numpy(),
                                      np.asarray(jnc["shift"], np.float32))


def test_rwkv_cache_init_shapes():
    cfg = get_config(ARCH)
    c = TS.rwkv_cache_init(8, cfg, lead=(32,), device="cpu")
    assert c["state"].shape == (32, 8, 64, 64, 64)
    assert c["state"].dtype == torch.float32
    assert c["shift"].shape == (32, 8, 4096)
    assert c["shift"].dtype == torch.bfloat16
    caches = TT.init_cache(jax_smoke(ARCH), 3, 16, paged=True, page_size=8,
                           device="cpu")
    for layer in caches["stack"]:                        # per slot, unpaged
        assert set(layer) == {"state", "shift"}
        assert layer["state"].shape == (1, 3, 4, 64, 64)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_masked_slot_restore_is_bitwise(model, use_kernel):
    """``layer_apply(masked_slots=True)``: a row whose positions are all -1
    keeps its state and shift bit for bit; the live row ends as it does
    when run alone."""
    cfg, _, tp = model
    lp = TT._period(tp["stack"], 0)[0]
    spec = cfg.period[0]
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 5, cfg.d_model).astype(np.float32)
                         ).to(torch.bfloat16)
    cache = TS.rwkv_cache_init(2, cfg, device="cpu")
    cache["state"].copy_(torch.from_numpy(
        rng.randn(*cache["state"].shape).astype(np.float32)))
    cache["shift"].copy_(torch.from_numpy(
        rng.randn(*cache["shift"].shape).astype(np.float32)))
    before = {k: v.clone() for k, v in cache.items()}
    pos = torch.tensor([[7, 8, 9, 10, 11], [-1] * 5], dtype=torch.int32)
    TT.layer_apply(lp, spec, cfg, x, pos, cache, masked_slots=True,
                   use_kernel=use_kernel)
    assert torch.equal(cache["state"][1], before["state"][1])
    assert torch.equal(cache["shift"][1], before["shift"][1])
    assert not torch.equal(cache["state"][0], before["state"][0])
    alone = {k: v[:1].clone() for k, v in before.items()}
    TT.layer_apply(lp, spec, cfg, x[:1], pos[:1], alone, masked_slots=True,
                   use_kernel=use_kernel)
    assert torch.equal(cache["state"][:1], alone["state"])
    assert torch.equal(cache["shift"][:1], alone["shift"])


def test_chunked_scan_runs_exactly_length_steps():
    """The JAX scan's padded tail steps leave the carry untouched; the
    port runs exactly ``length`` steps (mirrors
    ``test_serving_engine.py::test_chunked_scan_padded_tail_is_state_noop``)."""
    step = lambda h, x: (h + 1.0, h)
    for L in (5, 128, 150, 257):
        h, ys = TS._chunked_scan(step, torch.zeros(()), (torch.zeros(L),), L)
        assert float(h) == L and ys.shape[0] == L


JAMBA = "jamba-1.5-large-398b"
MAMBA_DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
                "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(scope="module")
def jamba():
    cfg = jax_smoke(JAMBA)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(_np(jp), "cpu")
    # period layer 1 is the first Mamba layer
    return (cfg, jax.tree.map(lambda a: a[0], jp["stack"][1]["mixer"]),
            TT._period(tp["stack"], 0)[1])


@pytest.mark.parametrize("dtype", list(MAMBA_DTYPES))
@pytest.mark.parametrize("history", [False, True])
def test_causal_conv_matches_jax(jamba, history, dtype):
    cfg, jl, tl = jamba
    jdt, tdt, tol = MAMBA_DTYPES[dtype]
    rng = np.random.RandomState(3)
    di, K = cfg.mamba_d_inner, cfg.mamba_d_conv
    x = rng.randn(2, 5, di).astype(np.float32)
    prev = rng.randn(2, K - 1, di).astype(np.float32) if history else None
    jy, jh = JS._causal_conv(jnp.asarray(x, jdt), jl["conv_w"], jl["conv_b"],
                             None if prev is None else jnp.asarray(prev, jdt))
    ty, th = TS._causal_conv(torch.from_numpy(x).to(tdt),
                             tl["mixer"]["conv_w"], tl["mixer"]["conv_b"],
                             None if prev is None
                             else torch.from_numpy(prev).to(tdt))
    assert ty.dtype == tdt and th.shape == (2, K - 1, di)
    _close_at_scale(ty, jy, tol)
    np.testing.assert_array_equal(th.float().numpy(),
                                  np.asarray(jh, np.float32))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("dtype", list(MAMBA_DTYPES))
def test_mamba_apply_matches_jax(jamba, dtype, use_kernel):
    """No cache (S = 11); then from a zero cache a prefill of 11 tokens
    and one decode step (S = 1), the cache's ``h`` and ``conv`` compared
    after each."""
    cfg, jl, tl = jamba
    jdt, tdt, tol = MAMBA_DTYPES[dtype]
    rng = np.random.RandomState(1)
    x = rng.randn(2, 11, cfg.d_model).astype(np.float32)
    jo, _ = JS.mamba_apply(jl, jnp.asarray(x, jdt), cfg)
    to, none = TS.mamba_apply(tl["mixer"], torch.from_numpy(x).to(tdt), cfg,
                              use_kernel=use_kernel)
    assert none is None and to.dtype == tdt and to.shape == x.shape
    _close_at_scale(to, jo, tol)
    jc = JS.mamba_cache_init(2, cfg, dtype=jdt)
    tc = caches_from_jax(_np(jc), "cpu")
    for S in (11, 1):
        x = rng.randn(2, S, cfg.d_model).astype(np.float32)
        jo, jc = JS.mamba_apply(jl, jnp.asarray(x, jdt), cfg, cache=jc)
        to, tnc = TS.mamba_apply(tl["mixer"], torch.from_numpy(x).to(tdt),
                                 cfg, cache=tc, use_kernel=use_kernel)
        assert tnc is tc                                 # written in place
        _close_at_scale(to, jo, tol)
        _close_at_scale(tc["h"], jc["h"], tol)
        _close_at_scale(tc["conv"], jc["conv"], tol)


def test_mamba_kernel_path_equals_the_plain_scan(jamba):
    """``use_kernel=True`` on CPU tensors runs ``ops.mamba_scan``'s plain
    version, the plain path's scan, writing the state through
    ``state_out``: output and cache bit for bit equal to the plain path,
    prefill and decode."""
    cfg, _, tl = jamba
    rng = np.random.RandomState(5)
    caches = [TS.mamba_cache_init(2, cfg, device="cpu") for _ in range(2)]
    for c in caches:
        c["h"].copy_(torch.from_numpy(rng.randn(*c["h"].shape)
                                      .astype(np.float32)))
    caches[1]["h"].copy_(caches[0]["h"])
    for S in (7, 1):
        x = torch.from_numpy(rng.randn(2, S, cfg.d_model).astype(np.float32)
                             ).to(torch.bfloat16)
        outs = [TS.mamba_apply(tl["mixer"], x, cfg, cache=c,
                               use_kernel=k)[0]
                for c, k in zip(caches, (False, True))]
        assert torch.equal(*outs)
        for name in ("h", "conv"):
            assert torch.equal(caches[0][name], caches[1][name])


def test_mamba_cache_init_shapes():
    cfg = get_config(JAMBA)
    c = TS.mamba_cache_init(8, cfg, lead=(9,), device="cpu")
    assert c["h"].shape == (9, 8, 16384, 16) and c["h"].dtype == torch.float32
    assert c["conv"].shape == (9, 8, 3, 16384)
    assert c["conv"].dtype == torch.bfloat16
    caches = TT.init_cache(jax_smoke(JAMBA), 3, 16, paged=True, page_size=8,
                           device="cpu")
    attn, *mamba = caches["stack"]
    assert set(attn) == {"k", "v", "pos"} and attn["pos"].shape == (1, 6, 8)
    for layer in mamba:                                  # per slot, unpaged
        assert set(layer) == {"h", "conv"}
        assert layer["h"].shape == (1, 3, 512, 8)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_masked_slot_restore_is_bitwise(jamba, use_kernel):
    """``layer_apply(masked_slots=True)`` on a Mamba + MoE layer: a row
    whose positions are all -1 keeps ``h`` and ``conv`` bit for bit; the
    live row's cache ends as it does when run alone (the MoE FFN after
    the mixer does not touch the cache)."""
    cfg, _, lp = jamba
    spec = cfg.period[1]
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 5, cfg.d_model).astype(np.float32)
                         ).to(torch.bfloat16)
    cache = TS.mamba_cache_init(2, cfg, device="cpu")
    for leaf in cache.values():
        leaf.copy_(torch.from_numpy(rng.randn(*leaf.shape)
                                    .astype(np.float32)))
    before = {k: v.clone() for k, v in cache.items()}
    pos = torch.tensor([[7, 8, 9, 10, 11], [-1] * 5], dtype=torch.int32)
    TT.layer_apply(lp, spec, cfg, x, pos, cache, masked_slots=True,
                   use_kernel=use_kernel)
    for k in ("h", "conv"):
        assert torch.equal(cache[k][1], before[k][1])
        assert not torch.equal(cache[k][0], before[k][0])
    alone = {k: v[:1].clone() for k, v in before.items()}
    TT.layer_apply(lp, spec, cfg, x[:1], pos[:1], alone, masked_slots=True,
                   use_kernel=use_kernel)
    for k in ("h", "conv"):
        assert torch.equal(cache[k][:1], alone[k])


def test_forward_prefill_then_decode_matches_jax(model):
    """The whole smoke model: prefill 11 tokens into a cache, then decode
    one, through the plain path and the kernel path; logits against the
    JAX forward, the two port paths against each other (float32 sums in
    another order: 1e-3 of the logit scale)."""
    cfg, jp, tp = model
    toks = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 11))
    toks = toks.astype(np.int32)
    nxt = np.asarray([[3], [5]], np.int32)
    jc = JT.init_cache(cfg, 2, 16)
    jl, _, jc = JT.forward(jp, cfg, {"tokens": jnp.asarray(toks)}, caches=jc)
    jd, _, _ = JT.forward(jp, cfg, {"tokens": jnp.asarray(nxt)}, caches=jc,
                          positions=jnp.full((2, 1), 11, jnp.int32))
    outs = []
    for use_kernel in (False, True):
        tc = TT.init_cache(cfg, 2, 16, device="cpu")
        tl, _, tc = TT.forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                               caches=tc, use_kernel=use_kernel)
        td, _, _ = TT.forward(tp, cfg, {"tokens": torch.from_numpy(nxt)},
                              caches=tc, use_kernel=use_kernel,
                              positions=torch.full((2, 1), 11,
                                                   dtype=torch.int32))
        for t, j in ((tl, jl), (td, jd)):
            j = np.asarray(j)
            rel = np.linalg.norm(t.numpy() - j) / np.linalg.norm(j)
            assert t.shape == j.shape and rel < 5e-2, rel
        outs.append((tl, td))
    for a, b in zip(*outs):
        _close_at_scale(a, b.numpy(), 1e-3)
