"""The port's top-k MoE (``repro_torch.models.layers.moe_apply``) against
the JAX package's ``moe_apply`` on the ``jamba-1.5-large-398b`` smoke
config (4 experts, top-2, and top-8 of 16 experts), with parameters
carried across by ``convert.py``; its top-2 combine against the
``index_add_`` it replaced, bit for bit; and the jamba parameter tree
(stacked expert and Mamba leaves) crossing key for key.

Inputs are drawn with numpy from a seed and handed to both packages.
In float32 activations the two differ by float32 summation order only:
outputs within 2e-5 of their largest element.  In bfloat16 the expert
matmuls round at other places: within 2e-2 of the scale.  The router
runs in float32 in both, so the routing, the capacity drops and the
load-balance loss (within 1e-6 relative) agree; the drop case checks
that assignments were in fact dropped.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = "jamba-1.5-large-398b"
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_at_scale(t, j, tol):
    j = np.asarray(j, np.float32)
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t.float().numpy(), j, atol=tol * scale, rtol=0)


def _moe(cfg, seed=0):
    jp = JL.moe_init(jax.random.PRNGKey(seed), cfg)
    return jp, params_from_jax(_np(jp), "cpu")


def _run_both(cfg, jp, tp, x, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    jo, jaux = JL.moe_apply(jp, jnp.asarray(x, jdt), cfg)
    to, taux = TL.moe_apply(tp, torch.from_numpy(x).to(tdt), cfg)
    assert to.dtype == tdt and to.shape == x.shape
    assert taux.dtype == torch.float32 and taux.shape == ()
    return jo, jaux, to, taux


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_apply_matches_jax(dtype, shared):
    """2 x 8 random tokens; with ``shared`` one shared expert is added
    (the reference's ``n_shared_experts`` branch)."""
    cfg = replace(jax_smoke(ARCH), n_shared_experts=shared)
    jp, tp = _moe(cfg)
    assert ("shared" in tp) == bool(shared)
    x = np.random.RandomState(1).randn(2, 8, cfg.d_model).astype(np.float32)
    jo, jaux, to, taux = _run_both(cfg, jp, tp, x, dtype)
    _close_at_scale(to, jo, DTYPES[dtype][2])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_capacity_drops_match_jax(dtype):
    """An engine prefill call's shape: 7 idle rows of 8 identical padding
    tokens ahead of one live row.  The 56 identical tokens fill both of
    their experts past capacity (C = 40 for 64 tokens), and the live
    row's assignments to those experts come later in the stable sort, so
    they are dropped too.  Outputs and aux must still agree."""
    cfg = jax_smoke(ARCH)
    jp, tp = _moe(cfg, seed=3)
    rng = np.random.RandomState(2)
    x = np.repeat(rng.randn(1, 1, cfg.d_model), 8, axis=1).repeat(8, axis=0)
    x[7] = rng.randn(8, cfg.d_model)
    x = x.astype(np.float32)
    T = x.shape[0] * x.shape[1]
    C = TL.moe_capacity(T, cfg)
    assert C == 40
    tx = torch.from_numpy(x).reshape(T, -1)
    probs = torch.softmax(tx @ tp["router"], dim=-1)
    gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
    _, slot, order, _ = TL._moe_dispatch_group(tx, gates, idx, cfg.n_experts,
                                               cfg.top_k, C)
    src = order // cfg.top_k
    dropped = slot == cfg.n_experts * C
    assert int(dropped[src < 56].sum()) == 2 * (56 - C)   # padding overflow
    assert bool(dropped[src >= 56].any())                 # a live drop
    jo, jaux, to, taux = _run_both(cfg, jp, tp, x, dtype)
    _close_at_scale(to, jo, DTYPES[dtype][2])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_top8_of_16_experts_matches_jax(dtype):
    """K = 8 over 16 experts (qwen3-moe's top-8 routing at smoke width):
    each token sums eight gated expert outputs, the case the combine's
    fixed order exists for.  Outputs and aux must agree with JAX."""
    cfg = replace(jax_smoke(ARCH), n_experts=16, top_k=8)
    jp, tp = _moe(cfg, seed=4)
    x = np.random.RandomState(5).randn(2, 8, cfg.d_model).astype(np.float32)
    jo, jaux, to, taux = _run_both(cfg, jp, tp, x, dtype)
    _close_at_scale(to, jo, DTYPES[dtype][2])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def _index_add_combine(p, x, cfg):
    """``moe_apply`` with the combine it had before the (T, K, d) buffer:
    an f32 ``index_add_`` of each assignment onto its token."""
    B, S, d = x.shape
    T, E, K = B * S, cfg.n_experts, cfg.top_k
    C = TL.moe_capacity(T, cfg)
    xt = x.reshape(T, d)
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    buf, slot, order, gates_sorted = TL._moe_dispatch_group(
        xt, gate_vals, expert_idx, E, K, C)
    g = TL.silu(torch.bmm(buf, p["w_gate"].to(x.dtype)))
    u = torch.bmm(buf, p["w_up"].to(x.dtype))
    h = torch.bmm(g * u, p["w_down"].to(x.dtype))
    h_flat = torch.cat([h.reshape(E * C, d), h.new_zeros((1, d))])
    per_assign = h_flat[slot].float() * gates_sorted[:, None]
    out = torch.zeros((T, d), dtype=torch.float32)
    out.index_add_(0, order // K, per_assign)
    return out.to(x.dtype).reshape(B, S, d)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_top2_combine_equals_the_index_add_bit_for_bit(dtype):
    """At K = 2 the fixed-order sum over the (T, K, d) buffer is the old
    scatter-add's 0 + a + b: the same bits, drops included (the capacity
    case's inputs)."""
    cfg = jax_smoke(ARCH)
    assert cfg.top_k == 2
    _, tp = _moe(cfg, seed=3)
    rng = np.random.RandomState(2)
    x = np.repeat(rng.randn(1, 1, cfg.d_model), 8, axis=1).repeat(8, axis=0)
    x[7] = rng.randn(8, cfg.d_model)
    tx = torch.from_numpy(x.astype(np.float32)).to(DTYPES[dtype][1])
    out, _ = TL.moe_apply(tp, tx, cfg)
    assert torch.equal(out, _index_add_combine(tp, tx, cfg))


def test_jamba_params_cross_key_for_key():
    """``convert.py`` needs no MoE or Mamba case: the JAX tree's stacked
    expert leaves, (n_periods, E, d, f), and Mamba leaves arrive under
    the same keys, shapes, dtypes and bits; the port's own
    ``init_params`` builds the same tree signature."""
    cfg = jax_smoke(ARCH)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    tp = params_from_jax(_np(jp), "cpu")
    own = TT.init_params(0, cfg, device="cpu")

    def flat(tree):
        out = {}

        def walk(t, path):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, path + (k,))
            elif isinstance(t, (tuple, list)):
                for i, v in enumerate(t):
                    walk(v, path + (i,))
            else:
                out[path] = t
        walk(tree, ())
        return out

    jf, tf, of = flat(_np(jp)), flat(tp), flat(own)
    assert jf.keys() == tf.keys() == of.keys()
    for k, j in jf.items():
        assert tuple(tf[k].shape) == j.shape == tuple(of[k].shape), k
        assert str(tf[k].dtype).split(".")[-1] == j.dtype.name, k
        assert tf[k].dtype == of[k].dtype, k
        np.testing.assert_array_equal(tf[k].float().numpy(),
                                      j.astype(np.float32))
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_expert
    moe = tp["stack"][1]["ffn"]
    assert moe["w_gate"].shape == (1, E, d, f) and moe["w_down"].shape == (
        1, E, f, d)
    assert moe["router"].dtype == torch.float32
    assert set(tp["stack"][1]["mixer"]) == {
        "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
        "A_log", "D", "out_proj"}
