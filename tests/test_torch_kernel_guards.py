"""The forward-only kernels' guards: ``paged_attention_fwd``,
``flash_attention_fwd``, ``int8_quantize_fwd`` and ``int8_dequantize_fwd``
call ``kernels.refuse_autograd`` before they launch on a CUDA tensor, as
the scan wrappers do.

On the CPU the wrappers return before the guard, through their plain
versions, so their results still carry autograd's graph: the gradients
through each wrapper equal autograd through the plain version bit for
bit.  ``FlashAttention`` reaches ``flash_attention_fwd`` with grad mode
off, so the guard never refuses the training path; its gradients still
match ``jax.grad`` of the JAX package's attention within 1e-4 of their
scale.  The refusal itself is ``test_torch_scan_guard.py``'s, on the
card ``chip_smoke.py`` phase 18's; ``test_torch_analysis.py`` shows each
guard comes before its launch (GRAD001).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops, refuse_autograd  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_fwd  # noqa: E402
from repro_torch.kernels.quantize import (int8_dequantize_fwd,  # noqa: E402
                                          int8_quantize_fwd)


def _grads(fn, xs, seed):
    """Gradients of sum(out * w) for a fixed random w, out = fn(*xs)."""
    xs = [x.clone().requires_grad_() for x in xs]
    out = fn(*xs)
    out = out[0] if isinstance(out, tuple) else out
    w = torch.from_numpy(np.random.RandomState(seed).randn(*out.shape)
                         .astype(np.float32))
    return out, torch.autograd.grad((out.float() * w).sum(), xs)


def _paged_case(seed=0):
    rng = np.random.RandomState(seed)
    B, Hq, Hkv, D, page, n_cols = 2, 4, 2, 16, 4, 3
    N = B * n_cols
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    q, k, v = f(B, 1, Hq, D), f(N, page, Hkv, D), f(N, page, Hkv, D)
    table = torch.from_numpy(rng.permutation(N).reshape(B, n_cols)
                             .astype(np.int32))
    pos = torch.full((N, page), -1, dtype=torch.int32)
    for b in range(B):
        for c in range(n_cols):
            blk = int(table[b, c])
            pos[blk] = torch.arange(c * page, (c + 1) * page,
                                    dtype=torch.int32)
    q_pos = torch.tensor([[n_cols * page - 1], [n_cols * page - 3]],
                         dtype=torch.int32)
    return (q, k, v), (pos, table, q_pos)


def test_paged_attention_cpu_path_still_differentiates():
    (q, k, v), (pos, table, q_pos) = _paged_case()
    out, g = _grads(lambda q, k, v: paged_attention_fwd(
        q, k, v, pos, table, q_pos, window=5), (q, k, v), seed=1)
    exp_out, exp = _grads(lambda q, k, v: ref.paged_attention_ref(
        q, k, v, pos, table, q_pos, window=5), (q, k, v), seed=1)
    assert out.grad_fn is not None
    assert torch.equal(out, exp_out)
    for a, b in zip(g, exp):
        assert torch.equal(a, b) and bool(a.abs().sum() > 0)


@pytest.mark.parametrize("window", [0, 6])
def test_flash_attention_fwd_cpu_path_still_differentiates(window):
    rng = np.random.RandomState(window)
    q, k, v = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((1, 4, 12, 16), (1, 2, 12, 16), (1, 2, 12, 16)))
    out, g = _grads(lambda q, k, v: flash_attention_fwd(q, k, v,
                                                         window=window),
                    (q, k, v), seed=2)
    exp_out, exp = _grads(lambda q, k, v: ref.flash_attention_ref(
        q, k, v, window=window, return_lse=True), (q, k, v), seed=2)
    assert out.grad_fn is not None and torch.equal(out, exp_out)
    for a, b in zip(g, exp):
        assert torch.equal(a, b)


def test_int8_cpu_paths_still_differentiate():
    x = torch.from_numpy(np.random.RandomState(3).randn(5, 100)
                         .astype(np.float32))
    xg = x.clone().requires_grad_()
    codes, scales = int8_quantize_fwd(xg, block=64)
    ecodes, escales = ref.int8_quantize_ref(x.clone().requires_grad_(), 64)
    assert torch.equal(codes, ecodes) and torch.equal(scales, escales)
    assert scales.grad_fn is not None
    (gx,) = torch.autograd.grad(scales.sum(), xg)
    assert bool(gx.abs().sum() > 0)
    sg = scales.detach().clone().requires_grad_()
    out = int8_dequantize_fwd(codes, sg, x.shape)
    (gs,) = torch.autograd.grad(out.sum(), sg)
    se = scales.detach().clone().requires_grad_()
    (ge,) = torch.autograd.grad(
        ref.int8_dequantize_ref(codes, se, x.shape).sum(), se)
    assert out.grad_fn is not None and torch.equal(gs, ge)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", [(2, 4, 2, 32, 16, 0),
                                                 (1, 4, 1, 29, 24, 8)])
def test_flash_attention_function_passes_the_guard_and_matches_jax(
        B, Hq, Hkv, S, D, window, monkeypatch):
    """``ops.flash_attention`` under grad mode, its forward checked by the
    guard as the CUDA path checks it: the guard lets it through (grad mode
    is off inside the Function), and the gradients equal ``jax.grad``'s
    within 1e-4 of their scale."""
    seen = []

    def guarded(q, k, v, **kw):
        seen.append(torch.is_grad_enabled())
        refuse_autograd("flash_attention", q, k, v)
        return flash_attention_fwd(q, k, v, **kw)
    monkeypatch.setattr(FA, "flash_attention_fwd", guarded)

    rng = np.random.RandomState(S)
    q = rng.randn(B, Hq, S, D).astype(np.float32)
    k = rng.randn(B, Hkv, S, D).astype(np.float32)
    v = rng.randn(B, Hkv, S, D).astype(np.float32)
    d_out = np.random.RandomState(S + 1).randn(B, S, Hq, D).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))

    def jloss(q, k, v):
        o = JL.attention(q, k, v, pos, pos, window=window, kv_chunk=16)
        return jnp.sum(o * d_out)
    bshd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(bshd(q), bshd(k), bshd(v))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, window=window)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(d_out).transpose(1, 2))
    assert seen == [False]
    for name, t, j in zip("qkv", grads, jg):
        j = np.asarray(j).transpose(0, 2, 1, 3)
        scale = float(np.abs(j).max())
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4 * scale, rtol=0,
                                   err_msg=f"d{name}")
