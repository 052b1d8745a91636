"""The port's flash attention (``repro_torch.kernels``) against the JAX
package: the Pallas ``flash_attention`` (interpret mode on the CPU) over
the sweep of ``tests/test_kernels.py``, the model's blocked attention
(``layers.attention`` with ``pos = arange``, as in
``test_kernels.py::test_model_attention_matches_kernel``), and
``jax.grad`` of that attention for the port's autograd.

On CPU tensors the port's wrapper runs the kernel's plain version; the
Hopper kernel itself is held against that plain version on the card by
``chip_smoke.py``.  Inputs are drawn with numpy from a seed and handed to
both packages.  Both compute the scores and the softmax in float32, in
another order: float32 outputs agree to 2e-5, bfloat16 outputs (rounded
from nearly equal float32 values) to 2e-2, and float32 gradients — sums
over S of products of those values — to 1e-4 of each gradient's largest
element.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
SWEEP = [(2, 4, 2, 64, 64, 0),      # GQA causal
         (1, 8, 8, 128, 128, 0),    # MHA
         (2, 4, 1, 37, 80, 16),     # odd sizes + window (padding paths)
         (1, 2, 2, 192, 64, 64),    # sliding window
         (1, 16, 4, 48, 256, 0)]    # wide heads


def qkv(B, Hq, Hkv, S, D, seed, T=None):
    rng = np.random.RandomState(seed)
    T = T or S
    return (rng.randn(B, Hq, S, D).astype(np.float32),
            rng.randn(B, Hkv, T, D).astype(np.float32),
            rng.randn(B, Hkv, T, D).astype(np.float32))


def lse_np(q, k, window, causal=True):
    """Per-row logsumexp of the masked scores, in float64."""
    B, Hq, S, D = q.shape
    G = Hq // k.shape[1]
    kk = np.repeat(k.astype(np.float64), G, axis=1)
    s = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64), kk) * D ** -0.5
    i, j = np.arange(S)[:, None], np.arange(k.shape[2])[None, :]
    ok = np.ones_like(s[0, 0], bool)
    if causal:
        ok &= j <= i
    if window:
        ok &= j > i - window
    s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", SWEEP)
def test_flash_attention_matches_jax_kernel(B, Hq, Hkv, S, D, window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = qkv(B, Hq, Hkv, S, D, seed=S + D)
    exp = jops.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                               window=window)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, window=window)
    assert out.dtype == tdt and out.shape == (B, Hq, S, D)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp, np.float32),
                               atol=tol, rtol=tol)
    o2, lse = flash_attention_fwd(tq, tk, tv, window=window)
    assert torch.equal(o2, out) and lse.dtype == torch.float32
    exp_lse = lse_np(*(t.float().numpy() for t in (tq, tk)), window)
    np.testing.assert_allclose(lse.numpy(), exp_lse, atol=2e-5, rtol=2e-5)


def tc_kernel_rounding_model(q, k, v, *, window=0, p_parts=2):
    """The arithmetic of the bf16 tensor-core instance of
    ``csrc/flash_attention.cu``, in float32 torch: exact scores, the online
    softmax walking the kv tiles of the instance (64 keys for head dims
    <= 128, 32 for <= 256) from the last down, and P in bf16
    before P.V (the row sums keep the unrounded P): as hi + lo,
    hi = bf16(P) and lo = bf16(P - hi) (``p_parts=2``, the kernel), or as
    bf16(P) alone (``p_parts=1``).  Causal, by index, as the kernel."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    BK = 64 if D <= 128 else 32
    c = D ** -0.5
    kq = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vq = v.float().repeat_interleave(Hq // Hkv, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kq) * c
    i, j = torch.arange(S)[:, None], torch.arange(T)[None, :]
    ok = j <= i
    if window:
        ok &= j > i - window
    s = s.masked_fill(~ok, float("-inf"))
    m = torch.full((B, Hq, S, 1), -1e30)
    l = torch.zeros((B, Hq, S, 1))
    acc = torch.zeros((B, Hq, S, D))
    for t in reversed(range(-(-T // BK))):
        st = s[..., t * BK:(t + 1) * BK]
        mn = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - mn)
        p = torch.exp(st - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        vt = vq[..., t * BK:(t + 1) * BK, :]
        acc = acc * alpha + hi @ vt
        if p_parts == 2:
            acc = acc + (p - hi).to(torch.bfloat16).float() @ vt
        m = mn
    return (acc / l.clamp(min=1e-30)).to(torch.bfloat16)


@pytest.mark.parametrize("p_parts", [2, 1])
@pytest.mark.parametrize("B,Hq,Hkv,S,D,window,T",
                         [c + (None,) for c in SWEEP] + [(2, 4, 2, 40, 64, 0, 100)])
def test_tensor_core_rounding_model_matches_jax_kernel(B, Hq, Hkv, S, D, window,
                                                       T, p_parts):
    """The tensor-core kernel's rounding (P to bf16 as hi + lo before P.V,
    its tile walk) keeps the bf16 output within the bf16 tolerance of the
    JAX kernel at the sweep shapes and with T > S; so does P rounded to
    bf16 once, which the kernel does not use (it moved qwen3-8b's step-0
    gradients past their tolerance on the card)."""
    q, k, v = qkv(B, Hq, Hkv, S, D, seed=S + D, T=T)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    exp = np.asarray(jops.flash_attention(*jb, window=window), np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = tc_kernel_rounding_model(tq, tk, tv, window=window, p_parts=p_parts)
    assert out.shape == (B, Hq, S, D)
    np.testing.assert_allclose(out.float().numpy(), exp, atol=2e-2, rtol=2e-2)
    if p_parts == 1:        # the single rounding does move the result
        plain = flash_attention_ref(tq, tk, tv, window=window)
        assert not torch.equal(out, plain)


def test_more_keys_than_queries_masks_by_index():
    """T > S: query row i attends keys 0..i by index (the TPU kernel's
    masks), not the last S keys."""
    q, k, v = qkv(1, 4, 2, 5, 16, seed=3, T=9)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv)
    exp = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), ops.flash_attention(
        tq, tk[:, :, :5], tv[:, :, :5]).numpy(), atol=2e-6, rtol=2e-6)


def test_model_attention_matches_flash():
    """The port's blocked attention (no cache, pos = arange) and its flash
    attention agree, as the JAX package's do."""
    B, Hq, Hkv, S, D = 2, 4, 2, 64, 64
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in qkv(B, Hq, Hkv, S, D, seed=7))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    out_model = TL.attention(q, k, v, pos, pos, kv_chunk=32)
    out_flash = ops.flash_attention(*(t.transpose(1, 2).contiguous()
                                      for t in (q, k, v)))
    np.testing.assert_allclose(out_model.numpy(),
                               out_flash.transpose(1, 2).numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,window", [(2, 4, 2, 64, 32, 0),
                                                 (2, 4, 1, 37, 80, 16),
                                                 (1, 8, 2, 96, 64, 40)])
def test_flash_gradients_match_jax_grad(B, Hq, Hkv, S, D, window):
    """The autograd.Function's gradients (plain blocked FA2 backward from
    the forward's logsumexp) against ``jax.grad`` of the JAX model's
    attention, float32, within 1e-4 of each gradient's scale."""
    q, k, v = qkv(B, Hq, Hkv, S, D, seed=S)
    d_out = np.random.RandomState(S + 1).randn(B, S, Hq, D).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))

    def jloss(q, k, v):
        o = JL.attention(q, k, v, pos, pos, window=window, kv_chunk=32)
        return jnp.sum(o * d_out)
    bshd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(bshd(q), bshd(k), bshd(v))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, window=window)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(d_out).transpose(1, 2))
    for name, t, j in zip("qkv", grads, jg):
        j = np.asarray(j).transpose(0, 2, 1, 3)
        scale = float(np.abs(j).max())
        np.testing.assert_allclose(t.numpy(), j, atol=1e-4 * scale, rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,window,block_k", [(True, 0, 16),
                                                   (True, 24, 16),
                                                   (False, 0, 40)])
def test_blocked_backward_matches_autograd_of_plain(causal, window, block_k,
                                                    monkeypatch):
    """Many kv tiles, tiles skipped above the diagonal and behind the
    window, T > S, a bf16 input: the blocked backward equals autograd
    through the plain version."""
    monkeypatch.setattr(FA, "BLOCK_K", block_k)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        q, k, v = (torch.from_numpy(a).to(dtype)
                   for a in qkv(2, 4, 2, 50, 32, seed=11, T=70))
        d_out = torch.from_numpy(
            np.random.RandomState(12).randn(2, 4, 50, 32).astype(np.float32)
        ).to(dtype)
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        exp = torch.autograd.grad(flash_attention_ref(
            *xs, causal=causal, window=window), xs, d_out)
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
        got = flash_attention_bwd(q, k, v, out, lse, d_out, causal=causal,
                                  window=window)
        for name, a, b in zip("qkv", got, exp):
            assert a.dtype == dtype
            scale = b.float().abs().max().item()
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       atol=tol * scale, rtol=0,
                                       err_msg=f"{dtype} d{name}")


def _tiny_cfg(**kw):
    cfg = jax_smoke("qwen3-8b")
    return dataclasses.replace(cfg, vocab_size=64, d_model=64, d_ff=96,
                               n_heads=4, n_kv_heads=2, head_dim=16, **kw)


def test_attn_apply_without_cache_routes_to_flash():
    """Training-shaped self-attention (no cache, positions arange):
    ``use_kernel=True`` goes through ``ops.flash_attention`` and agrees
    with the scan path and with the JAX layer; a softcap is refused."""
    cfg = _tiny_cfg()
    jp = JL.attn_init(jax.random.PRNGKey(1), cfg)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tp = params_from_jax(jp, device="cpu")
    B, S = 2, 24
    x = np.random.RandomState(5).randn(B, S, cfg.d_model).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    jout, _ = JL.attn_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), cfg,
                            positions=jnp.asarray(pos))
    calls = []
    real = ops.flash_attention
    try:
        ops.flash_attention = lambda *a, **kw: calls.append(1) or real(*a, **kw)
        kout, _ = TL.attn_apply(tp, torch.from_numpy(x), cfg,
                                positions=torch.from_numpy(pos),
                                use_kernel=True)
    finally:
        ops.flash_attention = real
    sout, _ = TL.attn_apply(tp, torch.from_numpy(x), cfg,
                            positions=torch.from_numpy(pos))
    assert calls == [1]
    np.testing.assert_allclose(kout.numpy(), sout.numpy(), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(kout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=2e-5)
    with pytest.raises(NotImplementedError, match="softcap"):
        TL.attn_apply(tp, torch.from_numpy(x), _tiny_cfg(logits_softcap=30.0),
                      positions=torch.from_numpy(pos), use_kernel=True)


def test_forward_refuses_given_positions_with_the_flash_kernel():
    """The flash kernel masks by index, so ``forward`` with no cache and
    ``use_kernel`` takes only its default positions."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("qwen3-8b")
    params = TT.init_params(0, cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    TT.forward(params, cfg, {"tokens": toks}, use_kernel=True)
    with pytest.raises(ValueError, match="masks by index"):
        TT.forward(params, cfg, {"tokens": toks}, use_kernel=True,
                   positions=torch.arange(4, dtype=torch.int32)[None] + 3)


def test_cpu_path_counts_no_launch_and_other_devices_raise():
    """On CPU tensors the wrapper runs the plain version: the launch count
    stays put.  A tensor on any other non-CUDA device is refused."""
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 2, 1, 8, 16, seed=1))
    before = flash_attention_fwd.launches
    ops.flash_attention(q, k, v)
    assert flash_attention_fwd.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
