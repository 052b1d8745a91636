"""The port's training stack (``repro_torch.train``, ``optim``, ``data``,
``checkpoint``, ``launch.train``) against the JAX package on the same
numpy inputs.

Cross entropy and the train step run in float32 (the JAX parameters are
cast to float32 before both packages get them), so losses, gradient norms
and gradients agree to float32 rounding of sums taken in another order:
1e-5 relative for losses and norms, 1e-4 of each tensor's scale for
gradients and updated parameters.  The optimizer runs the same float32
arithmetic on the same inputs: 1e-6 relative.  Data must be bit-equal,
and checkpoints restore bit for bit across the packages.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import synthetic as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw as JO  # noqa: E402
from repro.train import loss as JLoss  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro.train import trainer as JTr  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax, params_from_jax  # noqa: E402
from repro_torch.data import synthetic as TD  # noqa: E402
from repro_torch.models.transformer import trainable  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.train import loss as TLoss  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.train import trainer as TTr  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_at_scale(t, j, tol, what=""):
    j = np.asarray(j, np.float32)
    scale = max(1e-30, float(np.abs(j).max()))
    np.testing.assert_allclose(t.detach().float().numpy(), j,
                               atol=tol * scale, rtol=0, err_msg=what)


def _tiny(jax_side: bool):
    """``tests/test_train_serve.py``'s tiny config, in either package."""
    cfg = (jax_smoke if jax_side else get_smoke_config)("gpt3-24l")
    return dataclasses.replace(cfg, vocab_size=128, d_model=128, d_ff=256,
                               n_heads=4, n_kv_heads=4, head_dim=32)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,z_coef", [(8, 0.0), (5, 1e-3)])
def test_cross_entropy_chunked_matches_jax(chunk, z_coef):
    """Ragged N (74 rows in chunks of chunk x B), IGNORE labels: loss,
    accuracy and the gradients of h and the head."""
    rng = np.random.RandomState(chunk)
    B, S, d, V = 2, 37, 16, 50
    h = rng.randn(B, S, d).astype(np.float32)
    head = rng.randn(d, V).astype(np.float32)
    labels = rng.randint(0, V, (B, S)).astype(np.int32)
    labels[0, :5] = labels[1, -3:] = JLoss.IGNORE

    def jfn(h, head):
        return JLoss.cross_entropy_chunked(h, head, jnp.asarray(labels),
                                           chunk=chunk, z_coef=z_coef)
    (jl, jacc), jvjp = jax.vjp(jfn, jnp.asarray(h), jnp.asarray(head))
    jgh, jghead = jvjp((jnp.ones(()), jnp.zeros(())))

    th = torch.from_numpy(h).requires_grad_()
    thead = torch.from_numpy(head).requires_grad_()
    tl, tacc = TLoss.cross_entropy_chunked(th, thead, torch.from_numpy(labels),
                                           chunk=chunk, z_coef=z_coef)
    gh, ghead = torch.autograd.grad(tl, (th, thead))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert tacc.item() == pytest.approx(float(jacc), abs=1e-7)
    _close_at_scale(gh, jgh, 1e-5, "dh")
    _close_at_scale(ghead, jghead, 1e-5, "dhead")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _opt_case(seed=0):
    """A small tree of the model's kinds of leaves: a bf16 matrix, a
    stacked (n_periods, d) f32 norm, a 1-D f32 vector; and three steps of
    gradients (the last one large, so the clip engages)."""
    rng = np.random.RandomState(seed)
    params = {"w": rng.randn(6, 10).astype(np.float32),
              "stack": ({"norm": rng.randn(3, 8).astype(np.float32)},),
              "b": rng.randn(5).astype(np.float32)}
    grads = [jax.tree.map(lambda a, s=s: (rng.randn(*a.shape) * s)
                          .astype(np.float32), params)
             for s in (0.1, 0.3, 5.0)]
    jdt = {"w": jnp.bfloat16}
    jp = {k: (jax.tree.map(lambda a, k=k: jnp.asarray(a, jdt.get(k, jnp.float32)), v))
          for k, v in params.items()}
    return jp, grads


@pytest.mark.parametrize("state_bits", [32, 8])
def test_adamw_matches_jax_over_three_updates(state_bits):
    kw = dict(weight_decay=0.1, state_bits=state_bits)
    jopt = JO.adamw(JO.cosine_lr(1e-2, 2, 10), **kw)
    topt = TO.adamw(TO.cosine_lr(1e-2, 2, 10), **kw)
    jp, grads = _opt_case()
    jstate = jopt.init(jp)
    tp = params_from_jax(_np(jp), device="cpu")
    tstate = opt_state_from_jax(_np(jstate), device="cpu")
    for g in grads:
        jg = jax.tree.map(lambda a, p: jnp.asarray(a, p.dtype), g, jp)
        jp, jstate, jm = jopt.update(jg, jstate, jp)
        tg = params_from_jax(_np(jg), device="cpu")
        tp, tstate, tm = topt.update(tg, tstate, tp)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    for t, j in zip(leaves(tp), jax.tree.leaves(jp)):
        assert t.dtype == params_from_jax(_np(j), device="cpu").dtype
        _close_at_scale(t, j, 1e-6 if t.dtype == torch.float32 else 8e-3)
    for t, j in zip(leaves(tstate["master"]),
                    jax.tree.leaves(jstate["master"])):
        _close_at_scale(t, j, 1e-6)
    for name in ("mu", "nu"):
        for t, j in zip(leaves(tstate[name]), jax.tree.leaves(jstate[name])):
            j = np.asarray(j)
            if j.dtype == np.int8:       # codes may move by one step
                assert np.abs(t.numpy().astype(int) - j).max() <= 1
            else:
                _close_at_scale(t, j, 1e-6, name)


def test_cosine_and_linear_schedules_match_jax():
    for jfn, tfn in ((JO.cosine_lr(3e-4, 5, 40, floor=1e-5),
                      TO.cosine_lr(3e-4, 5, 40, floor=1e-5)),
                     (JO.linear_lr(1e-3, 3, 20), TO.linear_lr(1e-3, 3, 20))):
        for s in (0, 1, 4, 5, 6, 20, 39, 40, 50):
            np.testing.assert_allclose(
                tfn(torch.tensor(s, dtype=torch.int32)).item(),
                float(jfn(jnp.asarray(s, jnp.int32))), rtol=1e-6)


def test_sgd_and_clip_match_jax():
    """SGD with momentum and clipping.  The JAX ``sgd`` cannot update a
    tree that holds tuples (its ``is_leaf=tuple`` unzip takes the tree's
    own tuples for its (param, velocity) pairs), so the JAX side gets the
    tree without its stacked tuple; the port updates both."""
    jp, grads = _opt_case(seed=1)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jp)
    with pytest.raises(IndexError):
        JO.sgd(0.05).update(jax.tree.map(jnp.asarray, grads[0]),
                            JO.sgd(0.05).init(jp), jp)
    tp_full = params_from_jax(_np(jp), device="cpu")
    TO.sgd(0.05, momentum=0.9).update(params_from_jax(grads[0], "cpu"),
                                      TO.sgd(0.05).init(tp_full), tp_full)
    jp = {k: v for k, v in jp.items() if k != "stack"}
    grads = [{k: v for k, v in g.items() if k != "stack"} for g in grads]
    jopt, topt = (m.sgd(0.05, momentum=0.9, clip_norm=1.0) for m in (JO, TO))
    jstate = jopt.init(jp)
    tp = params_from_jax(_np(jp), device="cpu")
    tstate = opt_state_from_jax(_np(jstate), device="cpu")
    for g in grads:
        jp, jstate, _ = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        tp, tstate, _ = topt.update(params_from_jax(g, device="cpu"), tstate,
                                    tp)
    for t, j in zip(leaves(tp), jax.tree.leaves(jp)):
        _close_at_scale(t, j, 1e-6)
    clipped, norm = TO.clip_by_global_norm(params_from_jax(grads[2], "cpu"), 1.0)
    jclipped, jnorm = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, grads[2]),
                                             1.0)
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    for t, j in zip(leaves(clipped), jax.tree.leaves(jclipped)):
        _close_at_scale(t, j, 1e-6)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_batches_bit_equal_to_jax():
    cfg = dict(vocab_size=1000, seq_len=33, global_batch=4, noise=0.2, seed=3)
    jl = JD.SyntheticLM(JD.SyntheticConfig(**cfg, ext_embed_dim=8))
    tl = TD.SyntheticLM(TD.SyntheticConfig(**cfg, ext_embed_dim=8),
                        device="cpu")
    assert tl.optimal_loss() == jl.optimal_loss()
    for step, sl in ((0, None), (7, None), (2, slice(1, 3))):
        jb, tb = jl.batch(step, batch_slice=sl), tl.batch(step, batch_slice=sl)
        assert set(jb) == set(tb) == {"tokens", "labels", "embeds"}
        for k in jb:
            assert tb[k].dtype == (torch.float32 if k == "embeds"
                                   else torch.int32)
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def _step_case(arch, B=4, S=16, seed=0):
    """float32 params of a smoke config, their AdamW state and one batch,
    in both packages."""
    jcfg = jax_smoke(arch)
    tcfg = get_smoke_config(arch)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JT.init_params(jax.random.PRNGKey(seed), jcfg))
    batch = JD.SyntheticLM(JD.SyntheticConfig(
        jcfg.vocab_size, S, B, noise=0.05, seed=seed)).batch(0)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jcfg, tcfg, jp, batch, tbatch


@pytest.mark.parametrize("arch", ["qwen3-8b", "gpt3-24l"])
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` step from the same float32 params, AdamW
    state and batch as JAX's jitted step: loss, grad norm, gradients and
    updated params and state, through the flash path and the scan path;
    then the eval step on the updated params."""
    jcfg, tcfg, jp, batch, tbatch = _step_case(arch)
    opt_kw = dict(weight_decay=0.01)
    jopt = JO.adamw(JO.cosine_lr(1e-3, 2, 10), **opt_kw)
    jstate = jopt.init(jp)
    jgrads = jax.jit(jax.grad(lambda p: JS.loss_fn(p, jcfg, batch)[0]))(jp)
    jnew, jstate2, jm = jax.jit(JS.make_train_step(jcfg, jopt))(
        jp, jstate, batch)
    for use_kernel in (True, False):
        tp = trainable(params_from_jax(_np(jp), device="cpu"))
        tstate = opt_state_from_jax(_np(jstate), device="cpu")
        loss, _ = TS.loss_fn(tp, tcfg, tbatch, use_kernel=use_kernel)
        for t, j in zip(leaves(TS.grads_of(tp, loss)), jax.tree.leaves(jgrads)):
            _close_at_scale(t, j, 1e-4, f"grad, use_kernel={use_kernel}")
        topt = TO.adamw(TO.cosine_lr(1e-3, 2, 10), **opt_kw)
        step = TS.make_train_step(tcfg, topt, use_kernel=use_kernel)
        tp, tstate, tm = step(tp, tstate, tbatch)
        for k in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
        np.testing.assert_allclose(tm["acc"].item(), float(jm["acc"]),
                                   atol=1e-7)
        assert int(tstate["step"]) == 1
        # the first AdamW update is lr * g / (|g| + eps) per element: a
        # rounding-level gradient may take either sign, so compare the
        # update over the elements whose gradient is above that level
        for t, j, p0, g in zip(leaves(tp), jax.tree.leaves(jnew),
                               jax.tree.leaves(jp), jax.tree.leaves(jgrads)):
            g = np.abs(np.asarray(g))
            sure = g > 1e-3 * g.max()
            d_t = t.detach().numpy() - np.asarray(p0)
            d_j = np.asarray(j) - np.asarray(p0)
            np.testing.assert_allclose(d_t[sure], d_j[sure], atol=1e-6,
                                       rtol=1e-3)
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                       atol=2.1e-3, rtol=0)
        for t, j in zip(leaves(tstate["mu"]), jax.tree.leaves(jstate2["mu"])):
            _close_at_scale(t, j, 1e-4, "mu")
    jeval = JS.make_eval_step(jcfg)(jnew, batch)
    teval = TS.make_eval_step(tcfg)(tp, tbatch)
    np.testing.assert_allclose(teval["ce"].item(), float(jeval["ce"]),
                               rtol=1e-5)


def test_gemma3_train_step_matches_jax():
    """gemma3-12b's smoke config (a sliding-window layer of window 64 and
    a global one) over 96-token sequences, longer than the window: the
    loss, grad norm and gradients of one SGD step equal JAX's, through
    the flash path (the windowed no-cache branch) and the scan path."""
    jcfg, tcfg, jp, batch, tbatch = _step_case("gemma3-12b", B=2, S=96)
    assert jcfg.sliding_window == 64
    jgrads = jax.jit(jax.grad(lambda p: JS.loss_fn(p, jcfg, batch)[0]))(jp)
    jloss = float(jax.jit(lambda p: JS.loss_fn(p, jcfg, batch)[0])(jp))
    for use_kernel in (True, False):
        tp = trainable(params_from_jax(_np(jp), device="cpu"))
        loss, _ = TS.loss_fn(tp, tcfg, tbatch, use_kernel=use_kernel)
        np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
        for t, j in zip(leaves(TS.grads_of(tp, loss)),
                        jax.tree.leaves(jgrads)):
            _close_at_scale(t, j, 1e-4, f"grad, use_kernel={use_kernel}")


def _sgd_grads(tcfg, params, batch, **kw):
    """The gradient one ``make_train_step`` step applied, read back from
    an SGD update with lr 1 and no clip: g = p_before - p_after."""
    before = [p.detach().clone() for p in leaves(params)]
    opt = TO.sgd(1.0)
    step = TS.make_train_step(tcfg, opt, **kw)
    params, _, m = step(params, opt.init(params), batch)
    return [b - p.detach() for b, p in zip(before, leaves(params))], m


@pytest.mark.parametrize("variant", [dict(microbatches=4), dict(remat=False),
                                     dict(remat_policy="none")])
def test_microbatches_and_remat_give_the_same_gradients(variant):
    """Microbatches 1 vs 4 (float32 average of equal slices: the mean
    over tokens is unchanged), and remat on vs off (the same arithmetic,
    recomputed)."""
    _, tcfg, jp, _, tbatch = _step_case("qwen3-8b", B=4, S=12, seed=2)

    def fresh():
        return trainable(params_from_jax(_np(jp), device="cpu"))
    g_ref, m_ref = _sgd_grads(tcfg, fresh(), tbatch)
    g, m = _sgd_grads(tcfg, fresh(), tbatch, **variant)
    np.testing.assert_allclose(m["loss"].item(), m_ref["loss"].item(),
                               rtol=1e-5)
    for a, b in zip(g, g_ref):
        _close_at_scale(a, b.numpy(), 1e-4 if "microbatches" in variant
                        else 1e-6)


def test_unported_options_raise():
    _, tcfg, jp, _, tbatch = _step_case("qwen3-8b", B=2, S=8)
    tp = trainable(params_from_jax(_np(jp), device="cpu"))
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TS.loss_fn(tp, tcfg, tbatch, remat_policy="dots_all")
    with pytest.raises(ValueError, match="multiple of microbatches"):
        TS.make_train_step(tcfg, TO.sgd(1e-3), microbatches=3)(
            tp, TO.sgd(1e-3).init(tp), tbatch)


# ---------------------------------------------------------------------------
# multi-token prediction (DeepSeek-V3's depth-1 MTP head)
# ---------------------------------------------------------------------------

def test_mtp_loss_matches_jax_on_deepseek_smoke():
    """deepseek-v3's smoke config (MLA, MoE with a shared expert, MTP) in
    float32: the loss and its terms, ``ce_mtp`` included, against JAX's
    ``loss_fn``.  Values only: MoE has no reference gradients (its
    ``optimization_barrier`` has no differentiation rule)."""
    jcfg, tcfg, jp, batch, tbatch = _step_case("deepseek-v3-671b", B=2, S=12)
    jl, jm = JS.loss_fn(jp, jcfg, batch)
    with torch.no_grad():
        tl, tm = TS.loss_fn(params_from_jax(_np(jp), device="cpu"), tcfg,
                            tbatch)
    assert set(tm) == set(jm) == {"ce", "aux", "acc", "ce_mtp"}
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in ("ce", "aux", "ce_mtp"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5,
                                   err_msg=k)


def test_mtp_dense_config_loss_and_gradients_match_jax():
    """gpt3-24l's smoke config with a depth-1 MTP head: loss, ``ce_mtp``
    and every gradient leaf (the MTP head's too) against JAX, through the
    flash path and the scan path; ``make_train_step`` with microbatches
    averages ``ce_mtp`` like the other metrics."""
    jcfg = dataclasses.replace(jax_smoke("gpt3-24l"), mtp_depth=1)
    tcfg = dataclasses.replace(get_smoke_config("gpt3-24l"), mtp_depth=1)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JT.init_params(jax.random.PRNGKey(5), jcfg))
    assert "mtp" in jp
    batch = JD.SyntheticLM(JD.SyntheticConfig(
        jcfg.vocab_size, 12, 4, noise=0.05, seed=5)).batch(0)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JS.loss_fn(p, jcfg, batch), has_aux=True))(jp)
    for use_kernel in (True, False):
        tp = trainable(params_from_jax(_np(jp), device="cpu"))
        tl, tm = TS.loss_fn(tp, tcfg, tbatch, use_kernel=use_kernel)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        np.testing.assert_allclose(tm["ce_mtp"].item(), float(jm["ce_mtp"]),
                                   rtol=1e-5)
        for t, j in zip(leaves(TS.grads_of(tp, tl)), jax.tree.leaves(jg)):
            _close_at_scale(t, j, 1e-4, f"grad, use_kernel={use_kernel}")
    g, m = _sgd_grads(tcfg, trainable(params_from_jax(_np(jp), device="cpu")),
                      tbatch, microbatches=2)
    assert "ce_mtp" in m and np.isfinite(m["ce_mtp"].item())


def test_trainer_step_on_llava_smoke_with_embeds_matches_jax():
    """One ``Trainer`` step of llava-next-mistral-7b's smoke config, fed
    the frontend stub's embeddings beside the tokens, in both packages
    from the same float32 params: the step's metrics, and the params
    after the update (as in ``test_train_step_matches_jax``)."""
    jcfg = jax_smoke("llava-next-mistral-7b")
    tcfg = get_smoke_config("llava-next-mistral-7b")
    data = dict(seq_len=16, global_batch=4, noise=0.05,
                ext_embed_dim=jcfg.ext_embed_dim)
    jloader = JD.SyntheticLM(JD.SyntheticConfig(jcfg.vocab_size, **data))
    tloader = TD.SyntheticLM(TD.SyntheticConfig(tcfg.vocab_size, **data),
                             device="cpu")
    assert "embeds" in tloader.batch(0)
    kw = dict(steps=1, lr=1e-3, warmup=1, log_every=1)
    jt = JTr.Trainer(jcfg, JTr.TrainConfig(**kw), jloader)
    jt.params = jax.tree.map(lambda a: a.astype(jnp.float32), jt.params)
    jt.opt_state = jt.optimizer.init(jt.params)
    p0 = jt.params
    tt = TTr.Trainer(tcfg, TTr.TrainConfig(device="cpu", **kw), tloader)
    tt.params = trainable(params_from_jax(_np(p0), device="cpu"))
    tt.opt_state = tt.optimizer.init(tt.params)
    jm, = jt.fit(log=lambda s: None)
    tm, = tt.fit(log=lambda s: None)
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
    for t, j in zip(leaves(tt.params), jax.tree.leaves(jt.params)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   atol=2.1e-3, rtol=0)


# ---------------------------------------------------------------------------
# trainer, checkpoints, launcher
# ---------------------------------------------------------------------------

def test_trainer_loss_decreases():
    """``tests/test_train_serve.py::test_trainer_loss_decreases`` on the
    port's Trainer, attention through the flash path."""
    cfg = _tiny(jax_side=False)
    loader = TD.SyntheticLM(TD.SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=64, global_batch=8, noise=0.05),
        device="cpu")
    trainer = TTr.Trainer(cfg, TTr.TrainConfig(
        steps=60, lr=3e-3, warmup=10, log_every=20, use_kernel=True,
        device="cpu"), loader)
    hist = trainer.fit(log=lambda s: None)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert last < first * 0.7, (first, last)
    assert last < np.log(cfg.vocab_size)


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint written by the JAX Trainer resumes in the port's
    Trainer bit for bit, and the port's in the JAX Trainer's; both write
    the same manifest (keys, dtypes, tree structure)."""
    d = str(tmp_path)
    kw = dict(lr=3e-3, warmup=2, log_every=1, ckpt_every=2, ckpt_dir=d)
    data = dict(seq_len=16, global_batch=4, noise=0.05)
    jloader = JD.SyntheticLM(JD.SyntheticConfig(128, **data))
    tloader = TD.SyntheticLM(TD.SyntheticConfig(128, **data), device="cpu")

    jt = JTr.Trainer(_tiny(True), JTr.TrainConfig(steps=2, **kw), jloader)
    jt.fit(log=lambda s: None)                    # writes step 2
    tt = TTr.Trainer(_tiny(False), TTr.TrainConfig(steps=4, device="cpu",
                                                   **kw), tloader)
    tt.maybe_restore()
    assert tt.start_step == 2
    for t, j in zip(leaves((tt.params, tt.opt_state)),
                    jax.tree.leaves((jt.params, jt.opt_state))):
        np.testing.assert_array_equal(t.detach().float().numpy(),
                                      np.asarray(j, np.float32))
    assert all(p.requires_grad for p in leaves(tt.params))
    hist = tt.fit(log=lambda s: None)             # steps 2, 3; writes step 4
    assert [m["step"] for m in hist] == [2, 3]

    jt2 = JTr.Trainer(_tiny(True), JTr.TrainConfig(steps=6, **kw), jloader)
    jt2.maybe_restore()
    assert jt2.start_step == 4
    for t, j in zip(leaves((tt.params, tt.opt_state)),
                    jax.tree.leaves((jt2.params, jt2.opt_state))):
        np.testing.assert_array_equal(t.detach().float().numpy(),
                                      np.asarray(j, np.float32))
    jt2.fit(log=lambda s: None)                   # steps 4, 5 in JAX

    with open(os.path.join(d, "step_00000002", "manifest.json")) as f:
        jman = json.load(f)
    with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
        tman = json.load(f)
    for k in ("keys", "dtypes", "treedef"):
        assert jman[k] == tman[k], k
    assert store.latest_step(d) == jstore.latest_step(d) == 6


def test_train_launcher_runs_on_cpu():
    src = Path(__file__).resolve().parents[1] / "src"
    # one thread: the suite runs several workers on the same cores
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "4", "--seq", "32", "--kernel"],
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "step     2" in proc.stdout
