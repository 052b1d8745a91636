"""The port's remat policies ("full", "dots", "dots_no_batch") against the
JAX package's under the same policy, and what each recomputes.

A policy changes what the backward pass recomputes, not what it computes:
loss and gradients equal JAX's (float32 params, 1e-5 relative for the
loss, 1e-4 of each tensor's scale for gradients, as ``test_torch_train``
holds them).  Gradients alone cannot tell a policy from a no-op, so the
matmuls the backward pass dispatches (``aten.mm`` / ``addmm`` and
``aten.bmm`` / ``baddbmm``, counted under a ``TorchDispatchMode``) are
compared with the backward of an un-rematerialized forward: "full"
recomputes every matmul of the forward's layers, "dots" none,
"dots_no_batch" only the batched ones (the attention's).
"""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import set_checkpoint_early_stop  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import synthetic as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import step as JS  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.transformer import forward, trainable  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

POLICIES = ("full", "dots", "dots_no_batch")
_A = torch.ops.aten
_KIND = {_A.mm.default: "mm", _A.addmm.default: "mm",
         _A.bmm.default: "bmm", _A.baddbmm.default: "bmm"}


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _KIND:
            self.n[_KIND[func]] += 1
        return func(*args, **(kwargs or {}))


def _case(arch, B=2, S=24, seed=0):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      JT.init_params(jax.random.PRNGKey(seed), jcfg))
    batch = JD.SyntheticLM(JD.SyntheticConfig(
        jcfg.vocab_size, S, B, noise=0.05, seed=seed)).batch(0)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jcfg, tcfg, jp, batch, tbatch


def _fresh(jp):
    return trainable(params_from_jax(jax.tree.map(np.asarray, jp),
                                     device="cpu"))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-12b"])
def test_remat_policy_matches_jax(arch, policy):
    """Loss and gradients of one step under ``policy`` equal JAX's under
    the same policy, through the flash path and the plain path."""
    jcfg, tcfg, jp, batch, tbatch = _case(arch)

    def jloss(p):
        return JS.loss_fn(p, jcfg, batch, remat_policy=policy)[0]
    jl = float(jax.jit(jloss)(jp))
    jgrads = jax.tree.leaves(jax.jit(jax.grad(jloss))(jp))
    for use_kernel in (True, False):
        tp = _fresh(jp)
        loss, _ = TS.loss_fn(tp, tcfg, tbatch, remat_policy=policy,
                             use_kernel=use_kernel)
        np.testing.assert_allclose(loss.item(), jl, rtol=1e-5)
        for t, j in zip(leaves(TS.grads_of(tp, loss)), jgrads):
            j = np.asarray(j, np.float32)
            scale = max(1e-30, float(np.abs(j).max()))
            np.testing.assert_allclose(t.detach().numpy(), j,
                                       atol=1e-4 * scale, rtol=0,
                                       err_msg=f"{policy} {use_kernel}")


def _backward_matmuls(tcfg, jp, tbatch, **kw):
    """Matmuls dispatched by the backward pass of one loss, and the loss.
    Early stop is off, so a full recompute runs every op of the period
    (with it on, the recompute may stop before the last matmul, whose
    output no backward formula reads)."""
    tp = _fresh(jp)
    with set_checkpoint_early_stop(False):
        loss, _ = TS.loss_fn(tp, tcfg, tbatch, **kw)
    with _CountMatmuls() as count:
        torch.autograd.grad(loss, list(leaves(tp)))
    return count.n, loss.item()


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_recomputes_what_it_should(policy):
    _, tcfg, jp, _, tbatch = _case("qwen3-8b")
    with torch.no_grad(), _CountMatmuls() as fwd:
        forward(_fresh(jp), tcfg, tbatch, compute_logits=False)
    assert fwd.n["mm"] == 14 and fwd.n["bmm"] == 4    # 2 layers: 7 + 2 each
    base, l0 = _backward_matmuls(tcfg, jp, tbatch, remat=False)
    got, l1 = _backward_matmuls(tcfg, jp, tbatch, remat_policy=policy)
    assert l1 == l0
    extra = {k: got[k] - base[k] for k in ("mm", "bmm")}
    expect = {"full": fwd.n, "dots": {"mm": 0, "bmm": 0},
              "dots_no_batch": {"mm": 0, "bmm": fwd.n["bmm"]}}[policy]
    assert extra == {k: expect[k] for k in ("mm", "bmm")}, (policy, extra)
