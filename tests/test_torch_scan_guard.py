"""The Mamba and RWKV scan kernels have no backward: their wrappers refuse
inputs that require grad under grad mode (on CUDA tensors, where they
would launch), and the training path never reaches them.

On the CPU the wrappers run their plain versions, which autograd
differentiates, so the refusal itself is checked here through the
shared guard, and on the card by ``chip_smoke.py``.  The training path is
checked by counting the calls that reach ``ops.mamba_scan`` /
``ops.rwkv_scan``: none from ``loss_fn(..., use_kernel=True)``, one a
Mamba or RWKV layer from the serving forward.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import ops, refuse_autograd  # noqa: E402
from repro_torch.models.config import MAMBA, RWKV  # noqa: E402
from repro_torch.models.transformer import (forward, init_cache,  # noqa: E402
                                            init_params, trainable)
from repro_torch.optim.adamw import sgd  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

SCAN = {"jamba-1.5-large-398b": ("mamba_scan", MAMBA),
        "rwkv6-7b": ("rwkv_scan", RWKV)}


def test_refuse_autograd_raises_only_for_a_grad_input_under_grad_mode():
    a = torch.ones(3)
    b = torch.ones(3, requires_grad=True)
    refuse_autograd("scan", a, None)
    with pytest.raises(RuntimeError, match="has no backward"):
        refuse_autograd("scan", a, b, None)
    with torch.no_grad():
        refuse_autograd("scan", a, b)
    refuse_autograd("scan", a, b.detach())


@pytest.mark.parametrize("arch", sorted(SCAN))
def test_training_path_keeps_the_scans_plain(arch, monkeypatch):
    name, mixer = SCAN[arch]
    cfg = get_smoke_config(arch)
    n_layers = sum(s.mixer == mixer for st in cfg.stacks
                   for s in st.period * st.n_periods)
    calls = []
    wrapped = getattr(ops, name)

    def counted(*args, **kw):
        calls.append(torch.is_grad_enabled()
                     and any(t.requires_grad for t in args))
        return wrapped(*args, **kw)
    monkeypatch.setattr(ops, name, counted)
    params = trainable(init_params(0, cfg, device="cpu"))
    batch = SyntheticLM(SyntheticConfig(cfg.vocab_size, 12, 2, seed=0),
                        device="cpu").batch(0)
    losses = []
    for use_kernel in (True, False):
        loss, _ = TS.loss_fn(params, cfg, batch, use_kernel=use_kernel)
        grads = TS.grads_of(params, loss)
        losses.append(loss.item())
    assert calls == [] and losses[0] == losses[1]
    assert all(g is not None for g in grads.values())
    step = TS.make_train_step(cfg, sgd(1e-2), use_kernel=True)
    step(params, sgd(1e-2).init(params), batch)
    assert calls == []
    # serving reaches the kernels' wrappers, once a layer, with no grad
    caches = init_cache(cfg, 2, 16, device="cpu")
    with torch.no_grad():
        forward(params, cfg, {"tokens": batch["tokens"]}, caches=caches,
                use_kernel=True)
    assert calls == [False] * n_layers
    assert np.isfinite(losses).all()
