"""The port's execution plane (``repro_torch.core.executor``: ``Bus``,
``SubDagExecutor`` FP / BP / Update by autograd, ``LocalCluster``)
against ``repro.core.executor`` on the gpt3-24l and rwkv6-7b smoke
models, with the parameters of a JAX ``LocalCluster`` carried across.

Tolerances, with reasons:
- JAX against the port, gpt3-24l: losses over 3 SGD steps within 2e-2
  relative and ``forward`` logits within 2e-2 of their scale — bf16
  activations rounded at different places by the two frameworks;
  rwkv6-7b within 5e-2, because RWKV amplifies one-ulp bf16 differences
  across layers (as the port's other RWKV tests).
- The BP task's parameter gradients against JAX's pullback, leaf by
  leaf, within 2e-2 of each leaf's largest magnitude (gradients in the
  parameters' dtypes, of bf16 activations; the worst leaf sits near
  1.5e-2).  A scaled loss
  cotangent, a leaf missing from the pullback or a cotangent sent to the
  wrong producer moves a leaf by far more.
- SGD at lr 1.0, 4 steps: the port's losses within 2e-2 relative of
  JAX's, both curves rising at some step — plain SGD at that rate is not
  monotone in the reference either.
- Bus bytes equal to JAX's key for key: the same messages cross the same
  cuts, the label's 0-byte cotangent included.
- The port against itself: k parts against 1 part bit for bit (losses,
  logits, parameters), as ``tests/test_executor.py`` holds JAX.
- The bf16 update ``p - lr * g`` bit for bit against JAX's, ``lr`` rounded
  to bf16 first as JAX's weak typing does.

The JAX references are computed once per module: its executor runs op by
op and takes seconds per step on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.core import executor as JE  # noqa: E402
from repro.core.dag import build_model_dag as jax_dag  # noqa: E402
from repro.core.decomposer import decompose_contiguous as jax_parts  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import executor_params_from_jax  # noqa: E402
from repro_torch.core import executor as TE  # noqa: E402
from repro_torch.core.dag import DAG, LOSS, PARAMETRIC, PLACEHOLDER, OpNode  # noqa: E402
from repro_torch.core.dag import build_model_dag  # noqa: E402
from repro_torch.core.decomposer import decompose_contiguous  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

B, S, LR, STEPS = 2, 16, 1e-3, 3
_GPT3_DAG = build_model_dag(get_smoke_config("gpt3-24l"), batch=B, seq=S,
                            kind="train")
GPT3_PARAM_OPS = [n for n in _GPT3_DAG.topo_order()
                  if _GPT3_DAG[n].op_type == PARAMETRIC]


def _batch(vocab, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (B, S)).astype(np.int32),
            rng.randint(0, vocab, (B, S)).astype(np.int32))


def _grads(c, tokens, labels, positions):
    """One FP and BP pass through every compnode of a cluster (JAX's or
    the port's: the same task interface), without the update: each
    parametric op's gradients, as the BP tasks return them."""
    for ex in c.executors:
        ph = {n: {"input": tokens, "label": labels}[n] for n in ex.op_names
              if c.dag[n].op_type == PLACEHOLDER}
        ex.fp(c.bus, c.assignment, ph, positions)
    grads = {}
    for ex in reversed(c.executors):
        grads.update(ex.bp(c.bus, c.assignment))
    return grads


def _jax_run(arch, k, steps, key, lr=LR, with_grads=False):
    """A JAX cluster of k parts: its parameters (numpy), ``forward``
    logits, the gradients of one FP / BP pass (``with_grads``), then the
    losses of ``steps`` SGD steps at ``lr`` and the Bus bytes of the first
    step."""
    cfg = jax_smoke(arch)
    dag = jax_dag(cfg, batch=B, seq=S, kind="train")
    toks, labels = _batch(cfg.vocab_size)
    c = JE.LocalCluster(dag, jax_parts(dag, k), cfg, jax.random.PRNGKey(key))
    params = {}
    for ex in c.executors:
        params.update(jax.tree.map(np.asarray, ex.params))
    logits = np.asarray(c.forward(jnp.asarray(toks)))
    grads = None
    if with_grads:
        c.bus = JE.Bus()
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
        grads = jax.tree.map(np.asarray, _grads(
            c, jnp.asarray(toks), jnp.asarray(labels), pos))
    c.bus = JE.Bus()
    losses, first_bytes = [], None
    for _ in range(steps):
        losses.append(c.train_step(jnp.asarray(toks), jnp.asarray(labels),
                                   lr=lr))
        first_bytes = first_bytes or dict(c.bus.bytes_sent)
    return dict(params=params, logits=logits, losses=losses, grads=grads,
                bytes=first_bytes, toks=toks, labels=labels)


@pytest.fixture(scope="module")
def jax_gpt3():
    return _jax_run("gpt3-24l", 3, STEPS, 42, with_grads=True)


@pytest.fixture(scope="module")
def jax_gpt3_lr1():
    return _jax_run("gpt3-24l", 3, 4, 42, lr=1.0)


@pytest.fixture(scope="module")
def jax_rwkv():
    return _jax_run("rwkv6-7b", 3, 2, 7)


def _port_cluster(arch, k, params=None, seed=0, **kw):
    cfg = get_smoke_config(arch)
    dag = build_model_dag(cfg, batch=B, seq=S, kind="train")
    c = TE.LocalCluster(dag, decompose_contiguous(dag, k), cfg, seed,
                        device="cpu", **kw)
    if params is not None:
        for ex in c.executors:
            ex.params = executor_params_from_jax(
                {n: params[n] for n in ex.params}, "cpu")
    return c


def _run(c, toks, labels, steps, lr=LR):
    t, l = torch.from_numpy(toks), torch.from_numpy(labels)
    logits = c.forward(t)
    c.bus = TE.Bus()
    losses, first_bytes = [], None
    for _ in range(steps):
        losses.append(c.train_step(t, l, lr=lr))
        first_bytes = first_bytes or dict(c.bus.bytes_sent)
    return logits, losses, first_bytes


def _close_at_scale(got, exp, tol):
    scale = float(np.abs(exp).max())
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol * scale)


def test_gpt3_cluster_matches_jax(jax_gpt3):
    ref = jax_gpt3
    c = _port_cluster("gpt3-24l", 3, ref["params"])
    logits, losses, _ = _run(c, ref["toks"], ref["labels"], STEPS)
    assert logits.dtype == torch.float32 and logits.shape == ref["logits"].shape
    _close_at_scale(logits.numpy(), ref["logits"], 2e-2)
    np.testing.assert_allclose(losses, ref["losses"], rtol=2e-2)
    assert losses[-1] < losses[0]


@pytest.fixture(scope="module")
def port_gpt3_grads(jax_gpt3):
    ref = jax_gpt3
    c = _port_cluster("gpt3-24l", 3, ref["params"])
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    return _grads(c, torch.from_numpy(ref["toks"]),
                  torch.from_numpy(ref["labels"]), pos)


@pytest.mark.parametrize("op", GPT3_PARAM_OPS)
def test_gradients_match_jax_pullback(jax_gpt3, port_gpt3_grads, op):
    """The BP tasks' gradients of each parametric op (3 compnodes: the
    cotangents crossed the Bus) against those of JAX's pullback from the
    same parameters and batch, leaf by leaf."""
    exp = dict(flatten_with_paths(jax_gpt3["grads"][op]))
    got = dict(flatten_with_paths(port_gpt3_grads[op]))
    assert got.keys() == exp.keys() and got
    for path, g in got.items():
        assert g is not None, path
        assert str(g.dtype) == f"torch.{exp[path].dtype.name}", path
        assert g.shape == exp[path].shape, path
        _close_at_scale(g.float().numpy(), exp[path].astype(np.float32),
                        2e-2)


def test_sgd_at_lr_1_follows_jax_up_and_down(jax_gpt3, jax_gpt3_lr1):
    """Plain SGD at lr 1.0 on one repeated batch: JAX's loss rises at some
    step, and the port's follows JAX's, step by step."""
    ref = jax_gpt3_lr1
    c = _port_cluster("gpt3-24l", 3, jax_gpt3["params"])
    _, losses, _ = _run(c, ref["toks"], ref["labels"], 4, lr=1.0)
    np.testing.assert_allclose(losses, ref["losses"], rtol=2e-2)
    for curve in (ref["losses"], losses):
        assert np.isfinite(curve).all()
        assert any(b > a for a, b in zip(curve, curve[1:])), curve


def test_bus_bytes_equal_jax_key_for_key(jax_gpt3):
    """The same messages cross the same cuts: activations forward,
    cotangents back, the int32 label to the loss's compnode and its
    0-byte cotangent home ((2, 0): 0.0)."""
    ref = jax_gpt3
    c = _port_cluster("gpt3-24l", 3, ref["params"])
    _, _, got = _run(c, ref["toks"], ref["labels"], 1)
    assert got == ref["bytes"]
    assert got[(2, 0)] == 0.0 and got[(0, 2)] == B * S * 4
    cut = c.dag.cut_bytes(c.assignment)
    assert 1.8 * cut <= sum(got.values()) <= 4 * cut


@pytest.mark.parametrize("k", [2, 3, 5])
def test_k_parts_equal_one_part_bit_for_bit(k):
    toks, labels = _batch(get_smoke_config("gpt3-24l").vocab_size, seed=1)
    c1 = _port_cluster("gpt3-24l", 1, seed=3)
    ck = _port_cluster("gpt3-24l", k, seed=3)
    assert len(ck.executors) == k
    l1, lk = _run(c1, toks, labels, STEPS), _run(ck, toks, labels, STEPS)
    assert torch.equal(l1[0], lk[0])
    assert l1[1] == lk[1]
    p1 = dict(flatten_with_paths({n: p for ex in c1.executors
                                  for n, p in ex.params.items()}))
    pk = dict(flatten_with_paths({n: p for ex in ck.executors
                                  for n, p in ex.params.items()}))
    assert p1.keys() == pk.keys()
    assert all(torch.equal(p1[n], pk[n]) for n in p1)


def test_rwkv_cluster_matches_jax(jax_rwkv):
    """The hybrid-DAG run of tests/test_executor_hybrid.py (rwkv_block
    ops) in the port: JAX's parameters, its losses within 5e-2, and the
    port's 1-part run equal to its 3-part run bit for bit."""
    ref = jax_rwkv
    c3 = _port_cluster("rwkv6-7b", 3, ref["params"])
    assert "rwkv_block" in {c3.dag[n].op for n in c3.dag.topo_order()}
    logits, losses, got_bytes = _run(c3, ref["toks"], ref["labels"], 2)
    np.testing.assert_allclose(losses, ref["losses"], rtol=5e-2)
    _close_at_scale(logits.numpy(), ref["logits"], 5e-2)
    assert got_bytes == ref["bytes"]
    c1 = _port_cluster("rwkv6-7b", 1, ref["params"])
    l1 = _run(c1, ref["toks"], ref["labels"], 2)
    assert l1[1] == losses and torch.equal(l1[0], logits)
    assert np.isfinite(losses).all() and losses[1] != losses[0]


def test_label_cotangent_is_a_zero_byte_message():
    c = _port_cluster("gpt3-24l", 3)
    toks, labels = _batch(c.cfg.vocab_size)
    t, l = torch.from_numpy(toks), torch.from_numpy(labels)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    assert c.assignment["label"] == 0 and c.assignment["loss"] == 2
    for ex in c.executors:
        ph = {n: {"input": t, "label": l}[n] for n in ex.op_names
              if c.dag[n].op_type == PLACEHOLDER}
        ex.fp(c.bus, c.assignment, ph, pos)
    c.executors[2].bp(c.bus, c.assignment)
    msg = c.bus.mailboxes[0]["bp/label/2"]
    assert msg.numel() == 0 and c.bus.bytes_sent[(2, 0)] == 0.0
    c.executors[1].bp(c.bus, c.assignment)
    grads = c.executors[0].bp(c.bus, c.assignment)    # consumes it
    assert "bp/label/2" not in c.bus.mailboxes[0]
    assert grads["embed"]["embed"].dtype == torch.bfloat16


def test_update_rounds_lr_to_bf16_as_jax():
    """JAX's ``(p - lr * g.astype(p.dtype)).astype(p.dtype)`` turns the
    weakly typed ``lr`` into bf16 before the multiply; the port must
    too, or some updated bf16 parameters differ by an ulp."""
    rng = np.random.RandomState(0)
    p = (rng.standard_normal(100_000) * 0.02).astype(ml_dtypes.bfloat16)
    g = (rng.standard_normal(100_000) * 0.5).astype(ml_dtypes.bfloat16)
    pn = rng.standard_normal(64).astype(np.float32)
    gn = rng.standard_normal(64).astype(np.float32)
    jex = JE.SubDagExecutor.__new__(JE.SubDagExecutor)
    jex.params = {"w": {"a": jnp.asarray(p), "n": jnp.asarray(pn)}}
    jex.update({"w": {"a": jnp.asarray(g), "n": jnp.asarray(gn)}}, 3e-3)
    tex = TE.SubDagExecutor.__new__(TE.SubDagExecutor)
    tex.params = executor_params_from_jax({"w": {"a": p, "n": pn}}, "cpu")
    tex.update(executor_params_from_jax({"w": {"a": g, "n": gn}}, "cpu"),
               3e-3)
    got = tex.params["w"]
    assert got["a"].requires_grad and got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["a"].detach().float().numpy(),
        np.asarray(jex.params["w"]["a"], np.float32))
    np.testing.assert_array_equal(got["n"].detach().numpy(),
                                  np.asarray(jex.params["w"]["n"]))


def test_use_kernel_sends_attention_through_flash():
    """``use_kernel=True`` routes every attention block through the
    differentiable flash attention (its plain version on the CPU, so no
    launch here); the step agrees with the blocked-attention path to
    bf16 rounding."""
    toks, labels = _batch(get_smoke_config("gpt3-24l").vocab_size)
    before = flash_attention_fwd.launches
    plain = _run(_port_cluster("gpt3-24l", 2, seed=5), toks, labels, 2)
    flash = _run(_port_cluster("gpt3-24l", 2, seed=5, use_kernel=True),
                 toks, labels, 2)
    assert flash_attention_fwd.launches == before
    _close_at_scale(flash[0].numpy(), plain[0].numpy(), 2e-2)
    np.testing.assert_allclose(flash[1], plain[1], rtol=2e-3)
    assert flash[2] == plain[2]


def test_register_op_plugs_a_new_op_into_the_vocabulary():
    """P5/P6: an op registered at run time trains through FP / BP /
    Update across a cut like the built-in ones."""
    TE.register_op(
        "test_scale",
        lambda gen, cfg, device: {"w": torch.ones(4, device=device)},
        lambda p, cfg, x, positions, use_kernel=False: x * p["w"])
    TE.register_op(
        "test_sq",
        lambda gen, cfg, device: {},
        lambda p, cfg, x, label, positions, use_kernel=False:
            ((x - label) ** 2).mean())
    try:
        dag = DAG("toy")
        dag.add(OpNode("input", "input", PLACEHOLDER))
        dag.add(OpNode("label", "label", PLACEHOLDER))
        dag.add(OpNode("x", "embedding", PARAMETRIC, args=("input",)))
        dag.add(OpNode("s", "test_scale", PARAMETRIC, args=("x",)))
        dag.add(OpNode("loss", "test_sq", LOSS, args=("s", "label")))
        cfg = get_smoke_config("gpt3-24l")
        cfg4 = dataclasses.replace(cfg, d_model=4)
        c = TE.LocalCluster(dag, [["input", "label", "x"], ["s", "loss"]],
                            cfg4, 0, device="cpu")
        toks = torch.zeros((B, S), dtype=torch.int32)
        lab = torch.ones((B, S, 4))
        before = c.executors[1].params["s"]["w"].clone()
        losses = [c.train_step(toks, lab, lr=0.5) for _ in range(3)]
        assert losses[2] < losses[0]
        assert not torch.equal(c.executors[1].params["s"]["w"], before)
        assert c.bus.bytes_sent[(1, 0)] > 0       # the cotangent of x
    finally:
        TE.OP_IMPLS.pop("test_scale")
        TE.OP_IMPLS.pop("test_sq")


def test_bus_recv_missing_key_is_descriptive():
    bus = TE.Bus()
    bus.send(0, 1, "fp/attn_3", torch.ones((2, 2)))
    assert bus.bytes_sent[(0, 1)] == 16.0
    with pytest.raises(KeyError) as ei:
        bus.recv(1, "fp/ffn_9")
    msg = str(ei.value)
    assert "fp/ffn_9" in msg and "dst=1" in msg and "fp/attn_3" in msg
    with pytest.raises(KeyError) as ei:
        bus.recv(7, "fp/attn_3")
    assert "dst=7" in str(ei.value) and "[]" in str(ei.value)
    assert torch.equal(bus.recv(1, "fp/attn_3"), torch.ones((2, 2)))


def test_cluster_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    cfg = get_smoke_config("gpt3-24l")
    dag = build_model_dag(cfg, batch=B, seq=S, kind="train")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.LocalCluster(dag, decompose_contiguous(dag, 2), cfg, 0)
