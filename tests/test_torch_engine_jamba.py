"""The port's ``ServingEngine`` on the ``jamba-1.5-large-398b`` smoke
config (attention + Mamba layers, MoE on every second layer), against
the JAX package's engine and ``generate()``.

MoE routing is a discrete choice, and in bfloat16 activations the two
packages' rounding differences swap some token's second expert now and
then (router margins of a few 1e-3 occur on this random smoke model):
the whole model's logits then differ by up to 68% of their scale (three
seeds of ``test_torch_transformer.py``'s forward; 18% on its own seed)
and greedy tokens part within a few steps, although every layer agrees
within 1-2% on the same input.  So the engines are compared in float32
activations and caches — the embedding upcast in both packages and
every cache built in float32 (both engines' ``init_cache``, wrapped
here) — where the two differ by float32 summation order only, and must
agree token for token.  The bfloat16 path is held to the port's own
plain path bit for bit (paged kernel path == paged plain path == dense
engine).

Every model call of the port's engine is replayed through the JAX
engine's own step function from fresh caches — the JAX model on the
same (slots x chunk) batch, tokens, positions and block table that the
port's step fed — and every live row's token must be the port's.  The
two engines must feed the same positions and tables at every call, and
the same tokens up to the first call at which the JAX engine's output
differs from the port's; from there on only the port is held, to the
replay.  Under heavy parallel load the JAX engine has been seen to emit
a token that its own model does not choose on the same batch
(``test_torch_engine.py``; a fault of the reference, not of the port):
that is the one accepted difference.  Engine statistics do not depend on
token values and must be equal.

Admissions that take the whole prompt in one call feed the model the
same batches as ``generate()`` up to idle padding rows, and with 2
slots and at most 4 tokens per row no expert reaches its capacity (C >=
every expert's load), so the port's engine, the JAX engine and JAX
``generate()`` must agree.  With chunked prefill idle rows' padding
fills capacity and live tokens are dropped: the port's engine, the
replay and the JAX engine (where it did not stray) must drop the same
number.  The port runs ``use_kernel=True``: on the CPU the kernels'
plain versions.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import init_params as jax_init  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan_fwd  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.config import (ATTN, DENSE, MOE,  # noqa: E402
                                       LayerSpec)
from repro_torch.models.layers import moe_capacity  # noqa: E402
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

ARCH = "jamba-1.5-large-398b"
STATS = ("prefill_calls", "decode_calls", "admitted", "backpressure",
         "shared_pages", "shared_tokens", "cow_copies")
MAX_NEW = 5


@pytest.fixture(scope="module")
def model():
    cfg = jax_smoke(ARCH)
    jp = jax_init(jax.random.PRNGKey(4), cfg)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture
def f32_model(model, monkeypatch):
    """The same parameters with a float32 embedding, and both engines'
    (and ``generate()``'s) caches built in float32."""
    cfg, jp, tp = model
    monkeypatch.setattr(JE, "init_cache",
                        partial(JE.init_cache, dtype=jnp.float32))
    monkeypatch.setattr(TE, "init_cache",
                        partial(TE.init_cache, dtype=torch.float32))
    return (cfg, dict(jp, embed=jp["embed"].astype(jnp.float32)),
            dict(tp, embed=tp["embed"].float()))


def _prompts(vocab, lens=(3, 9, 1, 14)):
    rng = np.random.RandomState(0)
    return [rng.randint(0, vocab, n).tolist() for n in lens]


# the JAX engine's jitted functions that take and return its caches
CACHE_FNS = ("_step_fn", "_reset_fn", "_clear_blocks_fn", "_copy_block_fn",
             "_scatter_blocks_fn")


def _copy(a):
    if isinstance(a, torch.Tensor):
        return a.numpy().copy()
    return np.array(a) if hasattr(a, "shape") else a


def _serve(mod, params, cfg, prompts, **kw):
    """Serve ``prompts`` greedily.  Also returns the engine, its initial
    (caches, seen), its functions that the run called and, in order,
    every call of them: (name, operands after the caches — after
    ``params``/``caches``/``seen`` for the step — copied at call time,
    the step's next-token output)."""
    eng = mod.ServingEngine(params, cfg, **kw)
    init = (eng.caches, eng._seen)
    calls, fns = [], {}

    def recorded(name, fn, *args):
        out = fn(*args)
        step = name == "_step_fn"
        calls.append((name, [_copy(a) for a in args[3 if step else 1:]],
                      np.asarray(out[0]) if step else None))
        return out
    for name in CACHE_FNS if mod is JE else CACHE_FNS[:1]:
        if hasattr(eng, name):
            fns[name] = getattr(eng, name)
            setattr(eng, name, partial(recorded, name, fns[name]))
    for i, p in enumerate(prompts):
        eng.submit(mod.Request(i, list(p), max_new=MAX_NEW))
    done = {r.req_id: list(r.generated) for r in eng.run()}
    return done, eng, (init, fns, calls)


def _jax_drop_counter(monkeypatch):
    """Count the JAX MoE dispatch's dropped assignments (slot == E*C), in
    and out of jit."""
    drops = []
    dispatch = JL._moe_dispatch_group

    def counted(xt, gate_vals, expert_idx, E, K, C):
        out = dispatch(xt, gate_vals, expert_idx, E, K, C)
        jax.debug.callback(lambda n: drops.append(int(n)),
                           (out[1] == E * C).sum())
        return out
    monkeypatch.setattr(JL, "_moe_dispatch_group", counted)
    return drops


def _check_against_jax(jeng, jrun, trun):
    """Replay the port's step calls, between the JAX engine's own slot
    resets and page scrubs, through the JAX engine's step function from
    its initial caches, and hold the port's live rows to it token for
    token.  Returns whether the JAX engine's own outputs equal the
    port's at every call (False: it strayed, see the docstring)."""
    (caches, seen), fns, jcalls = jrun
    tsteps = iter(trun[2])
    assert len(trun[2]) == sum(c[0] == "_step_fn" for c in jcalls)
    same = True
    for name, jops, jout in jcalls:
        if name != "_step_fn":
            caches = fns[name](caches, *jops)
            continue
        _, tops, tout = next(tsteps)
        toks, pos, table = tops[:3]
        assert np.array_equal(pos, jops[1])
        assert np.array_equal(table, jops[2])
        args = [jnp.asarray(a.astype(j.dtype)) for a, j in zip(tops, jops)]
        nxt, caches, seen = fns[name](jeng.params, caches, seen, *args)
        live = pos[:, -1] >= 0
        assert np.array_equal(tout[live], np.asarray(nxt)[live])
        if same:
            assert np.array_equal(toks, jops[0])
            same = np.array_equal(tout[live], jout[live])
    jax.effects_barrier()
    return same


def test_no_expert_reaches_capacity_at_these_sizes(model):
    """The premise of the strict comparison: with 2 slots and at most 4
    tokens per row every call has T <= 8 tokens, and each token sends
    one assignment to each of 2 distinct experts, so an expert's load is
    at most T, which never exceeds C.  (At 2 x 5 tokens C = 8 < 10: an
    idle row's identical padding tokens could crowd one expert.)"""
    cfg, _, _ = model
    for S in range(1, 5):
        assert moe_capacity(2 * S, cfg) >= 2 * S
    assert moe_capacity(2 * 5, cfg) < 2 * 5


def test_whole_prompt_admits_match_jax_engine_and_generate(f32_model):
    """chunk 4 >= every prompt: each admission is one call, as
    ``generate()``'s prefill (mirrors
    ``test_paged_engine.py::test_paged_hybrid_ssm_state_stays_per_slot``);
    ``generate()`` runs the prompts of each length as one batch."""
    cfg, jp, tp = f32_model
    prompts = _prompts(cfg.vocab_size, (4, 3, 4, 3))
    kw = dict(slots=2, cache_len=64, chunk=4, paged=True, page_size=8)
    jdone, jeng, jrun = _serve(JE, jp, cfg, prompts, **kw)
    tdone, teng, trun = _serve(TE, tp, cfg, prompts, use_kernel=True,
                               device="cpu", **kw)
    assert {k: teng.stats[k] for k in STATS} == {k: jeng.stats[k]
                                                 for k in STATS}
    assert teng.stats["prefill_calls"] == len(prompts)
    refs = {}
    for ids in ((0, 2), (1, 3)):
        out = JE.generate(jp, cfg, jnp.asarray([prompts[i] for i in ids],
                                               jnp.int32), max_new=MAX_NEW)
        for row, i in enumerate(ids):
            refs[i] = np.asarray(out)[row, len(prompts[i]):].tolist()
    if _check_against_jax(jeng, jrun, trun):
        assert tdone == jdone
    assert tdone == refs
    assert all(len(g) == MAX_NEW for g in tdone.values())
    assert mamba_scan_fwd.launches == 0           # CPU: the plain version


def test_chunked_prefill_matches_jax_engine(f32_model, monkeypatch):
    """3 slots, chunk 16: prompts of 9..40 tokens cross chunk boundaries
    (the last chunk has the prompt's exact length, so no padded step
    reaches the scan); Mamba state and conv history carry across the
    calls, the attention layer pages its cache (page 8).  A call has 48
    tokens and C = 32, and two idle rows' 32 identical padding tokens
    fill two experts, so live assignments are dropped: the port's
    engine, the JAX model on the same batches and the JAX engine must
    drop the same number."""
    cfg, jp, tp = f32_model
    drops = []
    dispatch = TL._moe_dispatch_group

    def counted(xt, gate_vals, expert_idx, E, K, C):
        out = dispatch(xt, gate_vals, expert_idx, E, K, C)
        drops.append(int((out[1] == E * C).sum()))
        return out
    monkeypatch.setattr(TL, "_moe_dispatch_group", counted)
    jdrops = _jax_drop_counter(monkeypatch)
    prompts = _prompts(cfg.vocab_size, (9, 40, 17, 30, 2))
    kw = dict(slots=3, cache_len=64, chunk=16, paged=True, page_size=8)
    jdone, jeng, jrun = _serve(JE, jp, cfg, prompts, **kw)
    jax.effects_barrier()
    engine_drops = sum(jdrops)
    tdone, teng, trun = _serve(TE, tp, cfg, prompts, use_kernel=True,
                               device="cpu", **kw)
    assert {k: teng.stats[k] for k in STATS} == {k: jeng.stats[k]
                                                 for k in STATS}
    assert teng.stats["prefill_calls"] == sum(-(-len(p) // 16)
                                              for p in prompts)
    assert sum(drops) > 0
    jdrops.clear()
    same = _check_against_jax(jeng, jrun, trun)
    assert sum(jdrops) == sum(drops)              # the replay's drops
    if same:
        assert tdone == jdone and engine_drops == sum(drops)
    assert all(len(g) == MAX_NEW for g in tdone.values())


def test_kernel_plain_and_dense_engines_agree(model):
    """Inside the port: the paged kernel path, the paged plain path and
    the dense engine give the same tokens (the plain versions repeat the
    plain path's operations)."""
    cfg, _, tp = model
    prompts = _prompts(cfg.vocab_size)
    kw = dict(slots=2, cache_len=64, chunk=4, page_size=8, device="cpu")
    kern = _serve(TE, tp, cfg, prompts, paged=True, use_kernel=True, **kw)[0]
    plain = _serve(TE, tp, cfg, prompts, paged=True, **kw)[0]
    dense = _serve(TE, tp, cfg, prompts, paged=False, **kw)[0]
    assert kern == plain == dense


@pytest.mark.parametrize("ffn", ["moe", "dense"])
def test_moe_model_shares_no_prefix(ffn):
    """MoE capacity truncation depends on the chunk's shape, so skipping a
    shared prefix page's prefill could change results: an MoE model never
    shares, even with ``share_prefix=True`` and a repeated two-page
    prefix.  Jamba's Mamba layers forbid sharing on their own, so the
    gate is shown on jamba's attention + MoE layer alone, beside its
    dense-FFN twin, which shares."""
    base = get_smoke_config(ARCH)
    cfg = dataclasses.replace(
        base, n_layers=1, n_experts=base.n_experts if ffn == "moe" else 0,
        period=(LayerSpec(mixer=ATTN, ffn=MOE if ffn == "moe" else DENSE),))
    tp = init_params(0, cfg, device="cpu")
    system = list(range(1, 17))
    prompts = [system + [20, 21], system + [30]]
    eng = _serve(TE, tp, cfg, prompts, slots=2, cache_len=64, chunk=4,
                 paged=True, page_size=8, share_prefix=True, device="cpu")[1]
    assert eng._can_share == (ffn == "dense")
    assert eng.stats["shared_pages"] == (2 if ffn == "dense" else 0)


def test_hybrid_caches_warmup_and_slot_reset(model):
    """A paged jamba engine holds attention pools beside per-slot Mamba
    state.  ``warmup`` runs both engine shapes with every position -1 and
    leaves every cache leaf bit for bit as it was (random here, so a
    stray write would show); resetting a slot zeroes its ``h`` and
    ``conv`` and leaves the other slot and the pools alone."""
    cfg, _, tp = model
    eng = TE.ServingEngine(tp, cfg, slots=2, cache_len=32, chunk=4,
                           paged=True, use_kernel=True, device="cpu")
    attn, *mamba = eng.caches["stack"]
    assert set(attn) == {"k", "v", "pos"}
    assert all(set(layer) == {"h", "conv"} for layer in mamba)
    g = torch.Generator().manual_seed(0)
    for layer in eng.caches["stack"]:
        for name, leaf in layer.items():
            if name != "pos":
                leaf.copy_(torch.randn(leaf.shape, generator=g))
    before = [{k: v.clone() for k, v in layer.items()}
              for layer in eng.caches["stack"]]
    eng.warmup()
    for layer, old in zip(eng.caches["stack"], before):
        for k, v in layer.items():
            assert torch.equal(v, old[k]), k
    TE._clear_slot(eng.caches, 1, skip_pools=True)
    for layer, old in zip(eng.caches["stack"], before):
        for k, v in layer.items():
            if k in TE.POOL_LEAVES:
                assert torch.equal(v, old[k]), k
            else:
                assert not v[:, 1].any() and torch.equal(v[:, 0],
                                                         old[k][:, 0]), k


def test_launcher_serves_jamba_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--kernel",
                       "--requests", "3", "--max-new", "3", "--slots", "2",
                       "--chunk", "4", "--no-warmup"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out and "+kernel" in out
    assert "prefix sharing" not in out
