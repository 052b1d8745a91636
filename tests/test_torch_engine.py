"""The slice as a whole: the port's ``ServingEngine`` against the JAX
package's on the same scenario, and the invariants that hold inside the
port bit for bit.

JAX and the port round bfloat16 at different places, so a greedy token
may differ where the top two logits nearly tie.  Where a token differs,
the test shows that the JAX top-1/top-2 margin at that step (from the
JAX forward over the same history) is under the bfloat16 tolerance,
2e-2 relative to the logit scale, and stops comparing that request (its
histories differ from there on).  The one other accepted difference is a
JAX-engine token that the JAX model's own forward does not choose at
that history while the port's token is the forward's choice: under
heavy parallel load the JAX engine has been seen to emit such tokens
(a fault of the reference, not of the port).  Engine statistics do not
depend on token values and must be equal.
"""
import dataclasses
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

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import forward as jax_forward  # noqa: E402
from repro.models.transformer import init_params as jax_init  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_fwd  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

STATS = ("prefill_calls", "decode_calls", "admitted", "backpressure",
         "shared_pages", "shared_tokens", "cow_copies")


def _tiny_cfg():
    cfg = jax_smoke("gpt3-24l")
    return dataclasses.replace(cfg, vocab_size=128, d_model=128, d_ff=256,
                               n_heads=4, n_kv_heads=2, head_dim=32)


def _models(cfg, seed=0):
    jp = jax_init(jax.random.PRNGKey(seed), cfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _scenario(vocab):
    """Mixed prompt lengths across page (8) and chunk (4) boundaries,
    three requests sharing a 16-token (two-page) system prefix — one of
    them exactly the prefix, so its last page copies on write — and one
    greedy request with a repetition penalty."""
    rng = np.random.RandomState(0)
    system = rng.randint(0, vocab, 16).tolist()
    prompts = [system + rng.randint(0, vocab, 3).tolist(),
               rng.randint(0, vocab, 5).tolist(),
               system + rng.randint(0, vocab, 9).tolist(),
               list(system),
               rng.randint(0, vocab, 13).tolist()]
    penalties = [1.0, 1.0, 1.0, 1.0, 1.5]
    return prompts, penalties


def _serve(mod, params, cfg, prompts, penalties=None, *, max_new=5, **kw):
    eng = mod.ServingEngine(params, cfg, **kw)
    for i, p in enumerate(prompts):
        pen = penalties[i] if penalties else 1.0
        eng.submit(mod.Request(i, list(p), max_new=max_new, rep_penalty=pen))
    done = {r.req_id: list(r.generated) for r in eng.run()}
    return done, eng.stats


def _jax_logits(jp, cfg, history, penalty):
    """The JAX model's next-token logits after ``history`` (repetition
    penalty applied over the history, as the engine does)."""
    lg = np.asarray(jax_forward(jp, cfg, {"tokens": jnp.asarray([history])})[0],
                    np.float32)[0, -1]
    if penalty != 1.0:
        seen = np.zeros(lg.shape, bool)
        seen[history] = True
        lg = np.where(seen, np.where(lg > 0, lg / penalty, lg * penalty), lg)
    return lg


@pytest.mark.parametrize("arch", ["gpt3-24l", "qwen3-8b"])
def test_engine_matches_jax_engine(arch):
    cfg = jax_smoke(arch)
    jp, tp = _models(cfg)
    prompts, pens = _scenario(cfg.vocab_size)
    kw = dict(slots=2, cache_len=64, chunk=4, paged=True, page_size=8)
    jdone, jstats = _serve(JE, jp, cfg, prompts, pens, **kw)
    tdone, tstats = _serve(TE, tp, cfg, prompts, pens, use_kernel=True,
                           device="cpu", **kw)
    assert {k: tstats[k] for k in STATS} == {k: jstats[k] for k in STATS}
    # ceil(S / chunk) calls per admission, except request 3: it is exactly
    # the prefix request 2 registered, so its two pages attach and only
    # its last token runs (one call instead of four), copying on write
    assert tstats["prefill_calls"] == sum(-(-len(p) // 4)
                                          for p in prompts) - 4 + 1
    assert tstats["shared_pages"] == 2 and tstats["cow_copies"] == 1
    for i, p in enumerate(prompts):
        for t, (a, b) in enumerate(zip(tdone[i], jdone[i])):
            if a != b:
                lg = _jax_logits(jp, cfg, p + jdone[i][:t], pens[i])
                top2 = np.sort(lg)[-2:]
                margin = float(top2[1] - top2[0])
                scale = max(1.0, float(np.abs(lg).max()))
                best = int(np.argmax(lg))
                assert margin < 2e-2 * scale or (b != best and a == best), (
                    i, t, a, b, best, margin)
                break
        assert len(tdone[i]) == len(jdone[i]) == 5


def test_kernel_scan_dense_and_chunk_sizes_agree_bitwise():
    """Inside the port: kernel path == scan path == dense engine, and
    chunk 1 == chunk 4, token for token."""
    cfg = _tiny_cfg()
    _, tp = _models(cfg)
    prompts = [[7], [1, 2, 3], list(range(5, 22)), [9, 8, 7, 6, 5, 4, 3, 2, 1]]
    kw = dict(slots=2, cache_len=64, page_size=16, device="cpu")
    runs = [_serve(TE, tp, cfg, prompts, paged=True, use_kernel=True,
                   chunk=4, **kw),
            _serve(TE, tp, cfg, prompts, paged=True, chunk=4, **kw),
            _serve(TE, tp, cfg, prompts, paged=False, chunk=4, **kw),
            _serve(TE, tp, cfg, prompts, paged=True, use_kernel=True,
                   chunk=1, **kw)]
    ref = TE.generate(tp, cfg, [prompts[2]], max_new=5)[0, 17:].tolist()
    assert runs[0][0] == runs[1][0] == runs[2][0] == runs[3][0]
    assert runs[0][0][2] == ref
    assert runs[0][1]["prefill_calls"] == sum(-(-len(p) // 4)
                                              for p in prompts)
    assert runs[3][1]["prefill_calls"] == sum(len(p) for p in prompts)


def test_recycled_blocks_are_scrubbed_under_the_kernel_path():
    """slots=1 and a pool one request wide: request 1 decodes through the
    kernel path on request 0's recycled blocks."""
    cfg = _tiny_cfg()
    cfg = dataclasses.replace(cfg, n_kv_heads=4)
    _, tp = _models(cfg, seed=2)
    prompts = [[5, 6, 7, 8, 9, 10, 11], [1, 2, 3]]
    done, _ = _serve(TE, tp, cfg, prompts, max_new=4, slots=1, cache_len=32,
                     chunk=4, paged=True, page_size=8, num_blocks=2,
                     use_kernel=True, device="cpu")
    for i, p in enumerate(prompts):
        ref = TE.generate(tp, cfg, [p], max_new=4)[0, len(p):].tolist()
        assert done[i] == ref, (i, done[i], ref)


def test_backpressure_and_impossible_requests():
    cfg = _tiny_cfg()
    _, tp = _models(cfg)
    kw = dict(slots=2, cache_len=32, chunk=4, paged=True, page_size=8,
              num_blocks=3, device="cpu")
    done, stats = _serve(TE, tp, cfg, [[1] * 10, [2] * 10], max_new=4, **kw)
    assert stats["backpressure"] > 0 and len(done) == 2
    eng = TE.ServingEngine(tp, cfg, **kw)
    with pytest.raises(ValueError, match="pool has only"):
        eng.submit(TE.Request(0, [1] * 20, max_new=8))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(TE.Request(1, [], max_new=2))


def test_use_kernel_requires_paged_and_gpu_default_raises():
    cfg = _tiny_cfg()
    _, tp = _models(cfg)
    with pytest.raises(ValueError, match="use_kernel"):
        TE.ServingEngine(tp, cfg, paged=False, use_kernel=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TE.ServingEngine(tp, cfg, paged=True)


def test_sampling_deterministic_isolated_and_top_k_one_greedy():
    """A sampled slot's tokens depend only on (seed, slot, step): two
    engines agree; the greedy slot beside it equals an all-greedy run;
    top_k=1 degenerates to greedy."""
    cfg = _tiny_cfg()
    _, tp = _models(cfg)
    kw = dict(slots=2, cache_len=64, chunk=4, paged=True, page_size=16,
              use_kernel=True, device="cpu", seed=3)

    def run(reqs):
        eng = TE.ServingEngine(tp, cfg, **kw)
        for r in reqs:
            eng.submit(r)
        return {r.req_id: r.generated for r in eng.run()}

    def reqs(**sampled):
        return [TE.Request(0, [1, 2, 3], max_new=8),
                TE.Request(1, [4, 5, 6], max_new=8, **sampled)]

    hot = dict(temperature=1.5, top_p=0.95, top_k=16, rep_penalty=1.2)
    a, b = run(reqs(**hot)), run(reqs(**hot))
    greedy = run(reqs())
    assert a == b
    assert a[0] == greedy[0]
    assert a[1] != greedy[1]
    assert run(reqs(temperature=1.0, top_k=1)) == greedy
    assert paged_attention_fwd.launches == 0      # CPU: the plain version


def test_topp_sample_stays_in_jax_keep_set_and_penalty_matches_jax():
    rng = np.random.RandomState(5)
    B, V = 4, 64
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    temp = np.asarray([0.7, 1.0, 1.5, 1.0], np.float32)
    top_p = np.asarray([0.9, 0.5, 1.0, 0.3], np.float32)
    top_k = np.asarray([0, 5, 10, 0], np.int32)
    # JAX's keep set, computed as in repro.serve.engine.topp_sample
    lg = jnp.asarray(logits) / jnp.asarray(temp)[:, None]
    order = jnp.argsort(-lg, axis=-1)
    probs = jax.nn.softmax(jnp.take_along_axis(lg, order, axis=-1), axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep = ((cum - probs) < jnp.asarray(top_p)[:, None]) & (
        jnp.arange(V)[None] < jnp.where(top_k > 0, top_k, V)[:, None])
    keep_sets = [set(np.asarray(order)[b][np.asarray(keep)[b]].tolist())
                 for b in range(B)]
    args = [torch.from_numpy(a) for a in (logits, temp, top_p, top_k)]
    seen = set()
    for draw in range(50):
        u = torch.from_numpy(rng.rand(B, V).astype(np.float32))
        tok = TE.topp_sample(u, *args)[:, 0].tolist()
        for b in range(B):
            assert tok[b] in keep_sets[b], (b, tok[b])
            seen.add((b, tok[b]))
    assert len(seen) > B                          # it does sample
    mask = rng.rand(B, V) < 0.3
    pen = np.asarray([1.0, 1.3, 2.0, 1.0], np.float32)
    exp = JE.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(mask),
                                      jnp.asarray(pen))
    out = TE.apply_repetition_penalty(torch.from_numpy(logits),
                                      torch.from_numpy(mask),
                                      torch.from_numpy(pen))
    np.testing.assert_array_equal(out.numpy(), np.asarray(exp))


def test_port_imports_without_jax_or_repro():
    """Every module of repro_torch imports with ``jax`` and ``repro``
    blocked."""
    code = """
import importlib, importlib.abc, pkgutil, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print(" ".join(mods))
"""
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    mods = set(proc.stdout.split())
    assert len(mods) >= 79
    assert {"repro_torch.models.ssm", "repro_torch.kernels.rwkv_scan",
            "repro_torch.configs.rwkv6_7b",
            "repro_torch.kernels.flash_attention", "repro_torch.tree",
            "repro_torch.train.loss", "repro_torch.train.step",
            "repro_torch.train.trainer", "repro_torch.optim.adamw",
            "repro_torch.data.synthetic", "repro_torch.checkpoint.store",
            "repro_torch.launch.train", "repro_torch.kernels.quantize",
            "repro_torch.core", "repro_torch.core.workload",
            "repro_torch.core.dag", "repro_torch.core.perfmodel",
            "repro_torch.core.decomposer", "repro_torch.core.scheduler",
            "repro_torch.core.pipeline", "repro_torch.core.dht",
            "repro_torch.core.broker", "repro_torch.core.compression",
            "repro_torch.core.executor", "repro_torch.serve.router",
            "repro_torch.serve.faults", "repro_torch.configs.gemma3_12b",
            "repro_torch.launch.dryrun", "repro_torch.launch.specs",
            "repro_torch.launch.roofline", "repro_torch.launch.mesh",
            "repro_torch.launch.shardings", "repro_torch.models.hints",
            "repro_torch.models.moe_ep", "repro_torch.analysis",
            "repro_torch.analysis.__main__", "repro_torch.analysis.core",
            "repro_torch.analysis.baseline", "repro_torch.analysis.reporters",
            "repro_torch.analysis.rules.alloc001",
            "repro_torch.analysis.rules.det001",
            "repro_torch.analysis.rules.fbk001",
            "repro_torch.analysis.rules.grad001",
            "repro_torch.analysis.rules.hot001",
            "repro_torch.analysis.rules.krn001",
            "repro_torch.analysis.rules.sync001"} <= mods


def test_examples_import_without_jax_or_repro():
    """Every script of ``examples_torch`` imports (its ``main`` is not run)
    with ``jax`` and ``repro`` blocked."""
    root = Path(__file__).resolve().parents[1]
    code = """
import importlib.abc, importlib.util, pathlib, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
names = []
for path in sorted(pathlib.Path(sys.argv[1]).glob("*.py")):
    spec = importlib.util.spec_from_file_location("ex_" + path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path.stem)
assert not any(k.split(".")[0] in ("jax", "repro") for k in sys.modules)
print(" ".join(names))
"""
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    proc = subprocess.run([sys.executable, "-c", code,
                           str(root / "examples_torch")], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == sorted(
        p.stem for p in (root / "examples").glob("*.py"))
