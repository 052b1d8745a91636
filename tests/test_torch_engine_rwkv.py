"""The port's ``ServingEngine`` on the attention-free ``rwkv6-7b`` smoke
config, against the JAX package's ``generate()`` and engine statistics.

Tokens are compared with JAX ``generate()`` rather than with the JAX
engine (the JAX engine has been seen to stray under heavy parallel
load).  Where a greedy token differs, the test shows that the JAX
top-1/top-2 margin at that step (JAX forward over the same history) is
under the port's logit tolerance on this model, 5e-2 of the logit scale
(see ``test_torch_ssm.py``), and stops comparing that request.  Inside
the port the paged kernel path, the paged plain path and the dense
engine must agree token for token.  Engine statistics do not depend on
token values and must equal the JAX engine's.
"""
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
from repro_torch.kernels.rwkv_scan import rwkv_scan_fwd  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

ARCH = "rwkv6-7b"
STATS = ("prefill_calls", "decode_calls", "admitted", "backpressure",
         "shared_pages", "shared_tokens", "cow_copies")
LOGIT_TOL = 5e-2


@pytest.fixture(scope="module")
def model():
    cfg = jax_smoke(ARCH)
    jp = jax_init(jax.random.PRNGKey(9), cfg)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _serve(mod, params, cfg, prompts, *, max_new=4, **kw):
    eng = mod.ServingEngine(params, cfg, **kw)
    for i, p in enumerate(prompts):
        eng.submit(mod.Request(i, list(p), max_new=max_new))
    return {r.req_id: list(r.generated) for r in eng.run()}, eng


def _assert_matches_jax_generate(jp, cfg, prompts, done, max_new):
    for i, p in enumerate(prompts):
        ref = JE.generate(jp, cfg, jnp.asarray([p], jnp.int32),
                          max_new=max_new)[0, len(p):].tolist()
        assert len(done[i]) == max_new
        for t, (a, b) in enumerate(zip(done[i], ref)):
            if a != b:
                lg = np.asarray(jax_forward(
                    jp, cfg, {"tokens": jnp.asarray([p + ref[:t]])})[0],
                    np.float32)[0, -1]
                top2 = np.sort(lg)[-2:]
                scale = max(1.0, float(np.abs(lg).max()))
                assert top2[1] - top2[0] < LOGIT_TOL * scale, (i, t, a, b)
                break


def test_paged_kernel_plain_dense_agree_and_match_jax_generate(model):
    """Mixed prompt lengths straddling chunk (4) boundaries, 4 requests
    over 2 slots (mirrors ``test_paged_engine.py``'s parity case)."""
    cfg, jp, tp = model
    prompts = [[7], [1, 2, 3], list(range(5, 22)), [9, 8, 7, 6, 5, 4, 3, 2, 1]]
    kw = dict(slots=2, cache_len=64, chunk=4, page_size=16, device="cpu")
    kern, eng = _serve(TE, tp, cfg, prompts, paged=True, use_kernel=True, **kw)
    plain, _ = _serve(TE, tp, cfg, prompts, paged=True, **kw)
    dense, _ = _serve(TE, tp, cfg, prompts, paged=False, **kw)
    assert kern == plain == dense
    _assert_matches_jax_generate(jp, cfg, prompts, kern, 4)
    assert rwkv_scan_fwd.launches == 0            # CPU: the plain version
    assert eng._alloc.n_free == eng.num_blocks    # no pool page was taken
    assert not eng._can_share


def test_stats_match_the_jax_engine(model):
    """Call counts and the prefix-sharing counters (all zero: a recurrent
    carry cannot skip prefill) equal the JAX engine's."""
    cfg, jp, tp = model
    rng = np.random.RandomState(0)
    system = rng.randint(0, cfg.vocab_size, 16).tolist()
    prompts = [system + rng.randint(0, cfg.vocab_size, 3).tolist(),
               rng.randint(0, cfg.vocab_size, 5).tolist(), list(system),
               rng.randint(0, cfg.vocab_size, 13).tolist()]
    kw = dict(slots=2, cache_len=64, chunk=4, paged=True, page_size=8)
    _, jeng = _serve(JE, jp, cfg, prompts, **kw)
    _, teng = _serve(TE, tp, cfg, prompts, use_kernel=True, device="cpu",
                     **kw)
    assert {k: teng.stats[k] for k in STATS} == {k: jeng.stats[k]
                                                 for k in STATS}
    assert teng.stats["prefill_calls"] == sum(-(-len(p) // 4)
                                              for p in prompts)
    assert teng.stats["shared_pages"] == 0


def test_prompt_longer_than_cache_len_is_admitted(model):
    """150 tokens > cache_len 64: an attention-free model has no
    cache_len-sized buffer, so the prompt is admitted; 150 = 9 x 16 + 6
    leaves a short last prefill chunk (mirrors
    ``test_serving_engine.py::test_attention_free_long_prompt_served``)."""
    cfg, jp, tp = model
    prompt = [(i * 5 + 1) % cfg.vocab_size for i in range(150)]
    done, eng = _serve(TE, tp, cfg, [prompt], slots=2, cache_len=64,
                       chunk=16, paged=True, use_kernel=True, device="cpu")
    assert eng.stats["prefill_calls"] == 10
    _assert_matches_jax_generate(jp, cfg, [prompt], done, 4)


def test_idle_slot_state_is_untouched_by_a_step(model):
    """After slot 0 admits a prompt, a decode tick of slot 0 leaves slot
    1's state and shift bit for bit as they were."""
    cfg, _, tp = model
    eng = TE.ServingEngine(tp, cfg, slots=2, cache_len=32, chunk=4,
                           paged=True, use_kernel=True, device="cpu")
    for layer in eng.caches["stack"]:
        for leaf in layer.values():
            leaf[:, 1] = torch.randn(leaf[:, 1].shape).to(leaf.dtype)
    idle = [{k: v[:, 1].clone() for k, v in layer.items()}
            for layer in eng.caches["stack"]]
    eng.submit(TE.Request(0, [1, 2, 3, 4, 5], max_new=3))
    eng.tick()
    for layer, before in zip(eng.caches["stack"], idle):
        for k, v in layer.items():
            assert torch.equal(v[:, 1], before[k]), k


def test_launcher_serves_rwkv_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--kernel",
                       "--requests", "3", "--max-new", "3", "--slots", "2",
                       "--chunk", "4", "--no-warmup"])
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out and "+kernel" in out
