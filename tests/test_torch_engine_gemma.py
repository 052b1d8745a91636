"""The port's ``ServingEngine`` on the ``gemma3-12b`` smoke config (one
sliding-window layer of window 64, one global layer) against JAX
``generate()``, and against itself across cache layouts.

The scenarios of the JAX package's ``test_paged_engine.py::
test_paged_matches_dense_and_generate[gemma3-12b]`` and
``test_paged_swa_ring_wrap_parity``: prompts straddling page and chunk
boundaries, and one of 80 tokens, longer than the window, whose ring
wraps inside prefill (chunk 16) or within one chunk (chunk 80).  Greedy
tokens of the paged engine (the paged-decode kernel's path, its plain
version on the CPU, and the scan path) and of the dense ring engine must
equal ``generate()``'s.  That comparison runs in float32 activations (the
embedding upcast, every cache built in float32), where the two packages
differ by summation order only: in bfloat16 the CPU matmuls of XLA and
PyTorch round differently, and the 80-token prompt's fifth token differs
between the packages while each package agrees with itself across chunks
and layouts.  In bfloat16, as the engine serves, the port's layouts and
chunk sizes must give the same tokens.

Then three slots over seven requests: the global pool and the ring pool
are two block-id spaces over the same small ids, so a scrub that routed
an id of one kind to the pools of the other would zero a live slot's page
and change its tokens; ``make_clear_blocks`` is also checked leaf by leaf.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models.transformer import init_params as jax_init  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402

ARCH = "gemma3-12b"
WRAP = [(i * 7 + 3) % 512 for i in range(80)]      # 80 > window 64
PROMPTS = [[7], [1, 2, 3], list(range(5, 22)), [9, 8, 7, 6, 5, 4, 3, 2, 1],
           WRAP]


@pytest.fixture(scope="module")
def model():
    cfg = jax_smoke(ARCH)
    assert cfg.sliding_window == 64
    jp = jax_init(jax.random.PRNGKey(7), cfg)
    return cfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def f32_model(model):
    """Float32 activations: the embedding upcast in both packages (the
    caches follow in ``f32_caches``)."""
    cfg, jp, tp = model
    return (cfg, dict(jp, embed=jp["embed"].astype(jnp.float32)),
            dict(tp, embed=tp["embed"].float()))


@pytest.fixture
def f32_caches(monkeypatch):
    monkeypatch.setattr(JE, "init_cache",
                        partial(JE.init_cache, dtype=jnp.float32))
    monkeypatch.setattr(TE, "init_cache",
                        partial(TE.init_cache, dtype=torch.float32))


@pytest.fixture(scope="module")
def refs(f32_model):
    cfg, jp, _ = f32_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JE, "init_cache", partial(JE.init_cache,
                                             dtype=jnp.float32))
        return [np.asarray(JE.generate(jp, cfg, jnp.asarray([p], jnp.int32),
                                       max_new=6))[0, len(p):].tolist()
                for p in PROMPTS]


def _serve(tp, cfg, prompts, max_new=6, **kw):
    eng = TE.ServingEngine(tp, cfg, device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(TE.Request(i, list(p), max_new=max_new))
    return {r.req_id: list(r.generated) for r in eng.run()}, eng


@pytest.mark.parametrize("chunk", [4, 16, 80])
@pytest.mark.parametrize("layout", ["kernel", "paged", "dense"])
def test_engine_matches_jax_generate(f32_model, f32_caches, refs, layout,
                                     chunk, monkeypatch):
    cfg, _, tp = f32_model
    windows = []
    wrapped = ops.paged_attention

    def counted(*args, **kw):
        windows.append(kw["window"])
        return wrapped(*args, **kw)
    monkeypatch.setattr(ops, "paged_attention", counted)
    kw = dict(slots=2, cache_len=128, chunk=chunk, page_size=16,
              paged=layout != "dense", use_kernel=layout == "kernel")
    done, eng = _serve(tp, cfg, PROMPTS, **kw)
    for i, ref in enumerate(refs):
        assert done[i] == ref, (layout, chunk, i, done[i], ref)
    if layout == "kernel":
        # both layers of every single-token step (the decode ticks and
        # the 1-token prefill tails) went through the kernel's wrapper,
        # the ring layer with its window
        n = eng.stats["decode_calls"] + sum(len(p) % chunk == 1
                                            for p in PROMPTS)
        assert sorted(windows) == [0] * n + [64] * n
    else:
        assert windows == []
    if layout != "dense":
        assert eng.num_blocks_swa == 2 * 4 and eng._ring_blocks == 4
        assert eng.stats["shared_pages"] == 0      # rings gate sharing off
        assert eng._alloc.n_free == eng.num_blocks
        assert eng._alloc_swa.n_free == eng.num_blocks_swa


def test_bf16_layouts_and_chunks_agree(model):
    cfg, _, tp = model
    runs = [_serve(tp, cfg, PROMPTS, slots=2, cache_len=128, chunk=chunk,
                   page_size=16, paged=layout != "dense",
                   use_kernel=layout == "kernel")[0]
            for chunk in (4, 16, 80)
            for layout in ("kernel", "paged", "dense")]
    assert all(r == runs[0] for r in runs)


def test_three_slot_recycling_routes_scrubs_by_kind(model):
    """Seven requests over three slots, 8-row pages: ring columns wrap
    and slots recycle while others hold pages of both kinds.  The paged
    kernel path, the paged scan path and the dense engine agree."""
    cfg, _, tp = model
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in (70, 3, 41, 90, 12, 66, 25)]
    kw = dict(slots=3, cache_len=112, chunk=16, page_size=8, max_new=8)
    kern, eng = _serve(tp, cfg, prompts, paged=True, use_kernel=True, **kw)
    scan, _ = _serve(tp, cfg, prompts, paged=True, **kw)
    dense, _ = _serve(tp, cfg, prompts, paged=False, **kw)
    assert kern == scan == dense
    assert eng._alloc.n_free == eng.num_blocks
    assert eng._alloc_swa.n_free == eng.num_blocks_swa == 3 * 8


def test_clear_blocks_routes_each_id_to_its_kind(model):
    cfg, _, tp = model
    eng = TE.ServingEngine(tp, cfg, slots=2, cache_len=64, page_size=8,
                           paged=True, device="cpu")
    g = torch.Generator().manual_seed(0)
    swa, glob = eng.caches["stack"]          # period: (swa, attn)
    for layer in (swa, glob):
        layer["k"].copy_(torch.randn(layer["k"].shape, generator=g))
        layer["pos"].fill_(5)
    before = {n: (swa[n].clone(), glob[n].clone()) for n in ("k", "pos")}
    TE.make_clear_blocks(cfg)(eng.caches, [1], [2])
    for n in ("k", "pos"):
        fill = -1 if n == "pos" else 0
        old_swa, old_glob = before[n]
        assert (swa[n][:, 2] == fill).all() and (glob[n][:, 1] == fill).all()
        keep = [b for b in range(swa[n].shape[1]) if b != 2]
        assert torch.equal(swa[n][:, keep], old_swa[:, keep])
        keep = [b for b in range(glob[n].shape[1]) if b != 1]
        assert torch.equal(glob[n][:, keep], old_glob[:, keep])


def test_launcher_serves_gemma3_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--kernel",
                       "--requests", "3", "--max-new", "3", "--slots", "2",
                       "--chunk", "4", "--no-warmup"])
    out = capsys.readouterr().out
    assert "gemma3-12b-smoke: served 3 requests" in out
