"""Stateful failover of the port's engine: the allocator's LRU hold,
verified export / import of a live request, snapshot resume, drain,
preemption and pool pressure — the scenarios of the JAX package's
``test_migration.py`` held against the port itself, and the payload's
structure and checksum held against the JAX package's.

Against the port itself (bit for bit): a request exported mid-decode and
imported into another engine over the same parameters finishes with the
tokens of one that never moved — on a dense model, on gemma3-12b's
smoke config with a prompt longer than its window (the ring has wrapped
and its pages ride the payload by kind), and on rwkv6-7b (per-slot state
in ``slot_state``).  A payload with one flipped byte, or a lying
checksum, is rejected with every cache leaf and the allocator of the
destination unchanged.  Resident prefix pages are deduplicated.

Against the JAX package, on numbers that do not depend on JAX's
numerics: ``RequestState``'s keys, shapes, byte sizes, ``cols`` /
``cols_swa``, digests, position and the pages' positions after the same
prompt and the same number of ticks in both engines, and
``state_checksum`` of hand-built states with equal bits.  Greedy tokens
are never held to a JAX engine run (under parallel load it strays).
"""
import copy
import dataclasses

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
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve.router import _flip_payload  # noqa: E402

PROMPT = list(range(2, 40))
MAX_NEW = 12
LONG = [(7 * i + 3) % 512 for i in range(90)]       # > gemma's window 64
_cache: dict = {}


def _model(arch="tiny"):
    """(JAX params, port params, cfg): gpt3-24l's smoke config narrowed
    as in the JAX tests ("tiny"), or an arch's smoke config."""
    if arch not in _cache:
        if arch == "tiny":
            cfg = dataclasses.replace(jax_smoke("gpt3-24l"), vocab_size=128,
                                      d_model=128, d_ff=256, n_heads=4,
                                      n_kv_heads=4, head_dim=32)
        else:
            cfg = jax_smoke(arch)
        jp = jax_init(jax.random.PRNGKey(0), cfg)
        _cache[arch] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                            "cpu"), cfg)
    return _cache[arch]


def _engine(arch="tiny", slots=2, cache_len=128, **kw):
    _, tp, cfg = _model(arch)
    return TE.ServingEngine(tp, cfg, slots=slots, cache_len=cache_len,
                            chunk=8, paged=True, page_size=16,
                            use_kernel=True, device="cpu", **kw)


def _prompt(arch):
    return LONG if arch == "gemma3-12b" else PROMPT


def _unmoved(arch="tiny", prompt=None, **kw):
    eng = _engine(arch)
    eng.submit(TE.Request(0, list(prompt or _prompt(arch)),
                          max_new=MAX_NEW, **kw))
    return eng.run()[0].generated


def _export_mid_decode(src, req, ticks=5):
    src.submit(req)
    for _ in range(ticks):
        src.tick()
    assert req.generated, "request must be mid-decode before export"
    return src.export_state(req)


def _snapshot(eng):
    return ([t.clone() for _, _, _, _, t in TE._cache_leaves(eng.caches)],
            eng._alloc.n_free, eng._alloc.reserved, dict(eng._alloc.refcount))


# ---------------------------------------------------------------------------
# the allocator's LRU hold
# ---------------------------------------------------------------------------

def test_lru_hold_keeps_and_revives_pages():
    a = TE.BlockAllocator(4, hold_limit=2)
    assert a.reserve(2)
    b0, b1 = a.alloc_one(), a.alloc_one()
    assert a.register(101, (None, (1,)), b0)
    assert a.register(102, (b0, (2,)), b1)
    assert a.free([b0]) == []        # registered + hold: not scrubbed
    assert a.free([b1]) == []
    assert a.n_held == 2 and a.n_free + a.n_held == 4
    assert a.is_registered(b0) and a.lookup(101, (None, (1,))) == b0
    a.share(b0)                      # revived to refcount 1
    assert a.refcount[b0] == 1 and a.n_held == 1
    assert a.free([b0]) == [] and a.n_held == 2


def test_lru_hold_evicts_oldest_under_demand():
    a = TE.BlockAllocator(4, hold_limit=4)
    assert a.reserve(4)
    blocks = [a.alloc_one() for _ in range(4)]
    for i, b in enumerate(blocks):
        assert a.register(200 + i, (None, (i,)), b)
        assert a.free([b]) == []
    assert a.n_held == 4
    assert a.reserve(3)              # needs real free pages: oldest go
    assert a.n_held == 1
    assert a.lookup(200, (None, (0,))) is None
    assert a.lookup(203, (None, (3,))) == blocks[3]
    assert sorted(a.take_scrub()) == sorted(blocks[:3])
    assert a.take_scrub() == []


def test_pool_pressure_evicts_holds_first_and_scrubs_them():
    eng = _engine(hold_pages=8)
    eng.submit(TE.Request(0, list(PROMPT), max_new=2))
    eng.run()
    held = eng._alloc.n_held
    assert held >= 2
    blocks = list(eng._alloc._held)
    leaf = eng.caches["stack"][0]["pos"]
    assert (leaf[:, blocks] >= 0).any()          # content kept while held
    eng.set_pool_pressure(held)
    assert eng._alloc.n_held == 0 and eng._alloc.withheld == held
    assert (leaf[:, blocks] == -1).all()         # evicted pages scrubbed
    assert not eng.can_serve([1] * 200, 8)       # beyond cache_len
    assert eng.free_pages == eng.num_blocks - held
    eng.set_pool_pressure(0)
    assert eng._alloc.n_free == eng.num_blocks


def test_hold_lets_a_readmitted_prefix_attach_its_pages():
    eng = _engine(hold_pages=8)
    for i in range(2):               # the second arrives after an idle gap
        eng.submit(TE.Request(i, list(PROMPT), max_new=3))
        eng.run()
    assert eng.stats["shared_pages"] >= 2
    assert eng.finished[0].generated == eng.finished[1].generated


# ---------------------------------------------------------------------------
# export / import
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tiny", "gemma3-12b", "rwkv6-7b"])
def test_migration_round_trip_bitwise(arch):
    src, dst = _engine(arch), _engine(arch)
    req = TE.Request(1, list(_prompt(arch)), max_new=MAX_NEW)
    state = _export_mid_decode(src, req)
    assert state is not None and state.payload_bytes > 0
    assert src.n_active == 0 and src._alloc.reserved == 0
    assert not src._alloc.refcount
    if arch == "gemma3-12b":
        # the ring wrapped: all 4 ring columns ride the payload, and the
        # global layer's pages by their own columns
        assert state.position > 64 and state.cols_swa == [0, 1, 2, 3]
        assert state.cols == list(range(len(LONG) // 16 + 1))
        assert src._alloc_swa.n_free == src.num_blocks_swa
    if arch == "rwkv6-7b":
        assert state.cols == [] and state.slot_state
    assert dst.import_state(state)
    out = dst.run()
    assert len(out) == 1 and out[0] is req
    assert req.generated == _unmoved(arch)
    assert dst.stats["prefill_calls"] == 0 and dst.stats["imported"] == 1
    assert src.stats["exported"] == 1
    assert dst._alloc.n_free == dst.num_blocks


def test_migration_preserves_rep_penalty_state():
    kw = dict(max_new=MAX_NEW, rep_penalty=1.3)
    src, dst = _engine(), _engine()
    req = TE.Request(1, list(PROMPT), **kw)
    state = _export_mid_decode(src, req)
    assert dst.import_state(state)
    assert dst.run()[0].generated == _unmoved(rep_penalty=1.3)


@pytest.mark.parametrize("fault", ["flipped_byte", "checksum_lie"])
def test_import_rejects_a_corrupt_payload_untouched(fault):
    src, dst = _engine("gemma3-12b"), _engine("gemma3-12b")
    dst.submit(TE.Request(9, list(PROMPT), max_new=30))
    dst.tick()                       # the destination holds live pages
    before = _snapshot(dst)
    state = _export_mid_decode(src, TE.Request(2, list(LONG),
                                               max_new=MAX_NEW), ticks=4)
    if fault == "flipped_byte":
        _flip_payload(state)
    else:
        state.checksum ^= 1
    assert not dst.import_state(state)
    assert dst.stats["import_rejects"] == 1 and dst.n_active == 1
    after = _snapshot(dst)
    assert all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
    assert before[1:] == after[1:]


def test_import_refuses_fingerprint_mismatch():
    src, other = _engine(), _engine(cache_len=96)
    state = _export_mid_decode(src, TE.Request(4, list(PROMPT),
                                               max_new=MAX_NEW), ticks=3)
    assert not other.import_state(state)
    assert other.stats["import_rejects"] == 0 and other.n_active == 0


def test_import_dedups_resident_prefix_pages():
    src = _engine()
    req = TE.Request(5, list(PROMPT), max_new=MAX_NEW)
    state = _export_mid_decode(src, req, ticks=3)
    dst = _engine(hold_pages=8)
    dst.submit(TE.Request(6, list(PROMPT), max_new=2))
    dst.run()
    assert dst.import_state(state)
    assert dst.stats["deduped_pages"] >= 2
    assert dst.run()[-1].generated == _unmoved()


def test_export_copies_never_alias_the_pools():
    src = _engine("gemma3-12b")
    req = TE.Request(1, list(LONG), max_new=MAX_NEW)
    state = _export_mid_decode(src, req, ticks=3)
    kept = copy.deepcopy(state.pool)
    src.submit(TE.Request(2, list(PROMPT[::-1]), max_new=6))
    src.run()                        # reuses and scrubs the same pages
    for key, arr in state.pool.items():
        np.testing.assert_array_equal(arr, kept[key])


@pytest.mark.parametrize("arch", ["tiny", "gemma3-12b"])
def test_resume_tokens_prefill_as_one_prompt(arch):
    ref = _unmoved(arch)
    eng = _engine(arch)
    req = TE.Request(7, list(_prompt(arch)), max_new=MAX_NEW,
                     resume_tokens=ref[:5])
    eng.submit(req)
    out = eng.run()
    assert out[0].generated == ref and req.resume_tokens is None
    assert eng.stats["resumed_tokens"] == 5


# ---------------------------------------------------------------------------
# drain / preemption
# ---------------------------------------------------------------------------

def test_drain_returns_admission_order_and_empties_the_engine():
    eng = _engine("gemma3-12b", slots=2)
    reqs = [TE.Request(i, list(PROMPT[:10 + i]), max_new=20)
            for i in range(4)]
    for r in reqs[:2]:
        eng.submit(r)
    eng.tick()
    eng.tick()
    reqs[0].max_new = 3              # finish slot 0 early: slot recycles
    eng.run(max_ticks=2)
    eng.submit(reqs[2])
    eng.submit(reqs[3])
    eng.tick()                       # reqs[2] admitted into slot 0
    out = eng.drain_requests()
    assert [r.req_id for r in out] == [1, 2, 3]
    for r in out:
        assert r.generated == [] and r.pending == -1 and not r.done
        assert r.prefix_digests == eng.prefix_digests(r.prompt)
    assert eng.n_active == 0 and eng.queue == []
    assert eng._alloc.n_free == eng.num_blocks and eng._alloc.reserved == 0
    assert eng._alloc_swa.n_free == eng.num_blocks_swa
    assert eng.pending_tokens == 0 and eng.occupancy["free_slots"] == 2


def test_preempt_newest_takes_the_queue_tail_then_the_last_admitted():
    eng = _engine(slots=2)
    reqs = [TE.Request(i, list(PROMPT), max_new=8) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.tick()
    assert eng.preempt_newest() is reqs[2]       # queued, holds no page
    assert eng.preempt_newest() is reqs[1]       # admitted last
    assert eng.stats["preempted"] == 2 and eng.n_active == 1
    assert eng.admitted_requests() == [reqs[0]]
    assert eng.preempt_newest() is reqs[0] and eng.preempt_newest() is None


def test_blocks_and_bytes_accessors():
    eng = _engine("gemma3-12b")
    _, _, cfg = _model("gemma3-12b")
    assert eng.blocks_needed(90, 12) == -(-102 // 16)
    # one page of each kind: k and v of one layer, and the positions
    kv = 2 * 16 * cfg.n_kv_heads * cfg.head_dim * 2 + 16 * 4
    assert eng.page_bytes == eng.page_bytes_swa == kv
    assert eng.prefill_calls_for(LONG) == -(-90 // 8)
    assert eng.shared_prefix_pages(LONG) == 0 and not eng._can_share
    assert eng.registry_digests() == frozenset()


# ---------------------------------------------------------------------------
# against the JAX package: the payload's structure and checksum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tiny", "gemma3-12b"])
def test_request_state_structure_matches_jax(arch):
    jp, _, cfg = _model(arch)
    jeng = JE.ServingEngine(jp, cfg, slots=2, cache_len=128, chunk=8,
                            paged=True, page_size=16)
    teng = _engine(arch)
    prompt = _prompt(arch)
    js = _export_mid_decode(jeng, JE.Request(1, list(prompt), max_new=MAX_NEW))
    ts = _export_mid_decode(teng, TE.Request(1, list(prompt), max_new=MAX_NEW))
    assert (ts.cols, ts.cols_swa, ts.position, ts.digests) == (
        js.cols, js.cols_swa, js.position, js.digests)
    assert ts.payload_bytes == js.payload_bytes
    assert sorted(ts.pool) == sorted(js.pool)
    assert sorted(ts.slot_state) == sorted(js.slot_state)
    for key, arr in ts.pool.items():
        ja = np.asarray(js.pool[key])
        assert arr.shape == ja.shape and arr.nbytes == ja.nbytes, key
        if key.endswith("/pos"):     # positions are data movement
            np.testing.assert_array_equal(arr, ja, err_msg=key)
        else:
            assert arr.dtype == np.uint16 and ja.dtype.name == "bfloat16"


def test_state_checksum_matches_jax_on_equal_bits():
    rng = np.random.RandomState(0)
    bits = rng.randint(0, 1 << 16, (2, 3, 16, 4)).astype(np.uint16)
    pos = rng.randint(-1, 50, (2, 3, 16)).astype(np.int32)
    h = rng.standard_normal((2, 5)).astype(np.float32)
    states = []
    for E, k_arr in ((JE, bits.view(jnp.bfloat16)), (TE, bits)):
        req = E.Request(3, [5, 6, 7], max_new=4, generated=[9, 10],
                        pending=11)
        states.append(E.RequestState(
            req=req, position=5, fingerprint=(), cols=[0, 1], cols_swa=[],
            pool={"stack/0/k": k_arr, "stack/0/pos": pos},
            slot_state={"prefix/0/h": h}, digests=[], checksum=0,
            payload_bytes=0))
    js, ts = states
    assert TE.state_checksum(ts) == JE.state_checksum(js)
    _flip_payload(ts)
    assert TE.state_checksum(ts) != JE.state_checksum(js)
