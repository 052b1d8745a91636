"""The port's ``FleetRouter`` and ``FaultPlan`` (``repro_torch.serve.
router`` / ``faults``) over the port's engines: the scenarios of the JAX
package's ``test_migration.py`` router section and ``test_faults.py``,
and, on the same seeded fault plans, the JAX router's decisions.

The router decides from token counts and pool counters, never from
token values, so on one seeded plan (every fault kind, heartbeat
failures, standbys) the port's and the JAX package's routers make the
same placements, evict the same victims, count the same events and end
every request with the same outcome at the same tick.  Greedy tokens of
completed requests are held to JAX ``generate()`` (never to a JAX engine
run, which strays under parallel load).  Everything runs in float32
activations (the embedding upcast, every cache built in float32), where
the packages differ by summation order only: in bfloat16 the CPU matmuls
of XLA and PyTorch round differently, and over 40 greedy tokens of the
narrow model one request's tokens part.
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
from repro.models.transformer import init_params as jax_init  # noqa: E402
from repro.serve import engine as JE  # noqa: E402
from repro.serve import faults as JF  # noqa: E402
from repro.serve import router as JR  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.perfmodel import LINK_REGIMES  # noqa: E402
from repro_torch.serve import engine as TE  # noqa: E402
from repro_torch.serve import faults as TF  # noqa: E402
from repro_torch.serve import router as TR  # noqa: E402

_cache: dict = {}


@pytest.fixture(autouse=True)
def f32_caches(monkeypatch):
    monkeypatch.setattr(JE, "init_cache",
                        partial(JE.init_cache, dtype=jnp.float32))
    monkeypatch.setattr(TE, "init_cache",
                        partial(TE.init_cache, dtype=torch.float32))


def _model(arch="tiny"):
    """(JAX params, port params, cfg) in float32 activations."""
    if arch not in _cache:
        if arch == "tiny":
            cfg = dataclasses.replace(jax_smoke("gpt3-24l"), vocab_size=128,
                                      d_model=128, d_ff=256, n_heads=4,
                                      n_kv_heads=4, head_dim=32)
        else:
            cfg = jax_smoke(arch)
        jp = jax_init(jax.random.PRNGKey(0), cfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        _cache[arch] = (dict(jp, embed=jp["embed"].astype(jnp.float32)),
                        dict(tp, embed=tp["embed"].float()), cfg)
    return _cache[arch]


def _engine(arch="tiny", slots=4, cache_len=64, **kw):
    _, tp, cfg = _model(arch)
    return TE.ServingEngine(tp, cfg, slots=slots, cache_len=cache_len,
                            chunk=8, paged=True, page_size=16,
                            use_kernel=True, device="cpu", **kw)


def _jax_engine(arch="tiny", slots=4, cache_len=64, **kw):
    jp, _, cfg = _model(arch)
    return JE.ServingEngine(jp, cfg, slots=slots, cache_len=cache_len,
                            chunk=8, paged=True, page_size=16, **kw)


def _refs(reqs, arch="tiny"):
    """JAX ``generate()``'s greedy tokens of each request: one batched
    call per prompt length, to the largest ``max_new`` (a greedy run's
    prefix is the shorter run)."""
    jp, _, cfg = _model(arch)
    out = {}
    for n in sorted({len(r.prompt) for r in reqs}):
        group = [r for r in reqs if len(r.prompt) == n]
        toks = np.asarray(JE.generate(
            jp, cfg, jnp.asarray([r.prompt for r in group], jnp.int32),
            max_new=max(r.max_new for r in group)))[:, n:]
        for r, t in zip(group, toks):
            out[r.req_id] = t[:r.max_new].tolist()
    return out


def _check_tokens(res, reqs, arch="tiny"):
    refs = _refs(reqs, arch)
    for r in res.completed:
        assert r.generated == refs[r.req_id], r.req_id


def _reqs(E, n=3, max_new=10):
    return [E.Request(i, [3 + i] * 20, max_new=max_new) for i in range(n)]


def _straggle_fleet(plan, migration="auto"):
    return TR.FleetRouter([(_engine(), "rtx4090"), (_engine(), "rtx3080")],
                          fault_plan=plan, migration=migration)


def _run(router, reqs, **kw):
    for r in reqs:
        router.submit(r)
    return router.run(max_ticks=400, **kw)


def test_soft_drain_migrates_with_zero_retries():
    plan = TF.FaultPlan([TF.Fault(2, 0, "straggle", factor=8.0,
                                  duration=10)])
    router = _straggle_fleet(plan)
    res = _run(router, _reqs(TE))
    assert router.stats["soft_drains"] >= 1
    assert router.stats["migrations"] >= 1
    moved = [r for r in res.completed if len(router.placements[r.req_id]) > 1]
    assert moved and all(r.retries == 0 for r in moved)
    _check_tokens(res, res.completed)


def test_migration_never_restores_requeue():
    plan = TF.FaultPlan([TF.Fault(2, 0, "straggle", factor=8.0,
                                  duration=10)])
    router = _straggle_fleet(plan, migration="never")
    res = _run(router, _reqs(TE))
    assert router.stats["migrations"] == 0
    assert [r for r in res.completed if r.retries > 0]
    _check_tokens(res, res.completed)


def test_corrupt_transfer_rejected_victim_bitwise():
    plan = TF.FaultPlan([TF.Fault(0, 0, "corrupt", duration=300),
                         TF.Fault(2, 0, "straggle", factor=8.0,
                                  duration=10)])
    router = _straggle_fleet(plan)
    res = _run(router, _reqs(TE))
    assert router.stats["corrupt_faults"] == 1
    assert router.stats["migrations"] == 0
    assert router.stats["migration_fallbacks"] >= 1
    assert sum(r.engine.stats["import_rejects"]
               for r in router.replicas) >= 1
    assert sorted(r.req_id for r in res.completed) == [0, 1, 2]
    _check_tokens(res, res.completed)


def test_crash_snapshot_restores_decoded_tokens():
    plan = TF.FaultPlan([TF.Fault(14, 0, "crash")])
    router = TR.FleetRouter([(_engine(cache_len=96), "rtx4090")],
                            standby=[(_engine(cache_len=96), "rtx4090")],
                            fault_plan=plan, snapshot_every=4)
    res = _run(router, _reqs(TE, n=2, max_new=40))
    assert len(res.completed) == 2
    assert router.stats["failures"] == 1
    assert router.stats["replacements"] == 1
    assert router.stats["snapshot_restores"] >= 1
    assert sum(r.engine.stats["resumed_tokens"]
               for r in router.replicas) >= 1
    _check_tokens(res, res.completed)


def test_rebalance_migrates_newest_off_loaded_replica():
    e0, e1 = _engine(cache_len=96), _engine(cache_len=96)
    router = TR.FleetRouter([(e0, "rtx4090"), (e1, "rtx4090")],
                            rebalance_every=2, rebalance_factor=1.5)
    for r in _reqs(TE, max_new=16):
        e0.submit(r)                 # all the load on replica 0
    res = router.run(max_ticks=400)
    assert len(res.completed) == 3
    assert router.stats["rebalances"] >= 1
    assert router.stats["migrations"] >= 1
    _check_tokens(res, res.completed)


@pytest.mark.parametrize("link,migrates", [("lan_10gbps", True),
                                           ("wan_10mbps", False)])
def test_migrate_cost_decision_follows_link_speed(link, migrates):
    plan = TF.FaultPlan([TF.Fault(2, 0, "straggle", factor=8.0,
                                  duration=10)])
    router = TR.FleetRouter(
        [(_engine(), TR.sim_node(d, link=LINK_REGIMES[link]))
         for d in ("rtx4090", "rtx3080")], fault_plan=plan)
    res = _run(router, _reqs(TE))
    assert (router.stats["migrations"] >= 1) == migrates
    assert sorted(r.req_id for r in res.completed) == [0, 1, 2]
    _check_tokens(res, res.completed)


def test_partition_heals_and_pool_pressure_expires():
    plan = TF.FaultPlan([TF.Fault(1, 0, "partition", duration=3),
                         TF.Fault(1, 1, "pool_pressure", pages=3,
                                  duration=4)])
    router = _straggle_fleet(plan)
    res = _run(router, _reqs(TE, n=4))
    assert router.stats["partitions"] == 1
    assert router.stats["partition_heals"] == 1
    assert router.stats["pool_pressure"] == 1
    assert all(r.engine._alloc.withheld == 0 for r in router.replicas)
    assert res.ok and all(r.retries == 0 for r in res.completed)


def _trace(router, res):
    """Everything the router decided: its counters, every dispatch and
    migration, and each request's outcome, retries and ticks."""
    engines = [r.engine for r in router.replicas] + [
        r.engine for r in router._standby.values()]
    keys = ("exported", "imported", "import_rejects", "imported_pages",
            "deduped_pages", "resumed_tokens", "preempted", "admitted",
            "prefill_calls", "decode_calls", "backpressure")
    return (dict(router.stats), dict(router.placements),
            {k: v for k, v in sorted(res.traces.items())},
            [[e.stats[k] for k in keys] for e in engines], res.ticks)


def test_router_decisions_match_jax_on_a_seeded_plan():
    """gemma3-12b's smoke model on two replicas of two device kinds and
    a standby, heartbeat failures, and the seeded plan of seed 11 (all
    five fault kinds: crash, straggle, partition, pool pressure,
    corrupt); migration on, snapshots every 4 ticks, rebalancing every
    5.  Prompts of whole chunks keep the JAX engines' compiles few.  The
    port's tokens equal a fault-free run of one port engine."""
    arch, seed = "gemma3-12b", 11
    runs = {}
    for name, E, F, R, eng in (("jax", JE, JF, JR, _jax_engine),
                               ("port", TE, TF, TR, _engine)):
        plan = F.FaultPlan.seeded(seed, ticks=24, replica_ids=[0, 1, 2],
                                  rate=0.08)
        nodes = [R.sim_node(d, reliability=0.97)
                 for d in ("rtx4090", "rtx3080", "rtx4090")]
        router = R.FleetRouter(
            [(eng(arch, cache_len=128), nodes[i]) for i in range(2)],
            standby=[(eng(arch, cache_len=128), nodes[2])], seed=seed,
            fault_plan=plan, snapshot_every=4, rebalance_every=5,
            rebalance_factor=2.0)
        rng = np.random.RandomState(seed)
        reqs = [E.Request(i, rng.randint(0, 128, int(rng.choice(
            [16, 40, 64]))).tolist(), max_new=int(rng.randint(4, 24)),
            max_retries=2) for i in range(8)]
        runs[name] = (router, reqs, _trace(router, _run(
            router, reqs, heartbeat_every=3)))
    jt, tt = runs["jax"][2], runs["port"][2]
    assert tt[0] == jt[0]            # every counter
    assert tt[1] == jt[1]            # every placement and migration
    assert tt[2] == jt[2]            # outcomes, retries, ticks
    assert tt[3] == jt[3] and tt[4] == jt[4]
    assert sum(tt[0][k] for k in ("failures", "soft_drains", "migrations",
                                  "partitions", "pool_pressure")) > 0
    assert tt[0]["migrations"] and tt[0]["snapshot_restores"]
    router, reqs, _ = runs["port"]
    assert all(r.outcome == "ok" for r in router.finished)
    plain = _engine(arch, cache_len=128)
    for r in reqs:
        plain.submit(TE.Request(r.req_id, list(r.prompt), max_new=r.max_new))
    ref = {r.req_id: r.generated for r in plain.run()}
    for r in router.finished:
        assert r.generated == ref[r.req_id], r.req_id
