"""The port's copy of the paper's planning plane — DAG IR, workload
descriptors, decomposer, scheduler, perf model, pipeline estimates, DHT,
broker and the DHT-backed data provider (``repro_torch.core``,
``repro_torch.data.synthetic``) — against ``repro.core`` on the same
inputs.

These modules are pure Python and numpy in both packages, so every
output is held EQUAL to JAX's: DAG JSON, FLOPs and bytes, partitions,
schedules and their loads, Eq. 1-4 estimates, broker events and
assignments after churn (the same seeded numpy RNG), DHT owners and
contents, and the data batches (bit for bit).  Each story runs once per
package through the same code below, over the port's configs of
gpt3-24l, qwen3-8b, rwkv6-7b and jamba-1.5-large.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cpu import one_torch_thread  # noqa: E402,F401

import repro.configs as JCfg  # noqa: E402
import repro.core.broker as Jbroker  # noqa: E402
import repro.core.dag as Jdag  # noqa: E402
import repro.core.decomposer as Jdec  # noqa: E402
import repro.core.dht as Jdht  # noqa: E402
import repro.core.perfmodel as Jpm  # noqa: E402
import repro.core.pipeline as Jpipe  # noqa: E402
import repro.core.scheduler as Jsched  # noqa: E402
import repro.core.workload as Jwl  # noqa: E402
import repro.data.synthetic as Jdata  # noqa: E402
import repro_torch.configs as TCfg  # noqa: E402
import repro_torch.core.broker as Tbroker  # noqa: E402
import repro_torch.core.dag as Tdag  # noqa: E402
import repro_torch.core.decomposer as Tdec  # noqa: E402
import repro_torch.core.dht as Tdht  # noqa: E402
import repro_torch.core.perfmodel as Tpm  # noqa: E402
import repro_torch.core.pipeline as Tpipe  # noqa: E402
import repro_torch.core.scheduler as Tsched  # noqa: E402
import repro_torch.core.workload as Twl  # noqa: E402
import repro_torch.data.synthetic as Tdata  # noqa: E402

JAX = types.SimpleNamespace(cfg=JCfg, broker=Jbroker, dag=Jdag, dec=Jdec,
                            dht=Jdht, pm=Jpm, pipe=Jpipe, sched=Jsched,
                            wl=Jwl, data=Jdata)
PORT = types.SimpleNamespace(cfg=TCfg, broker=Tbroker, dag=Tdag, dec=Tdec,
                             dht=Tdht, pm=Tpm, pipe=Tpipe, sched=Tsched,
                             wl=Twl, data=Tdata)
ARCHS = ["gpt3-24l", "qwen3-8b", "rwkv6-7b", "jamba-1.5-large-398b"]
FLEET = [("rtx3080", 4), ("rtx4090", 2), ("rtx4080", 2)]


def both(story, *args):
    """Run ``story`` on each package; the two results must be equal."""
    got, exp = story(PORT, *args), story(JAX, *args)
    assert got == exp
    return got


def _dag(M, arch, *, full=True, batch=2, seq=4096, kind="train"):
    cfg = (M.cfg.get_config if full else M.cfg.get_smoke_config)(arch)
    return M.dag.build_model_dag(cfg, batch=batch, seq=seq, kind=kind)


def _sched(s):
    return (sorted(s.assignment.items()), sorted(s.loads.items()),
            s.feasible, s.makespan)


# ---------------------------------------------------------------------------
# DAG IR and workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "inference"])
@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dag_json_equals_jax(arch, full, kind):
    def story(M):
        dag = _dag(M, arch, full=full, batch=2, seq=256, kind=kind)
        back = M.dag.DAG.from_json(dag.to_json())
        assert back.to_json() == dag.to_json()
        return (dag.to_json(), dag.total_flops(), dag.total_param_bytes(),
                dag.edges())
    both(story)


@pytest.mark.parametrize("arch", ARCHS)
def test_workloads_equal_jax(arch):
    def story(M):
        cfg = M.cfg.get_config(arch)
        out = [sorted(M.wl.block_workloads(cfg, batch=2, seq=4096).items()),
               sorted(M.wl.block_workloads(cfg, batch=8, seq=1,
                                           kv_cache_len=1024).items())]
        for kind in ("train", "prefill", "decode"):
            out.append(M.wl.model_flops(cfg, batch=2, seq=4096, kind=kind,
                                        kv_cache_len=1024 * (kind == "decode")))
            out.append(M.wl.step_flops(cfg, batch=2, seq=4096, kind=kind))
            out.append(M.wl.analytic_hbm_bytes(cfg, batch=2, seq=4096,
                                               kind=kind))
        out.append(M.wl.cache_bytes(cfg, batch=8, cache_len=1024))
        out.append(M.wl.model_flops_6nd(cfg, tokens=8192))
        return out
    both(story)


def test_dag_refuses_what_jax_refuses():
    for M in (PORT, JAX):
        dag = M.dag.DAG()
        with pytest.raises(AssertionError):
            dag.add(M.dag.OpNode("a", "x", args=("missing",)))
        with pytest.raises(AssertionError):
            M.dag.OpNode("b", "x", op_type="bogus")


# ---------------------------------------------------------------------------
# Decomposer, scheduler, perf model, pipeline (Eqs. 1-4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 4, 7])
@pytest.mark.parametrize("arch", ARCHS)
def test_decomposers_equal_jax(arch, k):
    def story(M):
        dag = _dag(M, arch)
        parts = M.dec.decompose_contiguous(dag, k)
        fast = M.dec.decompose_contiguous(
            dag, k, speeds=[3.0, 1.0, 2.0, 1.5, 1.0, 1.0, 0.5][:k])
        by_param = M.dec.decompose_contiguous(dag, k,
                                              weight=lambda n: n.param_bytes)
        mem = M.dec.decompose_by_memory(dag, [dag.total_param_bytes() / k])
        assignment = M.dec.assignment_of(parts)
        attrs = dag.subgraph_attrs(assignment)
        return (parts, fast, by_param, mem, M.dec.part_stats(dag, parts),
                dag.cut_bytes(assignment),
                {c: {key: sorted(v) if isinstance(v, (set, list)) else v
                     for key, v in g.items()} for c, g in attrs.items()})
    both(story)


@pytest.mark.parametrize("arch", ARCHS)
def test_schedulers_equal_jax(arch):
    def story(M):
        dag = _dag(M, arch)
        link = M.pm.LINK_REGIMES["wan_1gbps"]
        nodes = M.pm.make_fleet(FLEET, link)
        tasks = M.sched.tasks_from_parts(dag, M.dec.decompose_contiguous(dag, 6))
        out = [[dataclasses.astuple(t) for t in tasks],
               _sched(M.sched.schedule_loadbalance(tasks, nodes)),
               _sched(M.sched.schedule_pipeline(tasks, nodes))]
        big = M.pm.make_fleet([("h100", 3), ("a100", 2)], link)
        out.append(_sched(M.sched.schedule_loadbalance(
            tasks, big, init_loads={0: 0.5, 3: 0.1},
            init_used={1: [30e9, 0.0, 0.0]})))
        rng = np.random.RandomState(5)
        rand = [M.sched.Task(i, (), flops=float(rng.randint(1, 1000)) * 1e9,
                             gpu_bytes=float(rng.randint(1, 4)) * 1e9)
                for i in range(17)]
        out.append(_sched(M.sched.schedule_loadbalance(rand, nodes)))
        return out
    both(story)


@pytest.mark.parametrize("arch", ARCHS)
def test_perf_model_and_pipeline_estimates_equal_jax(arch):
    def story(M):
        dag = _dag(M, arch, kind="inference")
        link = M.pm.LINK_REGIMES["wan_1gbps"]
        fleet = M.pm.make_fleet(FLEET, link)
        pm = M.pm.PerfModel(fleet)
        parts = M.dec.decompose_contiguous(dag, 4)
        assignment = M.dec.assignment_of(parts)
        out = [pm.subgraph_time(dag, p, i, assignment)
               for i, p in enumerate(parts)]
        node = dag[dag.topo_order()[3]]
        out.append(pm.op_time(node, 1, {node.args[0]: 0},
                              {node.args[0]: 1e8}))
        out.append(sorted(M.pipe.estimate_system(
            dag, pm, [n.node_id for n in fleet[:5]], n_batches=64,
            batch_size=2).items()))
        st = M.pipe.stage_times(dag, parts, pm, [0, 4, 6, 2])
        out += [st.compute, st.receive, M.pipe.latency_eq3(st),
                M.pipe.pipelined_eq4(st, 9), M.pipe.simulate_pipeline(st, 9),
                M.pipe.bubble_fraction(st, 9),
                M.pipe.throughput_eq4(st, 9, 2)]
        h100 = M.pm.PerfModel([M.pm.CompNode(0, M.pm.DEVICE_CATALOG["h100"],
                                             M.pm.LINK_REGIMES["nvlink"])])
        out.append(h100.subgraph_time(dag, dag.topo_order(), 0))
        out.append(M.pm.fit_lambda([1e12, 2e12, 5e12], [0.02, 0.041, 0.1],
                                   59.5e12))
        out.append(M.pm.LinkSpec.from_bandwidth(125e6, 0.02).time(125e6))
        return out
    both(story)


# ---------------------------------------------------------------------------
# Broker: registration, job intake, failover, seeded churn
# ---------------------------------------------------------------------------

def _events(b):
    return [(e.t, e.kind, e.node_id, e.detail) for e in b.events]


@pytest.mark.parametrize("arch", ARCHS)
def test_broker_story_equals_jax(arch):
    """The decentralized example's broker steps, then a failure with a
    backup drafted, then seeded heartbeat churn until the backups run
    out: every event, assignment and load equals JAX's."""
    def story(M):
        broker = M.broker.Broker(backup_fraction=0.25, seed=0)
        fleet = M.pm.make_fleet(FLEET, M.pm.LINK_REGIMES["wan_1gbps"])
        for node in fleet:
            node.reliability = 0.9
            broker.register(node)
        sched = broker.submit_job(_dag(M, arch), n_parts=4)
        out = [sorted(broker.active), sorted(broker.backup), _sched(sched),
               sorted((t, dataclasses.astuple(v))
                      for t, v in broker.tasks.items())]
        broker.quit(sched.assignment[0], graceful=False)
        out.append(_sched(broker.schedule))
        broker.mark_done(1)
        out.append(broker.run_sim(rounds=30))
        out += [_events(broker), _sched(broker.schedule),
                sorted(broker.speeds.items()), broker.dht.nodes]
        return out
    got = both(story)
    assert any(e[1] == "replace" for e in got[-4])


@pytest.mark.parametrize("seed", [3, 11, 42])
def test_broker_failover_scenarios_equal_jax(seed):
    """The scenarios of tests/test_broker_failover.py and test_core.py
    (explicit pools, empty-backup rebalance, dead standbys) on both."""
    def story(M):
        link = M.pm.LINK_REGIMES["wan_1gbps"]
        dag = _dag(M, "qwen3-8b")
        out = []
        b = M.broker.Broker(seed=seed)
        for dev, pool in [("rtx3080", "active"), ("a100", "active"),
                          ("rtx3080", "backup"), ("a100", "backup")]:
            b.register(M.pm.CompNode(-1, M.pm.DEVICE_CATALOG[dev], link), pool)
        b.submit_job(dag, n_parts=2)
        b.quit(1, graceful=False)
        out += [_events(b), _sched(b.schedule)]
        b = M.broker.Broker(backup_fraction=0.0, seed=seed)
        for _ in range(4):
            b.register(M.pm.CompNode(-1, M.pm.DEVICE_CATALOG["rtx3080"],
                                     link), "active")
        b.submit_job(dag, n_parts=4)
        b.quit(b.schedule.assignment[0], graceful=False)
        out += [_events(b), _sched(b.schedule)]
        b = M.broker.Broker(backup_fraction=0.25, seed=seed)
        for node in M.pm.make_fleet([("rtx3080", 12), ("rtx4090", 12)], link):
            node.reliability = 0.9
            b.register(node)
        b.submit_job(dag, n_parts=8)
        out += [b.run_sim(rounds=15), _events(b), _sched(b.schedule)]
        with pytest.raises(ValueError):
            b.register(M.pm.CompNode(0, M.pm.DEVICE_CATALOG["h100"], link),
                       pool="spare")
        return out
    both(story)


# ---------------------------------------------------------------------------
# DHT and the DHT-backed data provider (§3.9)
# ---------------------------------------------------------------------------

def test_dht_equals_jax_through_churn():
    def story(M):
        dht = M.dht.DHT(range(8), replication=3)
        out = [[dht.put(f"key{i}", i) for i in range(50)]]
        dht.leave(3)
        out.append([dht.get(f"key{i}") for i in range(50)])
        out.append(dht.rebalance())
        dht.leave(5)
        dht.leave(0)
        dht.join(99)
        out.append(dht.rebalance())
        out += [[dht.owners(f"key{i}") for i in range(50)],
                [dht.get(f"key{i}") for i in range(50)], dht.nodes,
                {n: sorted(s) for n, s in dht._stores.items()}]
        return out
    got = both(story)
    assert got[-3] == list(range(50))


@pytest.mark.parametrize("arch", ["gpt3-24l", "qwen3-8b"])
def test_data_provider_equals_jax(arch):
    """Published batches land on the same DHT owners with the same numpy
    contents; fetch gives them back as tensors (and a cache miss
    regenerates the same batch)."""
    shape = types.SimpleNamespace(seq_len=64, global_batch=3)
    lm_t = Tdata.loader_for(TCfg.get_config(arch), shape, noise=0.05, seed=4,
                            device="cpu")
    lm_j = Jdata.loader_for(JCfg.get_config(arch), shape, noise=0.05, seed=4)
    dht_t, dht_j = Tdht.DHT(range(5)), Jdht.DHT(range(5))
    prov_t = Tdata.DataProvider(lm_t, dht_t)
    prov_j = Jdata.DataProvider(lm_j, dht_j)
    assert prov_t.publish(2, 3) == prov_j.publish(2, 3) == 3
    assert {n: sorted(s) for n, s in dht_t._stores.items()} == \
        {n: sorted(s) for n, s in dht_j._stores.items()}
    for step in (2, 3, 4, 9):                 # 9 was never published
        got, exp = prov_t.fetch(step), prov_j.fetch(step)
        assert sorted(got) == sorted(exp) == ["labels", "tokens"]
        for k in got:
            assert got[k].dtype == torch.int32 and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(exp[k]))
    key = "data/4/3"
    assert dht_t.owners(key) == dht_j.owners(key)
    stored = dht_t.get(key)
    assert isinstance(stored["tokens"], np.ndarray)


def test_loader_for_needs_an_explicit_cpu_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    shape = types.SimpleNamespace(seq_len=8, global_batch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Tdata.loader_for(TCfg.get_smoke_config("gpt3-24l"), shape)
