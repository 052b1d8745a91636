"""The FusionAI showcase: decentralized pipeline training over a
heterogeneous consumer-GPU fleet — broker, DAG decomposition, scheduling,
FP/BP/Update execution with message passing, a mid-training node failure
with backup-pool replacement, and the SPMD pipeline mapping.  The
PyTorch port of ``examples/decentralized_pipeline.py``.

The JAX example forces 4 host devices for its ``shard_map`` pipeline;
here ``spmd_pipeline`` runs in 4 local gloo processes, one stage each,
on the same device as the rest (the card unless ``--device cpu``: the
four processes then share it).

    PYTHONPATH=src python examples_torch/decentralized_pipeline.py
    PYTHONPATH=src python examples_torch/decentralized_pipeline.py --device cpu
"""
import argparse
import dataclasses
import os
import socket
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.core.broker import Broker
from repro_torch.core.dag import build_model_dag
from repro_torch.core.decomposer import decompose_contiguous
from repro_torch.core.executor import LocalCluster, spmd_pipeline
from repro_torch.core.perfmodel import LINK_REGIMES, PerfModel, make_fleet
from repro_torch.core.pipeline import estimate_system
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM

N_STAGES, D, N_MICRO = 4, 32, 8


def _stage(rank, port, device, batch, out_path):
    """One stage of the pipeline: a process of its own."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=N_STAGES)
    try:
        dev = (torch.device("cpu") if device == "cpu" else
               torch.device("cuda", rank % torch.cuda.device_count()))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        mesh = make_host_mesh(N_STAGES, device=device)
        gen = torch.Generator(dev).manual_seed(1)
        stage_w = torch.randn(N_STAGES, D, D, generator=gen,
                              device=dev) * 0.2
        xs = torch.randn(N_MICRO, batch, D, generator=gen, device=dev)
        w = DTensor.from_local(stage_w[rank:rank + 1], mesh, [Shard(0)],
                               shape=stage_w.shape, stride=stage_w.stride())
        stats = {}
        out = spmd_pipeline(lambda w, x: torch.tanh(x @ w), w, xs, mesh,
                            axis="stage", stats=stats)
        ref = xs
        for i in range(N_STAGES):
            ref = torch.tanh(ref @ stage_w[i])
        err = float((out - ref).abs().max())
        if rank == N_STAGES - 1:
            torch.save({"err": err, "transport": stats["transport"]},
                       out_path)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = dataclasses.replace(get_smoke_config("gpt3-24l"), vocab_size=256)
    B, S = 4, 32
    dag = build_model_dag(cfg, batch=B, seq=S, kind="train")
    print(f"IR plane: {len(dag)} ops, {dag.total_flops()/1e9:.2f} GFLOP/step, "
          f"{dag.total_param_bytes()/1e6:.1f} MB params")

    # --- broker: register a heterogeneous fleet, schedule the job --------
    broker = Broker(backup_fraction=0.25, seed=0)
    fleet = make_fleet([("rtx3080", 4), ("rtx4090", 2), ("rtx4080", 2)],
                       LINK_REGIMES["wan_1gbps"])
    for node in fleet:
        node.reliability = 0.98
        broker.register(node)
    sched = broker.submit_job(dag, n_parts=3)
    print(f"broker: {len(broker.active)} active + {len(broker.backup)} backup"
          f" nodes; schedule makespan {sched.makespan*1e3:.1f} ms "
          f"(feasible={sched.feasible})")

    # --- execution plane: pipeline-parallel FP/BP/Update ------------------
    parts = decompose_contiguous(dag, 3)
    cluster = LocalCluster(dag, parts, cfg, 0, device=device)
    lm = SyntheticLM(SyntheticConfig(cfg.vocab_size, S, B, noise=0.05),
                     device=device)
    print(f"decentralized training (3 compnodes on {device}):")
    for step in range(8):
        batch = lm.batch(step)
        loss = cluster.train_step(batch["tokens"], batch["labels"], lr=3e-3)
        if step % 2 == 0:
            print(f"  step {step}: loss {loss:.4f}  "
                  f"(bus traffic {cluster.bus.total_bytes/1e6:.2f} MB)")

    # --- fault tolerance: kill a node mid-job, draft a backup -------------
    victim = sched.assignment[0]
    print(f"simulating failure of compnode {victim} ...")
    broker.quit(victim, graceful=False)
    repl = [e for e in broker.events if e.kind == "replace"]
    print(f"  broker drafted replacement: {repl[-1].detail if repl else 'n/a'}")
    assert all(nid in broker.active
               for nid in broker.schedule.assignment.values())
    print("  all tasks remapped to online nodes ✓")

    # --- analytic estimate for this exact job (§4) ------------------------
    pm = PerfModel(fleet)
    est = estimate_system(dag, pm, [n.node_id for n in fleet[:3]],
                          n_batches=64, batch_size=B)
    print(f"analytic: latency {est['latency_s']*1e3:.1f} ms, pipelined x64 "
          f"batches {est['pipelined_s_eq4']:.2f} s, bubble "
          f"{est['bubble_fraction']*100:.0f}%")

    # --- production mapping: spmd_pipeline over 4 gloo processes ---------
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "pipeline.pt")
        mp.spawn(_stage, args=(_free_port(), device.type, B, out_path),
                 nprocs=N_STAGES, join=True)
        res = torch.load(out_path)
    print(f"spmd_pipeline over {N_STAGES} gloo processes on {device} "
          f"(point-to-point GPipe, {res['transport']}): max err vs "
          f"sequential {res['err']:.2e}")
    assert res["err"] <= 1e-5, res


if __name__ == "__main__":
    main()
