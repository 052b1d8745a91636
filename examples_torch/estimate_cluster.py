"""Cluster estimator: the paper's §4 analysis as a tool.  Describe a
fleet and a model; get pipeline latency, steady-state throughput, cost
efficiency and compression what-ifs.  The PyTorch port of
``examples/estimate_cluster.py``: analytic, so it prints what the JAX
example prints, line for line; ``--device`` is checked as in the other
examples, and nothing runs on it.

    PYTHONPATH=src python examples_torch/estimate_cluster.py \
        --fleet rtx3080:50 --model bert-large --link wan_1gbps
    PYTHONPATH=src python examples_torch/estimate_cluster.py \
        --fleet h100:4 --model gpt3-24l --link nvlink --device cpu
"""
import argparse

from repro_torch import resolve_device
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core.compression import CompressionSpec
from repro_torch.core.dag import build_model_dag
from repro_torch.core.decomposer import decompose_contiguous, part_stats
from repro_torch.core.perfmodel import (DEVICE_CATALOG, LINK_REGIMES,
                                        PerfModel, make_fleet)
from repro_torch.core.pipeline import estimate_system


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleet", default="rtx3080:50",
                    help="comma list of device:count")
    ap.add_argument("--model", choices=list(ALL_ARCHS), default="bert-large")
    ap.add_argument("--link", choices=list(LINK_REGIMES), default="wan_1gbps")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--n-batches", type=int, default=512)
    ap.add_argument("--lam", type=float, default=0.75,
                    help="λ_p scaling-down factor (§3.7)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args()
    resolve_device(args.device)

    spec = [(d, int(n)) for d, n in
            (kv.split(":") for kv in args.fleet.split(","))]
    cfg = get_config(args.model)
    dag = build_model_dag(cfg, batch=args.batch, seq=args.seq,
                          kind="inference")
    nodes = make_fleet(spec, LINK_REGIMES[args.link], lam=args.lam)
    pm = PerfModel(nodes)
    est = estimate_system(dag, pm, [n.node_id for n in nodes],
                          n_batches=args.n_batches, batch_size=args.batch)
    price = sum(DEVICE_CATALOG[d].price_usd * n for d, n in spec)

    print(f"model {cfg.name}: {dag.total_flops()/1e12:.2f} TFLOP/batch, "
          f"{dag.total_param_bytes()/1e9:.2f} GB params")
    print(f"fleet {args.fleet} over {args.link} (λ={args.lam})")
    print(f"  stages                : {est['n_stages']:.0f}")
    print(f"  single-batch latency  : {est['latency_s']:.3f} s   (Eq. 3)")
    print(f"  {args.n_batches} batches pipelined : "
          f"{est['pipelined_s_eq4']:.2f} s   (Eq. 4; sim "
          f"{est['pipelined_s_sim']:.2f} s)")
    print(f"  throughput            : {est['throughput_samples_s']:.2f} "
          f"samples/s")
    print(f"  pipeline bubble       : {est['bubble_fraction']*100:.1f} %")
    if price:
        print(f"  fleet price           : ${price:,.0f}  -> "
              f"{est['throughput_samples_s']/price*1000:.2f} "
              f"samples/s/k$")

    # compression what-ifs on the bottleneck link (activation traffic)
    act = max(s["out_bytes"] for s in part_stats(dag, decompose_contiguous(
        dag, len(nodes))))
    link = LINK_REGIMES[args.link]
    print("  activation transfer per cut "
          f"({act/1e6:.1f} MB raw):")
    for c in [CompressionSpec("none"), CompressionSpec("int8"),
              CompressionSpec("topk", ratio=0.01)]:
        t = link.time(c.bytes(int(act / 4), raw_bytes=act))
        print(f"    {c.kind:8s}: {t*1e3:9.1f} ms/hop")


if __name__ == "__main__":
    main()
