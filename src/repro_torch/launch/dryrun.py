"""Multi-pod dry-run of the port: prove the distribution config is
coherent — ``repro.launch.dryrun`` on DTensor.

For every (architecture × input shape × mesh): the step's inputs are
fake tensors (``launch/specs.py``) laid out as DTensors over a
``DeviceMesh`` of a fake process group (``launch/mesh.py``,
``launch/shardings.py``), and the step itself (``make_train_step``,
``make_prefill_step``, ``make_decode_step`` or the serving engine's
``make_engine_step``) runs once on them under the sharding hints
(``models/hints.py``) — sharding propagation, redistributions and
collectives included, with no storage allocated and nothing moved.
Any sharding mismatch or op without a sharding rule fails here.
Recorded: per-chip argument / output bytes, the peak of live bytes, the
collectives by kind, the FLOPs, and the roofline terms with H100
constants (``launch/roofline.py``).

The mesh's process group is global state: run the dry-run in a process
of its own (``python -m repro_torch.launch.dryrun``).

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (ALL_ARCHS, INPUT_SHAPES, InputShape,
                                 baseline_pairs, get_config,
                                 shape_applicable)
from repro_torch.core.workload import (analytic_hbm_bytes, model_flops,
                                       model_flops_6nd, step_flops)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (axis_sizes, data_axes,
                                     make_production_mesh)
from repro_torch.launch.shardings import (arg_shardings, default_hint_rule,
                                          per_chip_bytes, shard_shape,
                                          to_placements)
from repro_torch.launch.specs import input_specs
from repro_torch.models.hints import from_local, wrap_with_hints
from repro_torch.optim.adamw import adamw
from repro_torch.serve.engine import (make_decode_step, make_engine_step,
                                      make_prefill_step)
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves, tree_map


def distribute(tree, shardings, mesh, *, requires_grad: bool = False):
    """Fake tensors -> DTensors over ``mesh`` under their sanitized specs:
    each rank's local shard is a fresh fake tensor of the shard shape, so
    nothing is copied or scattered."""
    def one(t, spec):
        local = torch.empty(shard_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device=t.device)
        d = from_local(local, mesh, to_placements(spec, mesh), t.shape)
        if requires_grad and t.is_floating_point():
            d.requires_grad_(True)
        return d
    return tree_map(one, tree, shardings)


def _shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def _tensor_bytes(tree) -> int:
    total = 0
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def build_step(arch: str, shape_name: str, mesh, *, microbatches: int = 1,
               kv_chunk: int = 1024, paged: bool = False,
               page_size: int = 16, use_kernel: bool = False,
               device: str = "cuda"):
    """Returns (step, args, spec, shardings): ``step(*args)`` runs the
    port's step for (arch, shape) on DTensor inputs under the hints; it
    must be called under ``spec["mode"]``.  ``paged=True`` (a decode
    shape) runs the continuous-batching ENGINE step (paged block pools,
    block table and per-slot sampling operands) instead of the plain
    dense decode step; ``use_kernel=True`` (paged, on cuda) runs the
    paged-decode and scan kernels' custom ops inside that step.  The
    flags are as ``run_one`` settles them."""
    spec = input_specs(arch, shape_name, paged=paged, page_size=page_size,
                       device=device)
    cfg, shape = spec["cfg"], spec["shape"]
    decode_tp = (shape.kind == "decode"
                 and os.environ.get("REPRO_DECODE_TP", "1") == "1")
    hint_rule = default_hint_rule(mesh, batch_size=shape.global_batch,
                                  decode_tp=decode_tp)
    sizes = axis_sizes(mesh)
    n_data = math.prod(sizes[a] for a in data_axes(mesh))
    moe_groups = n_data if shape.global_batch % n_data == 0 else 1
    moe_ep = os.environ.get("REPRO_MOE_EP", "1") == "1"
    sh = arg_shardings(spec, mesh, decode_tp=decode_tp)
    with spec["mode"]:
        params = distribute(spec["params"], sh["params"], mesh,
                            requires_grad=shape.kind == "train")
        if shape.kind == "train":
            optimizer = adamw(1e-4, state_bits=int(
                os.environ.get("REPRO_OPT_BITS", "32")))
            step = wrap_with_hints(
                make_train_step(cfg, optimizer, microbatches=microbatches,
                                remat=True, remat_policy=os.environ.get(
                                    "REPRO_REMAT_POLICY", "full")),
                mesh, hint_rule, moe_groups=moe_groups, moe_ep=moe_ep)
            args = (params,
                    distribute(spec["opt_state"], sh["opt_state"], mesh),
                    distribute(spec["batch"], sh["batch"], mesh))
            return step, args, spec, sh
        caches = distribute(spec["caches"], sh["caches"], mesh)
        positions = distribute(spec["positions"], sh["positions"], mesh)
        batch = distribute(spec["batch"], sh["batch"], mesh)
        extras = dict(moe_groups=1 if decode_tp else moe_groups,
                      moe_ep=not decode_tp and moe_ep)
        if not paged:
            fn = (make_prefill_step(cfg, kv_chunk=kv_chunk)
                  if shape.kind == "prefill"
                  else make_decode_step(cfg, kv_chunk=kv_chunk))
            step = wrap_with_hints(fn, mesh, hint_rule, **extras)
            return step, (params, caches, batch, positions), spec, sh
        # the serving-engine step itself; its sampling vectors are host
        # arrays (greedy rows: temperature 0, no penalty)
        fn = make_engine_step(cfg, kv_chunk=kv_chunk, paged=True,
                              use_kernel=use_kernel)
        step = wrap_with_hints(fn, mesh, hint_rule, **extras)
        B = shape.global_batch
        seen = distribute(spec["sampling"]["seen"], sh["sampling"]["seen"],
                          mesh)
        table = distribute(spec["table"], sh["table"], mesh)
        args = (params, caches, seen, batch["tokens"], positions, table,
                np.zeros((B, 2), np.uint32), np.zeros(B, np.float32),
                np.ones(B, np.float32), np.zeros(B, np.int32),
                np.ones(B, np.float32))
        return step, args, spec, sh


def trace(step, args, mode):
    """Run ``step(*args)`` once under the fake ``mode`` and a
    ``TraceCounter``.  Returns (outputs, counter, seconds)."""
    t0 = time.time()
    counter = rl.TraceCounter()
    with mode, implicit_replication(), counter:
        out = step(*args)
    return out, counter, time.time() - t0


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: Optional[str] = None, verbose: bool = True,
            microbatches: int = 1, kv_chunk: int = 1024,
            paged: bool = False, page_size: int = 16,
            use_kernel: bool = False, device: str = "cuda",
            mesh=None, mesh_name: Optional[str] = None) -> Dict:
    """Dry-run one pair on the production mesh (or ``mesh``); returns the
    record, also written to ``out_dir`` as {arch}_{shape}_{mesh}.json."""
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    mesh_name = mesh_name or "x".join(map(str, mesh.shape))
    chips = mesh.size()
    t0 = time.time()
    # the program that runs, recorded as run: paged (and the kernels)
    # for decode shapes only
    paged = (paged or use_kernel) and _shape(shape_name).kind == "decode"
    # the kernels run on CUDA tensors only; a CPU program is the plain one
    use_kernel = use_kernel and paged and device == "cuda"
    shape = _shape(shape_name)
    shape_name = shape.name
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": chips, "status": "ok", "paged": bool(paged),
                 "kernel": bool(use_kernel), "device": device}
    try:
        step, args, spec, sh = build_step(
            arch, shape, mesh, microbatches=microbatches,
            kv_chunk=kv_chunk, paged=paged, page_size=page_size,
            use_kernel=use_kernel, device=device)
        cfg, shape = spec["cfg"], spec["shape"]
        t_build = time.time() - t0
        by_group = {k: per_chip_bytes(spec[k], sh[k], mesh) for k in sh}
        arg_bytes = sum(by_group.values())
        out, counter, t_trace = trace(step, args, spec["mode"])
        mem = {"argument_size_in_bytes": arg_bytes,
               "output_size_in_bytes": _tensor_bytes(out),
               "temp_size_in_bytes": counter.peak,
               "alias_size_in_bytes": None,
               "generated_code_size_in_bytes": None}
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] "
                  f"build {t_build:.1f}s trace {t_trace:.1f}s")
            print("  memory_analysis:", mem)
            print("  per-chip flops=%.3e op bytes=%.3e" % (
                counter.flops, counter.op_bytes))

        # MODEL_FLOPS (useful compute) for the roofline ratio
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            kw = dict(batch=B, seq=1, kind="decode", kv_cache_len=S)
        else:
            kw = dict(batch=B, seq=S, kind=shape.kind)
        mflops = model_flops(cfg, **kw)
        eflops = step_flops(
            cfg, batch=kw["batch"], seq=kw["seq"], kind=shape.kind,
            kv_cache_len=kw.get("kv_cache_len", 0),
            remat_policy=os.environ.get("REPRO_REMAT_POLICY", "full"))
        hbm = analytic_hbm_bytes(cfg, **kw)
        roof = rl.analyze(arch=arch, shape=shape_name, mesh_name=mesh_name,
                          chips=chips, counter=counter, exec_flops=eflops,
                          hbm_bytes=hbm, model_flops=mflops,
                          per_chip_peak_mem=arg_bytes + counter.peak)
        rec.update({
            "lower_s": t_build, "compile_s": t_trace,
            "per_chip_arg_bytes": arg_bytes,
            "per_chip_arg_bytes_by_group": by_group,
            "custom_op_calls": dict(counter.custom_calls),
            "per_chip_out_bytes": mem["output_size_in_bytes"],
            "memory_analysis": mem,
            "cost_flops_per_device": counter.flops,
            "cost_bytes_per_device": counter.op_bytes,
            "model_flops_analytic": mflops,
            "model_flops_6nd": model_flops_6nd(
                cfg, tokens=B * (S if shape.kind != "decode" else 1)),
            "roofline": roof.to_dict(),
        })
        if verbose:
            print(f"  per-chip args {arg_bytes/1e9:.2f}GB "
                  f"out {mem['output_size_in_bytes']/1e9:.2f}GB "
                  f"peak live {counter.peak/1e9:.2f}GB")
            print(f"  roofline: compute {roof.compute_s*1e3:.2f}ms | "
                  f"memory {roof.memory_s*1e3:.2f}ms | "
                  f"collective {roof.collective_s*1e3:.2f}ms "
                  f"-> bottleneck={roof.bottleneck} "
                  f"useful={roof.useful_ratio:.2f}")
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        # the port's own frames, innermost last: where the trace stopped
        rec["where"] = [f"{f.filename.split('src/')[-1]}:{f.lineno} {f.name}"
                        for f in traceback.extract_tb(e.__traceback__)
                        if "repro_torch" in f.filename][-6:]
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] FAILED: "
                  f"{rec['error'][:600]}")
            print("  at " + " <- ".join(reversed(rec["where"])))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=float)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ALL_ARCHS))
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch × shape) pair")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--paged", action="store_true",
                    help="decode shapes: run the paged (block-table) "
                         "serving-engine step instead of the dense decode")
    ap.add_argument("--kernel", action="store_true",
                    help="decode shapes: run the paged engine step with "
                         "the paged-decode and scan kernels' custom ops "
                         "(implies --paged)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="device type of the traced program (fake tensors "
                         "need no such device)")
    args = ap.parse_args(argv)
    kw = dict(multi_pod=args.multi_pod, out_dir=args.out,
              microbatches=args.microbatches, paged=args.paged,
              page_size=args.page_size, use_kernel=args.kernel,
              device=args.device)
    if args.all:
        pairs, skips = baseline_pairs()
        recs = [run_one(arch, shape, **kw) for arch, shape in pairs]
        for arch, shape, why in skips:
            print(f"[skip] {arch} × {shape}: {why}")
        return recs
    assert args.arch and args.shape, "--arch/--shape or --all"
    ok, why = shape_applicable(get_config(args.arch), INPUT_SHAPES[args.shape])
    if not ok:
        print(f"[skip] {args.arch} × {args.shape}: {why}")
        return []
    return [run_one(args.arch, args.shape, **kw)]


if __name__ == "__main__":
    main()
