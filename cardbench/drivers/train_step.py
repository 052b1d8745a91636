"""Driver of the training cells: the program's train step
(``repro_torch.train.step.make_train_step`` with ``optim.adamw``) driven
back to back on batches from the cell's mix.

Set-up builds one step function with its model and optimizer state from
the seed and drives it through the check's first steps (distinct
batches, the window's own call): their losses, each leaf's first
gradient as AdamW holds it after step 1 (mu / (1 - b1)), and each
leaf's change after the last of them (the float32 master weights
against the starting weights, drawn again from the seed).  The window
then runs the same object on for ``seconds``, one span per step, a
synchronize after each.  Once it has closed and the program's state is
freed, the plain reference follows the same steps from the same weights
and batches.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from cardbench import check, model, trace, traffic
from cardbench.manifest import load_module


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _leaf_items(params, specs):
    """(spec, program tensor) for each leaf, by path."""
    flat = {}

    def walk(node, pre):
        if isinstance(node, torch.Tensor):
            flat[pre] = node
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{pre}/{k}" if pre else k)
        else:
            for i, v in enumerate(node):
                walk(v, f"{pre}/{i}")
    walk(params, "")
    return [(s, flat[s.path]) for s in specs]


def run(cell, *, seed: int, seconds: float, trace_on: bool, device="cuda",
        t_start: float, fault: str = "") -> dict:
    from repro_torch.models.transformer import trainable
    from repro_torch.optim.adamw import adamw, cosine_lr
    from repro_torch.train.step import make_train_step

    conf, mix, prog = cell.config, cell.mix, cell.workload["program"]
    chk = cell.workload["check"]
    port = conf["port"]
    cfg = model.port_config(conf)
    specs = model.param_specs(port)
    B, S = mix["batch"], mix["seq_len"]
    n_check = chk["steps"]

    params = trainable(model.tree(model.make_weights(specs, seed, device)))
    o = prog["optimizer"]
    opt = adamw(cosine_lr(o["lr"], o["warmup"], o["total"]), b1=o["b1"],
                b2=o["b2"], eps=o["eps"], weight_decay=o["weight_decay"],
                clip_norm=o["clip_norm"])
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt, remat=prog["remat"],
                           remat_policy=prog["remat_policy"],
                           use_kernel=prog["use_kernel"],
                           ce_chunk=prog["ce_chunk"])
    if fault == "frozen_state":          # a step that returns its state unchanged
        def step(params, opt_state, batch, _step=step):
            return params, opt_state, {"loss": torch.zeros((), device=device)}
    if fault == "half_batch":            # half of the batch left out
        def step(params, opt_state, batch, _step=step):
            return _step(params, opt_state,
                         {k: v[: len(v) // 2] for k, v in batch.items()})

    rows = traffic.lm_batches(mix, seed, n_check + mix["pool"],
                              port["vocab_size"])
    dev_rows = torch.from_numpy(rows.astype(np.int32)).to(device)
    batches = [{"tokens": r[:, :-1], "labels": r[:, 1:]} for r in dev_rows]

    # the check's steps: the program's readings, taken in set-up
    losses, grad1 = [], {}
    for k in range(n_check):
        params, opt_state, m = step(params, opt_state, batches[k])
        losses.append(float(m["loss"]))
        if k == 0:
            grad1 = {s.path: float(mu.float().norm()) / (1 - o["b1"])
                     for s, mu in _leaf_items(opt_state["mu"], specs)}
    delta = {s.path: float((w - model.make_leaf(s, seed, device).float())
                           .norm())
             for s, w in _leaf_items(opt_state["master"], specs)}
    _sync(device)
    setup_s = time.time() - t_start

    # the window
    spans = []
    pool = batches[n_check:]
    i = 0
    t0 = time.time()
    while True:
        a = time.time()
        params, opt_state, m = step(params, opt_state, pool[i % len(pool)])
        _sync(device)
        b = time.time()
        spans.append(("train_step", a, b))
        i += 1
        if b - t0 >= seconds:
            break
    window_s = spans[-1][2] - t0
    losses_window = float(m["loss"])

    tr = None
    if trace_on:
        from torch.profiler import record_function
        handle = trace.start()
        for j in range(cell.workload["trace"]["steps"]):
            with record_function("train_step"):
                params, opt_state, m = step(params, opt_state,
                                            pool[(i + j) % len(pool)])
        tr = trace.stop(handle)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)

    del params, opt_state, step, m, batches, pool, dev_rows
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    ref = reference(cell, seed, device, rows[:n_check])
    numbers = check.train_numbers(
        {"losses": losses, "grad1": grad1, "delta": delta}, ref,
        chk["keep_below_median"])
    return {
        "setup_s": setup_s,
        "e2e": {"train_tokens_per_s": i * B * S / window_s},
        "attempted": n_check + i,
        "failed": int(not all(np.isfinite(losses + [losses_window]))),
        "memory_peak_bytes": peak,
        "numbers": numbers,
        "ref": ref,
        "run": {"kind": "train", "spans": spans, "window_s": window_s,
                "steps": i, "trace": tr, "port": port, "batch": B,
                "seq_len": S},
    }


def reference(cell, seed: int, device, rows: np.ndarray, *, lowp=False,
              half_batch=False) -> dict:
    """The plain reference over the check's steps from the seed's
    weights: losses, step 1's clipped gradient norms and each leaf's
    change after the last step."""
    ref = load_module("reference", cell.config["reference"])
    specs = model.param_specs(cell.config["port"])
    leaves = {s.path: model.make_leaf(s, seed, device).float() for s in specs}
    batches = [(torch.from_numpy(r[:, :-1]).to(device),
                torch.from_numpy(r[:, 1:]).to(device)) for r in rows]
    out = ref.train(leaves, cell.config["port"], batches,
                    cell.workload["program"]["optimizer"], lowp=lowp,
                    half_batch=half_batch)
    out["delta"] = {}
    for s in specs:
        out["delta"][s.path] = float(
            (leaves[s.path] - model.make_leaf(s, seed, device).float()).norm())
    del leaves
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out
