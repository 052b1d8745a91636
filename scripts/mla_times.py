"""The paged-decode kernel at MLA's shape (deepseek-v3-671b's absorbed
decode: 128 query heads over one latent head, D = Dv = 512, De = 64, the
latent pool as both K and V), on its own, and against another tree's.

    python3 scripts/mla_times.py [--old DIR]

Builds ``csrc/paged_attention.cu`` and prints the ptxas line of each
head-tiled instance (the MLA instance ``paged_mla_kernel``, the CUDA-core
``paged_tiled_kernel``, their ``paged_merge_kernel``).  Then it runs
``chip_smoke.py``'s checks at this shape (phase 2b: both instances
against the plain version and their split-K mirrors, -1 columns, idle
slots) and its times at the served decode shape (phase 10b: device time
under ``torch.profiler`` beside the bounds, the plain version and SDPA),
and adds, at that shape and at a full table (8 slots x 64 columns), the
device time of the MLA split kernel and the merge apart, and of the
CUDA-core instance on the served shape in float32.

With ``--old DIR`` (a tree unpacked from ``git archive``, for example the
parent commit) it builds that tree's ``paged_attention.cu`` beside this
one's, both at once, and runs the above in four turns, old, new, new,
old, one process a turn importing that tree's package and
``chip_smoke.py`` (a tree names its tensor-core instance's kernels in
``chip_smoke.MLA_KERNELS``; one that does not is the ``mma.sync``
instance, ``paged_mma_kernel``).  Prints a line per time and last one
JSON object; fails if a build or a check fails.  Needs an H100 and nvcc;
about a minute of command time alone, three with ``--old``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OLD_KERNELS = ("paged_mma_kernel", "paged_merge_kernel")


def turn(root: Path) -> dict:
    """The checks and times of the tree at ``root``, in this process."""
    import torch
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import paged_attention_fwd
    from repro_torch.kernels.ref import paged_attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load("paged_attention")
    split_k, merge_k = getattr(cs, "MLA_KERNELS", OLD_KERNELS)
    fwd, ref = paged_attention_fwd, paged_attention_ref
    out = {"kernels": [split_k, merge_k],
           "errors": cs.phase_mla_vs_plain(fwd, ref),
           "served": cs.phase_mla_kernel_times(fwd, ref)}
    out["served"].pop("library_kernels")
    for shape, c in (("served", cs.mla_decode_case(torch.bfloat16)),
                     ("full table", cs.mla_case(64, torch.bfloat16, seed=5)),
                     ("served, float32",
                      cs.mla_decode_case(torch.float32))):
        t = out[f"{shape} ms"] = {}
        parts = (("CUDA-core", ("paged_tiled_kernel", "paged_merge_kernel")),)
        if c["q"].dtype == torch.bfloat16:
            parts = (("tensor-core", (split_k, merge_k)),
                     ("tensor-core split kernel", split_k),
                     ("merge kernel", merge_k))
        for name, kernels in parts:
            t[name] = cs.device_ms(
                lambda i: cs.run_kernel(fwd, c, scale=cs.MLA_SCALE), 50,
                kernels)
            print(f"{shape} ({int((c['table'] >= 0).sum())} of 8 x 64 "
                  f"columns): {name} ({split_k}) {t[name] * 1e3:.2f} us of "
                  f"device time")
    return out


def tree_build(root: Path):
    """The ``build`` module of the tree at ``root`` (its own CSRC and
    BUILD_DIR), loaded under a name of its own."""
    path = root / "src" / "repro_torch" / "kernels" / "build.py"
    spec = importlib.util.spec_from_file_location(
        f"_mla_build_{abs(hash(str(root)))}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def print_ptxas(cs, tag: str, log) -> None:
    if log is None:
        print(f"ptxas {tag} paged_attention: built before this run")
        return
    print(f"ptxas {tag} paged_attention: " + "; ".join(
        f"{inst} {regs} regs {smem} B static smem {spill} B spilled "
        f"{stack} B stack" for inst, regs, smem, spill, stack
        in cs.ptxas_summary(log) if "split_kernel" not in inst
        and "wide" not in inst))
    for line in log.splitlines():
        if "(C7" in line:
            print(f"nvcc {tag} paged_attention: {line.strip()}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", type=Path)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    opt = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mla_times: no CUDA device", file=sys.stderr)
        return 2
    if opt.turn:
        print("MLA_RESULT " + json.dumps(turn(opt.turn)))
        return 0
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    card = cs.card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    trees = {"new": ROOT}
    if opt.old is not None:
        trees["old"] = opt.old.resolve()
    builds = {tag: tree_build(root) for tag, root in trees.items()}
    jobs = {tag: b._start("paged_attention") for tag, b in builds.items()}
    for tag, b in builds.items():              # all nvcc runs at once
        b._finish("paged_attention", *jobs[tag])
        log = (b.build_log("paged_attention") if hasattr(b, "build_log")
               else b.logs.get("paged_attention"))
        print_ptxas(cs, tag, log)
    if opt.old is None:
        result = {"card": card, "runs": [{"variant": "new",
                                          **turn(ROOT)}]}
        print(json.dumps(result))
        return 0
    result = {"card": card, "runs": []}
    for tag in ("old", "new", "new", "old"):
        print(f"== {tag}")
        proc = subprocess.run(
            [sys.executable, __file__, "--turn", str(trees[tag])],
            stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONUNBUFFERED="1"))
        lines = proc.stdout.splitlines()
        for line in lines:
            if not line.startswith("MLA_RESULT "):
                print(line)
        if proc.returncode != 0:
            cs.fail(f"the {tag} turn exited {proc.returncode}")
        res = json.loads(lines[-1][len("MLA_RESULT "):])
        result["runs"].append({"variant": tag, **res})
        print(f"{tag}: served {res['served']['ms'] * 1e3:.2f} us (split "
              f"{res['served ms']['tensor-core split kernel'] * 1e3:.2f} + "
              f"merge {res['served ms']['merge kernel'] * 1e3:.2f}), full "
              f"table {res['full table ms']['tensor-core'] * 1e3:.2f} us "
              f"(split {res['full table ms']['tensor-core split kernel'] * 1e3:.2f}"
              f" + merge {res['full table ms']['merge kernel'] * 1e3:.2f}); "
              f"bound {res['served']['bound_ms'] * 1e3:.2f} us, SDPA "
              f"{res['served']['library_ms'] * 1e3:.2f} us")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
