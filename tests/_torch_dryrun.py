"""Shared pieces of the port's dry-run tests: the JAX package's dry-run
inputs and shardings (``_jax_shardings_dump.py``) and its dry-run
records (``_jax_dryrun_dump.py``), each dumped once per test module by a
subprocess with 512 host devices."""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


def jax_dump(tmp_dir: str, opt_bits: int = 32) -> dict:
    """The JSON of ``_jax_shardings_dump.py`` (written under tmp_dir)."""
    out = os.path.join(tmp_dir, f"jax_shardings_{opt_bits}.json")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable,
                        os.path.join(HERE, "_jax_shardings_dump.py"), out,
                        "--opt-bits", str(opt_bits)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def jax_dryrun(tmp_dir: str, pairs) -> dict:
    """{(arch, shape): the JAX package's dry-run record} of ``pairs`` on
    the 16x16 mesh (``_jax_dryrun_dump.py``, written under tmp_dir)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable,
                        os.path.join(HERE, "_jax_dryrun_dump.py"), tmp_dir,
                        *(f"{a}:{s}" for a, s in pairs)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = {}
    for arch, shape in pairs:
        with open(os.path.join(tmp_dir,
                               f"{arch}_{shape}_pod16x16.json")) as f:
            out[(arch, shape)] = json.load(f)
    return out


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def case_ids():
    """The cases a dump holds, in its order: "arch|shape|dense|paged"."""
    sys.path.insert(0, SRC)
    from repro_torch.configs import INPUT_SHAPES, baseline_pairs
    out = []
    for arch, shape in baseline_pairs()[0]:
        out.append(f"{arch}|{shape}|dense")
        if INPUT_SHAPES[shape].kind == "decode":
            out.append(f"{arch}|{shape}|paged")
    return out
