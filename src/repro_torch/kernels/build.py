"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into its own shared library
with a plain C interface, under ``build/repro_torch/`` at the root of the
checkout, and loaded with ``ctypes``.  The library's file name carries a
hash of its source and the flags, so an edited source is rebuilt and a
stale library is never loaded; the compiler's output is kept beside it
(same name, ``.log``), so ptxas's report of a library built by an earlier
process can still be read (``build_log``).  Builds happen at first use (never at
import: the CPU tests import every module and have no ``nvcc``), and
``build_all`` starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# compiler output of the builds this process ran (ptxas reports each
# kernel's registers, shared memory and spills)
logs: Dict[str, str] = {}


def sources() -> List[str]:
    """Names of the kernel sources in ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("repro_torch: nvcc not found (set CUDA_HOME or put "
                       "nvcc on PATH) — the CUDA kernels build from source")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Optional[subprocess.Popen], Optional[Path]]:
    """Start ``nvcc`` for one source unless its library already exists;
    returns (process, temporary output) or (None, None)."""
    out = library_path(name)
    if out.exists():
        return None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, proc: Optional[subprocess.Popen],
            tmp: Optional[Path]) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    # the log first, so every library in place has its log beside it
    out = library_path(name)
    tmp_log = tmp.with_suffix(".log")
    tmp_log.write_text(log)
    os.replace(tmp_log, out.with_suffix(".log"))
    os.replace(tmp, out)                  # atomic: no reader sees half a file


def build_log(name: str) -> Optional[str]:
    """The compiler's output for the current library of
    ``csrc/<name>.cu``, whichever process built it; None when that
    library has not been built or was built without its log."""
    if name in logs:
        return logs[name]
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else None


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` in parallel (one ``nvcc`` each) and
    return the library paths.  Raises with the compiler's output if any
    build fails."""
    started = {name: _start(name) for name in sources()}
    errors = []
    for name, (proc, tmp) in started.items():
        try:
            _finish(name, proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    if name not in _loaded:
        _finish(name, *_start(name))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]


def use(name: str, path: Path) -> None:
    """Make the wrappers call the library at ``path`` in place of
    ``csrc/<name>.cu``'s own from now on in this process: another
    checkout's build of the same source, so that two versions of a
    kernel are timed in one process."""
    _loaded[name] = ctypes.CDLL(str(path))
