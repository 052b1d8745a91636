"""repro_torch.analysis — static invariant checker for the PyTorch port.

The counterpart of ``repro.analysis``: the same core, baseline,
reporters and CLI, with rules for the hazards of a CUDA port that the
CPU tests cannot see.  A ctypes kernel reached under autograd cuts the
gradient on the card only (GRAD001); a kernel's ``argtypes`` and its
``extern "C"`` declaration are two descriptions of one interface, and a
wrong count or width corrupts memory on the card only (KRN001); a
custom op without its fake or FLOP formula counts nothing in the
dry-run (KRN002); a host sync in per-layer code stalls the device and
blocks CUDA graphs (SYNC001); a fallback that hides the device or the
kernel breaks the port's founding rule (FBK001); and the JAX package's
ALLOC001, DET001 and HOT001 apply to the port's own trees.

Pure stdlib (``ast``, ``re``, ``json``); imports nothing of ``repro``
(it keeps its own copies of what it shares with ``repro.analysis``).
Entry points:

* ``python -m repro_torch.analysis [--strict] [--only RULE] [--format json]``
* ``run_analysis(root)`` / ``analyze_source(text, rel)`` for tests.

See ``src/repro_torch/analysis/README.md`` for the rule catalog,
suppression comments (``# repro-torch-lint: disable=RULE``) and the
baseline workflow.
"""
from repro_torch.analysis.baseline import (Baseline, BaselineEntry,
                                           apply_baseline, load_baseline,
                                           write_baseline)
from repro_torch.analysis.core import (DEFAULT_CONFIG, RULES, Finding,
                                       Report, analyze_source, iter_py_files,
                                       repo_root, run_analysis)

__all__ = [
    "Baseline", "BaselineEntry", "DEFAULT_CONFIG", "Finding", "RULES",
    "Report", "analyze_source", "apply_baseline", "iter_py_files",
    "load_baseline", "repo_root", "run_analysis", "write_baseline",
]
