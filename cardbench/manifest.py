"""The benchmark's manifest and the files it finds by name.

``BENCHMARK.json`` at the root of the checkout lists the cells
(``workloads``), the configurations and the metrics.  Everything that
belongs to one of them sits in a file of its own under ``cardbench/``:

* ``configs/<config>.json``: the configuration as it is run;
* ``workloads/<cell>.json``: the cell's driver, the program's settings,
  what the correctness check compares and its limits;
* ``traffic/<mix>.json``: the parameters the general generator
  (``traffic.py``) reads;
* ``drivers/<driver>.py``: one entry path of the program
  (``run(cell, ...)``);
* ``metrics/<metric>.py``: one reader per per-layer metric
  (``read(run) -> float | None``);
* ``reference/<name>.py``: the plain references.

A cell or metric added as files and manifest entries alone is picked up.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""
    name: str
    entry: dict          # the manifest's entry
    workload: dict       # workloads/<name>.json
    config: dict         # configs/<config>.json
    mix: dict            # traffic/<traffic>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def driver(self) -> str:
        return self.workload["driver"]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def read_json(kind: str, name: str, package: Path = PACKAGE) -> dict:
    path = Path(package) / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"cardbench: no {kind} file {path}")
    return json.loads(path.read_text())


def _covers(metric: dict, cell: str, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(manifest: dict, name: str, package: Path = PACKAGE) -> Cell:
    """The cell ``name`` with its files, and the metrics it reports."""
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise KeyError(f"cardbench: no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    workload = read_json("workloads", name, package)
    config = read_json("configs", entry["config"], package)
    mix = read_json("traffic", entry["traffic"], package)
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in manifest["per_layer"] if _covers(m, name, names)]
    return Cell(name, entry, workload, config, mix, e2e, per_layer)


def load_module(kind: str, name: str, package: Path = PACKAGE) -> ModuleType:
    """``<package>/<kind>/<name>.py`` as a module (names may hold dots and
    dashes, so the file is loaded by its path)."""
    path = Path(package) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"cardbench: no {kind} module {path}")
    mod_name = "cardbench_" + kind + "_" + re.sub(r"\W", "_", name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_metrics(c: Cell, run, package: Path = PACKAGE
                 ) -> Dict[str, Optional[float]]:
    """Each per-layer metric of the cell by its reader; a reader that
    finds nothing to read gives None and the metric is left out."""
    out = {}
    for m in c.per_layer:
        value = load_module("metrics", m["name"], package).read(run)
        if value is not None:
            out[m["name"]] = float(value)
    return out
