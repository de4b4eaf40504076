"""Finding a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout, ``configs/<config>.json``, ``traffic/<mix>.json``,
``limits/<cell>.json``, ``jobs/<kind>.py`` (a configuration's ``job``) and
``metrics/<metric>.py``.  Adding a cell, a mix, a configuration or a metric
is adding files and entries; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.here = self.root / HERE.name
        self.spec = load_json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.here / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        return {k: float(v) for k, v in load_json(self.here / "limits" / f"{cell}.json").items()}

    def job(self, kind: str) -> ModuleType:
        return importlib.import_module(f"{__package__}.jobs.{kind}")

    def metrics(self, cell: str, section: str) -> List[dict]:
        """The ``section`` ("end_to_end" or "per_layer") metrics the cell
        reports: those without ``workloads`` and those that list it."""
        return [m for m in self.spec[section] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> ModuleType:
        return _load(self.here / "metrics" / f"{metric}.py",
                     "portbench.metrics." + metric.replace(".", "_"))


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
