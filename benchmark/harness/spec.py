"""Where the benchmark's parts live, found by the names in
``BENCHMARK.json``.

Every cell, configuration, traffic mix and metric is a file of its own,
so a later cell adds files and edits none:

* ``BENCHMARK.json`` (the checkout's root): the cells, with their
  configuration, traffic mix and chips, and the metrics;
* ``benchmark/configs/<config>.json``: the deployment's sizes, source,
  precision, and the generator (``benchmark/generators/<generator>.py``)
  that makes its inputs from the seed;
* ``benchmark/traffic/<traffic>.json``: the mix's parameters, and the
  ``kind`` of request (``benchmark/traffic/<kind>.py``) that reads them;
* ``benchmark/workloads/<cell>.json``: the cell's limits on the numbers
  that decide ``correct``, and the readings they were set from;
* ``benchmark/metrics/<metric>.py``: one reader per metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def valid_name(s) -> bool:
    return isinstance(s, str) and NAME_RE.fullmatch(s) is not None


def valid_unit(s) -> bool:
    return isinstance(s, str) and UNIT_RE.fullmatch(s) is not None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, prefix: str) -> ModuleType:
    """Import the file ``path`` under the name ``<prefix>_<stem>``, so that
    files of one name in different folders never collide."""
    name = f"bench_{prefix}_{re.sub(r'[^A-Za-z0-9_]', '_', path.stem)}"
    mod = sys.modules.get(name)
    if mod is not None and Path(mod.__file__) == path:
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    per_layer: bool
    moves: Optional[str] = None
    workloads: Optional[List[str]] = None

    def reader(self, bench_dir: Path = BENCH_DIR) -> ModuleType:
        return load_module(bench_dir / "metrics" / f"{self.name}.py", "metric")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with every file it names, loaded."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    workload: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    bench_dir: Path

    def kind(self) -> ModuleType:
        return load_module(self.bench_dir / "traffic" / f"{self.traffic['kind']}.py", "kind")

    def generator(self) -> ModuleType:
        return load_module(
            self.bench_dir / "generators" / f"{self.config['generator']}.py", "generator"
        )


def _metrics(spec: dict) -> List[Metric]:
    return [Metric(m["name"], m["unit"], per_layer, m.get("moves"), m.get("workloads"))
            for per_layer, key in ((False, "end_to_end"), (True, "per_layer"))
            for m in spec[key]]


def cell_metrics(spec: dict, cell: str):
    """(end-to-end, per-layer) metrics that ``cell`` reports.  An
    end-to-end metric without ``workloads`` is in every cell; a per-layer
    one is in the cells its ``workloads`` lists."""
    metrics = _metrics(spec)
    e2e = [m for m in metrics if not m.per_layer and (m.workloads is None or cell in m.workloads)]
    layer = [m for m in metrics if m.per_layer and cell in m.workloads]
    return e2e, layer


def load_cell(name: str, spec_file: Path = SPEC_FILE, bench_dir: Path = BENCH_DIR) -> Cell:
    spec = load_json(spec_file)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {spec_file}")
    e2e, layer = cell_metrics(spec, name)
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config_name=entry["config"],
        traffic_name=entry["traffic"],
        config=load_json(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        limits=dict(workload["limits"]),
        workload=workload,
        end_to_end=e2e,
        per_layer=layer,
        bench_dir=bench_dir,
    )
