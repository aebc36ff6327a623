"""Everything the harness runs, found by name: a cell's entry in
``BENCHMARK.json``, its configuration (``configs/<name>.json``), its mix
(``traffic/<name>.json``) and the reader of each metric it reports
(``metrics/<name>.py``, a ``read(run)`` that returns a number, or None when
the run holds nothing to read)."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    module_name = "portbench.metrics." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _metrics(entries: List[dict], cell: str) -> List[Metric]:
    return [Metric(m["name"], m["unit"], reader(m["name"]))
            for m in entries if cell in m.get("workloads", [cell])]


def load_cell(name: str, benchmark: Optional[Path] = None) -> Cell:
    bench = _load_json(benchmark or ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=_load_json(ROOT / cfg["file"]),
        traffic=_load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=_metrics(bench["end_to_end"], name),
        per_layer=_metrics(bench["per_layer"], name),
    )


def config_by_name(name: str) -> dict:
    return _load_json(HERE / "configs" / f"{name}.json")


def traffic_by_name(name: str) -> dict:
    return _load_json(HERE / "traffic" / f"{name}.json")
