"""A cell, found by name from ``BENCHMARK.json`` and the files beside it.

Everything that belongs to one configuration, one traffic mix or one metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

* a configuration: the ``file`` its entry names (``portbench/configs/``);
* a traffic mix: ``portbench/traffic/<traffic>.json``, run by the loop of
  its ``kind`` (``portbench/loops/<kind>.py``);
* a metric: ``portbench/metrics/<name>.py``, whose ``read(run)`` returns the
  metric's value, or ``None`` when the run holds nothing it can read.

A new cell of existing kinds therefore adds files and edits none.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

__all__ = ["Cell", "load_cell", "reader", "loop"]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]      # BENCHMARK.json metric entries this cell reports
    per_layer: List[Dict]
    root: Path                  # the checkout holding BENCHMARK.json


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {', '.join(sorted(cells))})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
                root=root)


def _module(path: Path, what: str):
    if not path.is_file():
        raise FileNotFoundError(f"{what} has no file at {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(root: Path, name: str) -> Callable:
    """``read`` of ``portbench/metrics/<name>.py`` (names may hold dots)."""
    return _module(Path(root) / "portbench" / "metrics" / f"{name}.py",
                   f"metric {name!r}").read


def loop(root: Path, kind: str):
    """The request loop of a traffic kind: ``portbench/loops/<kind>.py``."""
    return _module(Path(root) / "portbench" / "loops" / f"{kind}.py", f"loop {kind!r}")
