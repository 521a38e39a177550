"""What a run of a cell needs, found by name through `BENCHMARK.json`.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything else is found by those names, so a later cell, configuration,
mix or metric is a matter of new files and entries:

- the configuration: the ``file`` its entry in ``configs`` gives;
- its operation and byte counts: ``gpubench/counts/<config>.py``;
- the traffic mix: ``gpubench/traffic/<traffic>.json``;
- the program's entry point the mix drives, with its set-up, its judge
  and its end-to-end readings: ``gpubench/entries/<entry>.py``, named by
  the mix's ``entry``;
- the cell's limits for ``correct``: ``gpubench/limits/<cell>.json``;
- each per-layer metric: the reader ``gpubench/metrics/<metric>.py``,
  whose ``read(ctx)`` returns a number or None.

``root`` is the checkout's root (the directory holding `BENCHMARK.json`);
tests pass a copy of it.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = "gpubench"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file path, under a name of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    spec: Dict                  # the cell's entry in ``workloads``
    config: Dict
    traffic: Dict
    entry: object               # gpubench/entries/<entry>.py
    limits: Dict
    counts: object
    end_to_end: List[Dict]
    per_layer: List[Dict]
    readers: Dict[str, object] = field(default_factory=dict)
    root: str = ROOT

    @property
    def chips(self) -> int:
        return int(self.spec["chips"])


def metric_applies(metric: Dict, cell: str) -> bool:
    """Whether ``metric`` is reported in ``cell``: an end-to-end metric with
    no ``workloads`` list in every cell, any other where it lists the cell.
    Every per-layer metric carries its list."""
    if "workloads" not in metric:
        if "layer" in metric:
            raise ValueError(f"per-layer metric {metric['name']!r} lists no "
                             f"workloads")
        return True
    return cell in metric["workloads"]


def find_cell(name: str, root: str = ROOT) -> Cell:
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    work = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(os.path.join(root, configs[work["config"]]["file"]))
    here = os.path.join(root, HERE)
    traffic = load_json(os.path.join(here, "traffic", work["traffic"] + ".json"))
    entry = load_module(os.path.join(here, "entries", traffic["entry"] + ".py"),
                        "gpubench_entry_" + traffic["entry"].replace(".", "_"))
    limits_path = os.path.join(here, "limits", name + ".json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    counts = load_module(os.path.join(here, "counts", work["config"] + ".py"),
                         f"gpubench_counts_{work['config'].replace('.', '_')}")
    e2e = [m for m in spec["end_to_end"] if metric_applies(m, name)]
    per_layer = [m for m in spec["per_layer"] if metric_applies(m, name)]
    cell = Cell(name=name, spec=work, config=config, traffic=traffic,
                entry=entry, limits=limits, counts=counts, end_to_end=e2e,
                per_layer=per_layer, root=root)
    for m in per_layer:
        path = os.path.join(here, "metrics", m["name"] + ".py")
        cell.readers[m["name"]] = load_module(
            path, "gpubench_metric_" + m["name"].replace(".", "_"))
    return cell


def read_per_layer(cell: Cell, ctx: Dict) -> Dict[str, Dict]:
    """Each per-layer metric its reader finds something for, with its unit;
    a reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer:
        value: Optional[float] = cell.readers[m["name"]].read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
