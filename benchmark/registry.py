"""Finds everything of a cell by name: its entry in ``BENCHMARK.json``, the
configuration file, the traffic file, the limits of its comparison, its
unit kind, the entry that drives it and the readers of its metrics.

Layout under the benchmark folder (``root/benchmark``):

- ``configs/<config>.json``: a configuration (the ``file`` of its entry);
  its ``units`` names the unit kind, ``epoch`` where the key is missing;
- ``units/<kind>.py``: a unit kind: the cell's inputs from the seed, the
  program built from them, what a call passes for each ask and the targets
  it makes, the row width the roofline counts, and the reference and its
  comparison (``units/epoch.py`` lists the functions);
- ``traffic/<traffic>.json``: a traffic mix, parameters for
  :mod:`benchmark.traffic`; its ``entry`` names what drives the program;
- ``entries/<entry>.py``: what drives the program (``warm`` and ``window``);
- ``limits/<cell>.json``: the limit of each number the comparison reads;
- ``e2e/<metric>.py`` and ``metrics/<metric>.py``: the reader of an
  end-to-end or per-layer metric, a function ``read(run)`` that returns a
  number, or None where it finds nothing to read.

A cell, a mix, a configuration or a metric is added by adding its files
and its entry in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Cell:
    root: Path                  # the checkout's root
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list            # the entries of the cell's end-to-end metrics
    per_layer: list             # the entries of the cell's per-layer metrics

    @property
    def bench_dir(self) -> Path:
        return self.root / "benchmark"

    @property
    def unit_kind(self) -> str:
        return self.config.get("units", "epoch")


def _load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from its file (names may hold dots: ``decode_ms.batch.py``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or the metric
    lists no cells (a per-layer metric then goes wherever the end-to-end
    metric it moves is reported)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def cell(root: Path, name: str) -> Cell:
    bench = _load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r}; have {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    bdir = root / "benchmark"
    return Cell(root=root, name=name, chips=int(w["chips"]), config_name=w["config"],
                config=_load_json(root / cfg["file"]), traffic_name=w["traffic"],
                traffic=_load_json(bdir / "traffic" / f"{w['traffic']}.json"),
                limits=_load_json(bdir / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def entry(c: Cell):
    return load_module(c.bench_dir / "entries" / f"{c.traffic['entry']}.py",
                       f"bench_entry_{c.traffic['entry']}")


def units(c: Cell):
    """The module of the cell's unit kind, ``units/<kind>.py``."""
    path = c.bench_dir / "units" / f"{c.unit_kind}.py"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {c.config_name!r} names unit kind "
                                f"{c.unit_kind!r}, and there is no benchmark/units/"
                                f"{c.unit_kind}.py")
    return load_module(path, f"bench_units_{c.unit_kind}")


def reader(c: Cell, kind: str, metric: str):
    """The ``read`` function of a metric (``kind`` "e2e" or "metrics")."""
    return load_module(c.bench_dir / kind / f"{metric}.py",
                       f"bench_{kind}_{metric.replace('.', '_')}").read
