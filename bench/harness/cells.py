"""One cell of ``BENCHMARK.json``, with every file it names loaded."""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]   # the checkout's root
BENCH = ROOT / "bench"


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _read(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    chips: int
    config: dict        # bench/configs/<config>.json
    traffic: dict       # bench/traffic/<traffic>.json
    limits: dict        # bench/limits/<workload>.json "limits"
    end_to_end: list    # BENCHMARK.json entries this cell reports
    per_layer: list     # BENCHMARK.json entries this cell reports

    @property
    def runner(self) -> str:
        """The module of ``harness/`` that drives the traffic."""
        return self.traffic["runner"]


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, spec: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``spec`` (``BENCHMARK.json`` by default), its
    configuration, traffic and limits read from their files under
    ``root``: an end-to-end metric is the cell's where its ``workloads``
    lists it or it has none; a per-layer metric where its ``workloads``
    lists it, or, without one, wherever the end-to-end metric it moves
    is reported."""
    spec = load_spec(root) if spec is None else spec
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise KeyError(f"unknown workload {name!r}; have {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _in_cell(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    limits = _read(root / "bench" / "limits" / f"{name}.json")["limits"]
    return Cell(name=name, chips=w["chips"], config=_read(root / conf["file"]),
                traffic=_read(root / "bench" / "traffic"
                              / f"{w['traffic']}.json"),
                limits=limits, end_to_end=e2e, per_layer=per_layer)


def metric_params(name: str, root: Path = ROOT) -> dict:
    """``bench/metrics/<name>.json``: ``reader`` and its parameters."""
    return _read(root / "bench" / "metrics" / f"{name}.json")
