"""The benchmark's definition, found by name.

BENCHMARK.json at the root of the checkout names the cells, their
configurations and traffic mixes, and the metrics. Beside this file:
  - configs/<file named in BENCHMARK.json>: a configuration's sizes;
  - traffic/<traffic>.json: a traffic mix, read by traffic.py;
  - workloads/<cell>.json: the limits of a cell's comparison with the
    plain reference;
  - metrics/<metric>.py: a metric's own reader, or metrics/<metric>.json
    naming a shared reader in readers/ and its entries.
A cell or a metric is added by adding such files and entries.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclass(frozen=True)
class Cell:
    name: str
    config: dict  # the configuration file as it is run
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # workloads/<cell>.json: {"limits": {number: limit}, ...}
    end_to_end: list  # BENCHMARK.json's end-to-end metrics this cell reports
    per_layer: list  # BENCHMARK.json's per-layer metrics this cell reports
    chips: int


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files."""
    bench = benchmark if benchmark is not None else load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[0]
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name,
        config=load_json(ROOT / config_entry["file"]),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(HERE / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        chips=int(entry["chips"]),
    )
