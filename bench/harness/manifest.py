"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the root of the
checkout names the cells and the metrics; each configuration, traffic
mix, cell's limits and metric reader is a file of its own under
``bench/``:

* ``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json``,
* ``bench/families/<model_type>.py`` (a configuration family's layer
  pattern, found by the configuration's ``model_type``),
* ``bench/limits/<cell>.json`` (the limits of the comparison),
* ``bench/metrics/<metric>.py`` (a function ``read(view)`` returning the
  metric's value, or None where it finds nothing to read).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

from .check import load_limits
from .spec import ModelSpec, load_module, load_spec
from .traffic import load_mix

__all__ = ["BENCH", "ROOT", "Cell", "load_manifest", "load_cell",
           "metric_entries", "reader"]

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    spec: ModelSpec
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def load_manifest(path: Optional[Path] = None) -> Dict:
    return json.loads(Path(path or ROOT / "BENCHMARK.json").read_text())


def metric_entries(manifest: Dict, cell: str) -> Dict[str, List[Dict]]:
    """The cell's end-to-end metrics (those that list it, or list no
    cells) and its per-layer metrics (those that list it, or list no
    cells and move an end-to-end metric the cell reports)."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if cell in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": layer}


def load_cell(manifest: Dict, name: str) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[name]
    m = metric_entries(manifest, name)
    return Cell(name=name, chips=int(w["chips"]),
                spec=load_spec(BENCH / "configs" / f"{w['config']}.json"),
                mix=load_mix(BENCH / "traffic" / f"{w['traffic']}.json"),
                limits=load_limits(BENCH / "limits" / f"{name}.json"),
                end_to_end=m["end_to_end"], per_layer=m["per_layer"])


def reader(name: str) -> Callable:
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "bench_metric_").read
