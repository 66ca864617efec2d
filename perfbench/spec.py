"""``BENCHMARK.json`` and the data files it names, found by name.

A cell (an entry of ``workloads``) names a configuration
(``configs/<name>.json`` under ``paths``, as the configuration's ``file``
says) and a traffic mix (``traffic/<name>.json``).  The traffic's
``"entry"`` names the module that builds the program and judges its
answers, ``entries/<entry>.py`` (modules whose names start with ``_`` are
their helpers): ``build(cell, seed, device, stamps) -> run.Bench``,
``compare(bench, kept, answer=None) -> {check: [value, limit]}`` and
``check_config(cfg, traffic=None)``, which raises where the program's
registry disagrees with the configuration's file; and, for
``readings.py``, ``control(cell, seed, device)``, the control's checks.  A metric named
``<quantity>.<split>`` or ``<quantity>`` is read by
``metrics/<quantity>.py`` (``metrics/<name>.py`` first, where one
exists): a module with ``read(window) -> float | None``.  So a new model,
traffic mix or metric is a new file, found by its name.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Mapping, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: where traffic mixes and entry modules are found, read at each call
TRAFFIC = HERE / "traffic"
ENTRIES = HERE / "entries"


@dataclass
class Cell:
    name: str
    workload: Mapping
    cfg: Mapping
    traffic: Mapping
    end_to_end: List[Mapping]
    per_layer: List[Mapping]


def load_benchmark(root: Path = ROOT) -> Mapping:
    return json.loads((root / "BENCHMARK.json").read_text())


def reports(metric: Mapping, cell: str) -> bool:
    """Does ``cell`` report ``metric``: it is in the metric's
    ``workloads``, or the metric has none."""
    return cell in metric.get("workloads", [cell])


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic mix and the
    metrics it reports (the per-layer ones of end-to-end metrics it
    reports)."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, name) and m["moves"] in moved]
    return make_cell(name, w, root / conf["file"], w["traffic"], e2e,
                     per_layer)


def make_cell(name: str, workload: Mapping, config_file: Path,
              traffic: str, end_to_end: List[Mapping] = (),
              per_layer: List[Mapping] = ()) -> Cell:
    """A cell from its configuration's file and its traffic mix's name."""
    return Cell(name, workload, json.loads(Path(config_file).read_text()),
                json.loads((TRAFFIC / f"{traffic}.json").read_text()),
                list(end_to_end), list(per_layer))


def metric_file(name: str) -> Path:
    whole = HERE / "metrics" / f"{name}.py"
    return whole if whole.exists() else \
        HERE / "metrics" / f"{name.split('.')[0]}.py"


_MODULES: Dict[Path, ModuleType] = {}


def load(path: Path, package: str) -> ModuleType:
    """The module in ``path`` as ``perfbench.<package>.<stem>``, loaded
    once."""
    if path not in _MODULES:
        spec = importlib.util.spec_from_file_location(
            f"perfbench.{package}.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(name: str) -> ModuleType:
    """The module that reads metric ``name``."""
    return load(metric_file(name), "metrics")


def entry_names() -> List[str]:
    return sorted(p.stem for p in ENTRIES.glob("*.py")
                  if not p.stem.startswith("_"))


def entry(name: str) -> ModuleType:
    """The module of traffic entry ``name``."""
    path = ENTRIES / f"{name}.py"
    if name.startswith("_") or not path.exists():
        raise KeyError(f"no entry {name!r} in {ENTRIES}; entries: "
                       f"{entry_names()}")
    return load(path, "entries")


def read_metrics(metrics: List[Mapping], window) -> Dict[str, Dict]:
    """``{name: {"value", "unit"}}`` of each metric its reader finds
    something to read for."""
    out: Dict[str, Dict] = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"]).read(window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
