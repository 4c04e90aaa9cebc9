"""Finds what ``BENCHMARK.json`` names: a cell's configuration, its traffic
mix, its metrics and each per-layer metric's reader.

Everything of one configuration, one mix or one metric sits in a file of
its own, found by its name: ``configs/<file>`` as the configuration's entry
gives it, ``traffic/<traffic>.json``, ``metrics/<name>.py``, and the
generator and reference modules a configuration names
(``data/<generator>.py``, ``reference/<reference>.py``).  A new cell needs
new files and entries only.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

__all__ = ["ROOT", "Cell", "load_cell", "reader", "module"]

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]     # the BENCHMARK.json entries this cell reports
    per_layer: list[dict]


def _for(entries: list[dict], cell: str, reported: set[str] | None) -> list:
    out = []
    for m in entries:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = _for(bench["end_to_end"], workload, None)
    per_layer = _for(bench["per_layer"], workload, {m["name"] for m in e2e})
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer)


def reader(name: str):
    """The module of per-layer metric ``name`` (``metrics/<name>.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def module(kind: str, name: str):
    """``data/<name>.py`` or ``reference/<name>.py`` of this package."""
    if kind not in ("data", "reference") or not name.isidentifier():
        raise ValueError(f"no {kind} module {name!r}")
    return importlib.import_module(f"{__package__}.{kind}.{name}")
