"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names every cell
(``workloads``), its configuration and its traffic mix. Each part is a
file of its own under ``portbench/``, found by the name alone:

- ``configs/<config>.json``: the model's sizes as run;
- ``traffic/<traffic>.json``: the driver kind and its parameters;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``;
- ``limits/<workload>.json``: the limits ``correct`` is decided by;
- ``drivers/<kind>.py``: the driver of a mix's ``kind``, with
  ``drive(run, controls) -> dict``;
- ``families/<family>.py``: a configuration's ``family`` as the port's
  model config, and ``reference/families/<family>.py`` its plain
  reference's feed-forward block.

A later change adds a cell by adding files and entries; no file here
needs an edit for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    #: the BENCHMARK.json metric entries this cell reports, by name
    end_to_end: dict
    per_layer: dict


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether ``cell`` reports ``metric``: its ``workloads`` key lists
    the cell, or, without one, the cell reports the end-to-end metric
    that it moves (or, for an end-to-end metric, always)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or moves in e2e_of_cell


def find_cell(name: str, root: Path = ROOT,
              portbench: Path = PORTBENCH) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files read
    from ``portbench``. Raises KeyError for a cell it does not name."""
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = load_part("configs", entry["config"], portbench)
    traffic = load_part("traffic", entry["traffic"], portbench)
    limits = load_json(portbench / "limits" / f"{name}.json")
    e2e = {m["name"]: m for m in bench["end_to_end"]
           if _reports(m, name, set())}
    per_layer = {m["name"]: m for m in bench["per_layer"]
                 if _reports(m, name, set(e2e))}
    return Cell(name=name, config=config, traffic=traffic, limits=limits,
                chips=int(entry["chips"]), end_to_end=e2e,
                per_layer=per_layer)


def load_part(kind: str, name: str, portbench: Path = PORTBENCH) -> dict:
    """The data file ``<kind>/<name>.json`` (a configuration or a mix),
    whether or not a cell names it yet."""
    return load_json(portbench / kind / f"{name}.json")


def load_module(kind: str, name: str, portbench: Path = PORTBENCH):
    """The module ``<kind>/<name>.py`` under ``portbench``, loaded by
    path (a name may hold dots and dashes)."""
    path = portbench / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r}: {path} is missing")
    tag = "".join(c if c.isalnum() else "_" for c in f"{kind}_{name}")
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, portbench: Path = PORTBENCH):
    """The ``read`` function of ``metrics/<name>.py``."""
    return load_module("metrics", name, portbench).read
