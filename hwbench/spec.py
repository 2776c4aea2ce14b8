"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout names each cell's configuration and traffic mix, and the
files under ``hwbench/`` hold them:

* ``configs/<config>.json``: the model, the engine and the precision;
* ``traffic/<mix>.json``: the product, the pairs a request prices, the
  requests in flight, the warm-up and the requests checked;
* ``products/<product>.py``: the adapter from the product to the port's
  pricer, and its plain reference;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``work/<kernel>.py``: the work of one launch of a kernel, which the
  roofline reads;
* ``limits/<workload>.json``: the limit of each number ``correct``
  compares.

Nothing here imports the program.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    workload: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list    # the cell's end-to-end metric entries
    per_layer: list     # the cell's per-layer metric entries
    limits: dict


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of the manifest at ``root``, with its data."""
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in man["configs"]}
    base = root / "hwbench"
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())
    return Cell(workload, int(w["chips"]), config, traffic,
                [m for m in man["end_to_end"] if _reports(m, workload)],
                [m for m in man["per_layer"] if _reports(m, workload)],
                limits)


def load_module(kind: str, name: str, root: Path = ROOT):
    """``hwbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = root / "hwbench" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"hwbench_{kind}_{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
