"""Find a cell's parts by the names ``BENCHMARK.json`` gives them.

A cell is an entry of ``workloads``: a configuration (``configs`` entry, its
``file`` a JSON object) under a traffic mix (``traffic/<mix>.json``).  The
configuration names its generator (``generators/<name>.py``, a function
``generate(config, traffic, seed, value_sets)``) and its reference
(``references/<name>.py``, a function ``judge(a, b, programs, device)``).
Each metric is read by ``metrics/<name>.py``, a function ``read(rec)``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list      # this cell's metric entries of BENCHMARK.json
    per_layer: list


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default)."""
    bench = bench if bench is not None else load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(REPO / cfg["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def load_part(kind: str, name: str):
    """The module ``<kind>/<name>.py`` of the benchmark (names may hold
    ``.`` and ``-``)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    mod_name = f"gpu_bench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
