"""BENCHMARK.json against the benchmark's contract, every part found by
name, and no JAX in a run."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from gpu_bench import cells

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")


def test_names_units_and_entry_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                               for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(set(names)) == len(names)
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        seen.add(m["name"])
    assert "setup_s" in seen


@pytest.mark.parametrize("name", CELLS)
def test_every_part_of_a_cell_is_found_by_name(name):
    cell = cells.load_cell(name, BENCH)
    config = next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    config_entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert config_entry["file"].startswith(BENCH["paths"][0] + "/")
    assert cell.config["source"] == config_entry["source"]
    assert cell.config["reduced"] == config_entry["reduced"]
    cells.load_part("generators", cell.config["generator"]).generate
    cells.load_part("references", cell.config["reference"]).judge
    for m in cell.end_to_end + cell.per_layer:
        cells.load_part("metrics", m["name"]).read
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e


def test_a_run_loads_no_jax():
    """A run's modules, the port's included, after a tiny run of each side
    on the CPU: no top-level name, compared whole, is jax, jaxlib, flax or
    spada_tpu (spada_tpu_torch begins with it and is fine)."""
    code = (
        "import torch, sys\n"
        "from gpu_bench import run, harness, cells, control\n"
        "for name, cfg, tr in (('opt-1.3b-fc2-blk32.prefill-16k', "
        "{'hidden_size': 256, 'ffn_dim': 1024}, {'tokens': 2048}), "
        "('graph500-s14-sym.a2-reuse', {'scale': 8}, {})):\n"
        "    c = cells.load_cell(name)\n"
        "    c.config.update(cfg); c.traffic.update(tr)\n"
        "    i = harness.make_inputs(c, 1)\n"
        "    r = harness.plan_cell(c, i, torch.device('cpu'), print)\n"
        "    harness.measure(c, i, r, 1, 0.01, torch.device('cpu'))\n"
        "    print(name, r.choice)\n"
        "print('FOUND', run.forbidden_modules())\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "opt-1.3b-fc2-blk32.prefill-16k tile" in out.stdout
    assert "graph500-s14-sym.a2-reuse element" in out.stdout
    assert "FOUND []" in out.stdout


def test_forbidden_names_are_compared_whole(monkeypatch):
    from gpu_bench import run

    fine = ("spada_tpu_torch", "spada_tpu_torch.ops", "jaxtyping", "flaxen")
    for name in fine:
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(fine) & set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "spada_tpu.ops", sys)
    assert "spada_tpu.ops" in run.forbidden_modules()
