"""The readers of the port's spans (``port_spans`` and the six metrics that
use it): a tiny CPU run of each side with tracing on gives each a number, a
run without the spans gives None, and the layout's spans all end before the
window's launches begin."""

import collections

import pytest
import torch

from gpu_bench import harness, port_spans
from gpu_bench.cells import load_cell, load_part
from gpu_bench.tests.test_gpu_bench_faults import CELLS, TINY
from spada_tpu_torch.utils import trace

METRICS = ("plan_model_error_pct", "layout_structure_s", "layout_fill_s",
           "layout_upload_s", "launch_host_us", "launch_host_p99_us")
LAYOUT = ("layout.structure", "layout.fill", "layout.upload")
CPU = torch.device("cpu")


@pytest.fixture
def fresh(monkeypatch):
    """An empty store of spans, tracing on."""
    monkeypatch.setattr(trace, "_done",
                        collections.deque(maxlen=trace.LIMIT))
    monkeypatch.setattr(trace, "_enabled", True)


def _measure(name, seed=5):
    config, traffic, side = TINY[name]
    cell = load_cell(name)
    cell.config.update(config)
    cell.traffic.update(traffic)
    inputs = harness.make_inputs(cell, seed)
    run = harness.plan_cell(cell, inputs, CPU, lambda msg: None)
    assert run.choice == side
    out = harness.measure(cell, inputs, run, seed, 0.02, CPU)
    rec = out["record"]
    # a device trace as a card's traced window would give it
    rec.trace = {"op_s": 1e-4 * rec.products, "busy_s": 0.0, "window_s": 1.0}
    return rec


@pytest.mark.parametrize("name", CELLS)
def test_each_reader_reads_a_traced_run(fresh, name):
    rec = _measure(name)
    got = {m: load_part("metrics", m).read(rec) for m in METRICS}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    layout = sum(got[f"layout_{k}_s"] for k in ("structure", "fill",
                                                "upload"))
    assert layout <= rec.spans["setup.layout"]
    assert got["launch_host_us"] <= got["launch_host_p99_us"]
    # every launch of the run: two per value set of warm-up, then the window
    assert len(port_spans.launch_us()) == 2 * 2 + rec.products
    launches = trace.spans("launch")
    for s in trace.spans():
        if s.name in LAYOUT:
            assert s.end_ns <= launches[0].start_ns

    trace.clear()
    assert {m: load_part("metrics", m).read(rec)
            for m in METRICS} == dict.fromkeys(METRICS)


def test_readers_of_a_port_without_spans(monkeypatch):
    """A port whose trace module keeps no spans gives every reader None."""
    monkeypatch.delattr(trace, "spans")
    rec = harness.Record("c", "cuda", products=4, launches=4,
                         trace={"op_s": 1.0, "busy_s": 1.0, "window_s": 1.0})
    assert port_spans.launch_us() == []
    assert {m: load_part("metrics", m).read(rec)
            for m in METRICS} == dict.fromkeys(METRICS)


def test_readers_of_a_fake_record(fresh):
    with trace.span("plan", choice="tile", t_est_s=2e-3):
        with trace.span("layout.structure"):    # the planner's, left out
            pass
    with trace.span("layout.structure"):
        with trace.span("layout.fill"):
            pass
    for kernel in ("tile_spgemm",) * 3:
        t = trace.launch(kernel, items=1)
        t.end()
    rec = harness.Record("c", "cuda", products=10, launches=2,
                         trace={"op_s": 1e-2, "busy_s": 1e-2,
                                "window_s": 1.0})
    read = {m: load_part("metrics", m).read(rec) for m in METRICS}
    assert read["plan_model_error_pct"] == pytest.approx(100.0)
    structure, fill = (trace.spans(n)[-1] for n in LAYOUT[:2])
    assert read["layout_structure_s"] == pytest.approx(
        (structure.end_ns - structure.start_ns
         - (fill.end_ns - fill.start_ns)) / 1e9)
    assert read["layout_fill_s"] == pytest.approx(
        (fill.end_ns - fill.start_ns) / 1e9)
    assert read["layout_upload_s"] is None
    assert len(port_spans.launch_us(rec.launches)) == 2
    rec.trace = None
    assert load_part("metrics", "plan_model_error_pct").read(rec) is None
