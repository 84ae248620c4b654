"""The port's spans (``spada_tpu_torch.utils.trace``): how they nest, the
bound on what is kept, when a launch records them, the profiler's view and
clock, the planner's and the executor's spans, and the export.  The file
imports no JAX; its card test runs on its own:

    python -m pytest tests/test_torch_trace.py --noconftest -q -m cuda
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spada_tpu_torch.cli import plan_spada
from spada_tpu_torch.config import h100_config
from spada_tpu_torch.convert import bsr_to_torch, stream_operands_to_torch
from spada_tpu_torch.io.workloads import random_csr
from spada_tpu_torch.ops import element_stream as es
from spada_tpu_torch.ops.element import build_esc_plan
from spada_tpu_torch.ops.engine import prepare_worklist
from spada_tpu_torch.ops.worklist import build_worklist
from spada_tpu_torch.plan.execute import execute_plan
from spada_tpu_torch.sparse.bsr import BsrMatrix
from spada_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the kernel each prepared launch calls
LAUNCHES = {"cached": "tile_spgemm", "streaming": "tile_stream",
            "panel": "tile_panel", "pallas_grid": "tile_grid",
            "element": "esc_stream_group"}


@pytest.fixture
def fresh(monkeypatch):
    """An empty store of spans and tracing off, whatever the environment."""
    monkeypatch.setattr(trace, "_done",
                        collections.deque(maxlen=trace.LIMIT))
    monkeypatch.setattr(trace, "_enabled", False)


def _prepared(kind: str, device="cpu"):
    """One launch of ``kind`` on a small random pair, prepared: operands
    and ids on ``device``."""
    a = random_csr(96, 80, 0.1, seed=11)
    b = random_csr(80, 96, 0.1, seed=12)
    if kind == "element":
        plan = build_esc_plan(a, b)
        layout = es.build_stream_layout(plan)
        ops = stream_operands_to_torch(es.stream_operands(layout, plan, a, b),
                                       device)
        return lambda: es.stream_execute(layout, ops)
    a_bsr = BsrMatrix.from_csr(a, 32, 32, dtype=np.float32)
    b_bsr = BsrMatrix.from_csr(b, 32, 128, dtype=np.float32)
    wl = build_worklist(a_bsr, b_bsr, order="row")
    return prepare_worklist(wl, bsr_to_torch(a_bsr, device),
                            bsr_to_torch(b_bsr, device), engine=kind)


def _raise_inside():
    with trace.span("outer", n=1):
        with trace.span("inner"):
            raise KeyError("x")


@pytest.mark.parametrize("raises", [False, True])
def test_spans_nest_with_parents_and_attributes(fresh, raises):
    if raises:
        with pytest.raises(KeyError):
            _raise_inside()
    else:
        with trace.span("outer", n=1) as attrs:
            with trace.span("inner"):
                pass
            attrs["late"] = 2
    with trace.span("next"):
        pass
    inner, outer, nxt = trace.spans()
    assert [s.name for s in (inner, outer, nxt)] == ["inner", "outer", "next"]
    assert inner.parent == outer.id
    assert outer.parent is None and nxt.parent is None
    assert outer.attrs == ({"n": 1} if raises else {"n": 1, "late": 2})
    assert inner.attrs == {}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert outer.end_ns <= nxt.start_ns
    assert trace.spans("inner") == [inner]


def test_the_bound_drops_the_oldest(fresh, monkeypatch):
    monkeypatch.setattr(trace, "_done", collections.deque(maxlen=3))
    for i in range(5):
        with trace.span(f"s{i}"):
            pass
    assert [s.name for s in trace.spans()] == ["s2", "s3", "s4"]
    trace.clear()
    assert trace.spans() == []


@pytest.mark.parametrize("on", [False, True])
@pytest.mark.parametrize("kind", LAUNCHES)
def test_a_prepared_launch_records_only_while_tracing(fresh, kind, on):
    call = _prepared(kind)
    # set-up spans are recorded whether tracing is on or not
    assert trace.spans("layout.structure") and trace.spans("layout.fill")
    assert trace.spans("layout.upload")
    before = len(trace.spans())
    trace.enable(on)
    call()
    new = trace.spans()[before:]
    if not on:
        assert new == []
        return
    (launch,) = [s for s in new if s.name == "launch"]
    assert launch.parent is None
    assert launch.attrs["kernel"] == LAUNCHES[kind]
    assert launch.attrs["block"] == "plain"
    assert launch.attrs["classes" if kind == "element" else "items"] > 0
    children = [s for s in new if s.parent == launch.id]
    assert [s.name for s in children] == ["launch.check", "launch.call"]
    assert len(new) == 3


def test_a_thin_launch_span_carries_its_slices(fresh):
    """The prepared ``'cached'`` launch of thin tiles (tm 32 x tk 32 x tn
    128, one slice each) builds its slice mask; every item's one slice
    holds a nonzero, so every slice runs.  Its ``launch`` span carries the
    mask's counts, and a launch with no mask carries none."""
    call = _prepared("cached")
    mask = call.mask
    assert mask.words is None
    assert mask.slices_run == mask.slices > 0
    trace.enable(True)
    call()
    (launch,) = trace.spans("launch")
    assert launch.attrs["slices"] == mask.slices
    assert launch.attrs["slices_run"] == mask.slices_run
    trace.clear()
    _prepared("streaming")()
    (launch,) = trace.spans("launch")
    assert "slices" not in launch.attrs and "slices_run" not in launch.attrs


def test_top_level_spans_show_in_the_profiler_on_its_clock(fresh):
    call = _prepared("cached")
    # the first profiler range of a process sets up the profiler's state
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        call()
    before = len(trace.spans())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("layout.structure"):
            with trace.span("layout.fill"):
                pass
        call()
    assert not trace.active()
    new = trace.spans()[before:]
    top = [s for s in new if s.parent is None]
    assert [s.name for s in top] == ["layout.structure", "launch"]
    events = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        events[e.name()].append(int(e.start_ns()))
    for s in top:
        (start,) = events[s.name]
        assert abs(start - trace.profiler_ns(s.start_ns)) < 1_000_000
    # children open no profiler range
    for name in ("layout.fill", "launch.check", "launch.call"):
        assert name in {s.name for s in new} and name not in events


@pytest.mark.parametrize("side, densify", [("tile", False), ("tile", True),
                                           ("element", False)])
def test_plan_spada_records_plan_and_execute_plan_segments(fresh, side,
                                                           densify):
    density = 0.3 if side == "tile" else 0.01
    a = random_csr(512, 512, density, seed=1)
    b = random_csr(512, 512, density, seed=2)
    run = plan_spada(a, b, h100_config(None), device="cpu", densify=densify,
                     log=lambda msg: None)
    assert run.choice == side
    (plan,) = trace.spans("plan")
    assert plan.parent is None and plan.attrs["choice"] == side
    want = (run.plan.meta["t_est"] if side == "tile"
            else run.dispatch["element"]["t_est"])
    assert plan.attrs["t_est_s"] == want > 0
    by_id = {s.id: s for s in trace.spans()}
    children = {s.name for s in by_id.values() if s.parent == plan.id}
    dispatch = trace.spans("plan.dispatch")[0]
    assert dispatch.parent == plan.id
    assert trace.spans("plan.tile_edge")[0].parent == dispatch.id
    assert children == ({"plan.dispatch", "plan.panels"} if side == "tile"
                        else {"plan.dispatch"}) | (
                            {"plan.densify"} if densify else set())
    if side == "element":
        return
    trace.clear()
    execute_plan(run.a, run.b, run.plan, run.config, device="cpu")
    segments = trace.spans("segment")
    assert len(segments) == len(run.plan.tm_histogram())
    for s in segments:
        assert s.parent is None
        assert set(s.attrs) == {"tm", "n_panels", "work_items", "c_tiles"}
        assert s.attrs["tm"] in run.plan.tm_histogram()
        assert s.attrs["work_items"] > 0
    # tracing off: the executor's launches record nothing
    assert trace.spans("launch") == []


def test_trace_env_writes_one_document_at_exit(tmp_path):
    code = ("import torch\n"
            "from spada_tpu_torch.ops.engine import tile_spgemm\n"
            "from spada_tpu_torch.utils import trace\n"
            "with trace.span('outer', n=3):\n"
            "    with trace.span('inner'):\n"
            "        pass\n"
            "ids = torch.zeros(1, dtype=torch.int32)\n"
            "tile_spgemm(torch.ones(1, 8, 8), torch.ones(1, 8, 8), ids, ids,\n"
            "            torch.tensor([0, 1], dtype=torch.int32))\n"
            "trace.dump(%r)\n" % str(tmp_path / "dump.json"))
    env = dict(os.environ, SPADA_TRACE="1", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == ""
    lines = out.stderr.splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    with open(tmp_path / "dump.json") as f:
        dumped = json.load(f)
    assert doc["clock"] == dumped["clock"] == "perf_counter_ns"
    assert doc["spans"] == dumped["spans"]
    names = [s[doc["fields"].index("name")] for s in doc["spans"]]
    assert names.count("launch") == 1 and "outer" in names
    assert names.count("launch.check") == names.count("launch.call") == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_start_after_their_launch_span(cuda_device, fresh):
    """On the card, under a profiler of the device alone (as a traced
    window runs), each launch's kernel starts after its ``launch`` span
    began, on the profiler's clock."""
    calls = [_prepared(kind, cuda_device) for kind in LAUNCHES]
    # the first profiler of a process starts the device's tracing
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        for call in calls:
            call()
        torch.cuda.synchronize()
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            for call in calls:
                call()
        torch.cuda.synchronize()
    launches = trace.spans("launch")
    assert len(launches) == 3 * len(calls)
    assert {s.attrs["kernel"] for s in launches} == set(LAUNCHES.values())
    assert all(s.attrs.get("block") != "plain" for s in launches)
    begun = sorted(trace.profiler_ns(s.start_ns) for s in launches)
    kernels = sorted(
        int(e.start_ns()) for e in prof.profiler.kineto_results.events()
        if str(e.device_type()).rsplit(".", 1)[-1] == "CUDA"
        and any(k in e.name() for k in ("tile_", "esc_stream")))
    assert 0 < len(kernels) <= len(launches)
    # the i-th kernel to start had i + 1 launches begun before it
    for i, start in enumerate(kernels):
        assert begun[i] <= start
