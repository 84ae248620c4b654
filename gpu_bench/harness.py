"""One run of one cell: set-up, the window, the device trace and the check.

Set-up (``setup_s``): the inputs from the seed (``setup.generate``), one plan
through the port's entry (``setup.plan``), every value set's operands on the
device with its launches prepared (``setup.layout``), the kernels built and
each value set's product run twice (``setup.warmup``).

The window: a closed loop, one caller, the traffic's ``in_flight`` products
in flight (1 unless it says more).  Product i runs value set i mod K and
ends where the host's wait for it returns (a CUDA event recorded after its
launches); its latency is the host clock from its enqueue to that point.  C
stays on the device.  The window lasts ``seconds`` and ends with the
products running then.

After the window, untimed: the device's peak memory is read, the products
the window left behind (the last of each value set, and one drawn from the
seed) are mapped back to C by the port, the port's state is freed, and the
configuration's reference judges them against the limits of its ``limits``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import time
from typing import Callable, Optional

import numpy as np
import torch

from gpu_bench import counts, system
from gpu_bench.cells import Cell, load_part
from gpu_bench.csr import stream
from gpu_bench.trace import DeviceTrace

#: the product drawn from the seed is one of these, so every run holds it
HOLD_RANGE = (2, 10)


class Spans:
    """Host spans of the benchmark's own steps: ``with spans(name):``."""

    def __init__(self):
        self.done = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter_ns()
        yield
        self.done[name] = (time.perf_counter_ns() - t0) / 1e9


@dataclasses.dataclass
class Record:
    """What the metric readers read (``metrics/<name>.py``)."""

    cell: str
    device_type: str
    side: str = ""
    items: int = 0              # the side's work items (tile products or
                                # element chunks) per product
    products: int = 0
    window_s: float = 0.0
    latencies_s: np.ndarray = None
    enqueue_s: np.ndarray = None
    flop: int = 0               # useful FLOP of one product
    nbytes: int = 0             # least bytes of one product
    setup_s: float = 0.0
    compile_s: float = 0.0
    spans: dict = dataclasses.field(default_factory=dict)
    mem_peak_bytes: Optional[int] = None
    launches: int = 0           # kernel launches over the window
    trace: Optional[dict] = None
    device_ms: np.ndarray = None  # each product's device time (events)
    gaps_ms: np.ndarray = None    # the device's idle time between products


@dataclasses.dataclass
class Inputs:
    pairs: list          # [(A_s, B_s)] of the benchmark's own CSR
    port_pairs: list     # the same arrays as the port's CsrMatrix
    flop: int


def make_inputs(cell: Cell, seed: int) -> Inputs:
    """The cell's value sets from ``seed``, checked to share a structure."""
    gen = load_part("generators", cell.config["generator"])
    pairs = gen.generate(cell.config, cell.traffic, seed,
                         int(cell.traffic["value_sets"]))
    a0, b0 = pairs[0]
    if a0.shape[1] != b0.shape[0]:
        raise ValueError(f"shapes {a0.shape} @ {b0.shape}")
    for a, b in pairs[1:]:
        if not (a.same_structure(a0) and b.same_structure(b0)):
            raise ValueError("the value sets differ in structure")
    ported = {}

    def port(m):
        if id(m) not in ported:
            ported[id(m)] = system.port_csr(m)
        return ported[id(m)]

    return Inputs(pairs, [(port(a), port(b)) for a, b in pairs],
                  counts.useful_flop(a0, b0))


def plan_cell(cell: Cell, inputs: Inputs, device: torch.device, log):
    a, b = inputs.port_pairs[0]
    config = system.card_config(device, cell.config.get("port_config", {}))
    return system.plan(a, b, config, device, log)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell: Cell, inputs: Inputs, run, seed: int, seconds: float,
            device: torch.device, trace: bool = False, control: bool = False,
            spans: Optional[Spans] = None,
            origin: Optional[Callable[[], float]] = None) -> dict:
    """Prepare the side the plan chose, time the window, and judge what it
    left behind.  Returns ``{"record", "compared", "correct", "failed"}``.
    ``origin()`` gives the seconds since the run began (``setup_s``)."""
    spans = spans or Spans()
    k = len(inputs.pairs)
    with spans("setup.layout"):
        side = system.prepare(run, inputs.port_pairs, device, control)
        _sync(device)
    with spans("setup.warmup"):
        compile_s = system.compile_kernels(device)
        for s in range(k):
            for _ in range(2):
                side.product(s)
        _sync(device)
    rec = Record(cell.name, device.type, side.kind, side.items,
                 flop=inputs.flop, compile_s=compile_s)
    rec.setup_s = origin() if origin is not None else 0.0

    hold = int(stream(seed, "held.product").integers(*HOLD_RANGE))
    depth = int(cell.traffic.get("in_flight", 1))
    launches0 = system.launches()
    # the interpreter's collector stays out of the window: a full pass over
    # the heap of torch's modules would stall an enqueue for milliseconds
    gc.collect()
    gc.disable()
    try:
        with DeviceTrace(trace and device.type == "cuda") as dt:
            w = _window(side, k, depth, seconds, hold, device)
    finally:
        gc.enable()
    rec.launches = system.launches() - launches0
    stamps = np.array(w["stamps"], np.int64)    # [products, 4]
    t_enq, t_ret, t_wait, t_done = stamps.T
    rec.products = len(stamps)
    rec.window_s = (t_done[-1] - w["w0"]) / 1e9
    rec.latencies_s = (t_done - t_enq) / 1e9
    rec.enqueue_s = (t_ret - t_enq) / 1e9
    rec.device_ms, rec.gaps_ms = w["device_ms"], w["gaps_ms"]
    if device.type == "cuda":
        rec.mem_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    if dt.prof is not None:
        spans_list = sorted(
            [("window.enqueue", int(a), int(b)) for a, b in zip(t_enq, t_ret)]
            + [("window.sync", int(a), int(b))
               for a, b in zip(t_wait, t_done)], key=lambda x: x[1])
        rec.trace = dt.reduce(w["w0"], int(t_done[-1]), spans_list)
    del dt
    last, held = w["last"], w["held"]

    # after the window: map the left products back to C, free the port's
    # state, then judge
    with spans("check.readback"):
        programs = [[side.readback(last[s])] for s in range(k)]
        programs[held[0]].append(side.readback(held[1]))
        del side, last, held, w
        if device.type == "cuda":
            torch.cuda.empty_cache()
    ref = load_part("references", cell.config["reference"])
    limits = cell.config["limits"]
    worst = {name: 0 for name in limits}
    failed = 0
    nnz_c = None
    with spans("check.reference"):
        for (a, b), progs in zip(inputs.pairs, programs):
            judged = ref.judge(a, b, progs, device)
            nnz_c = judged["nnz_c"]
            for each in judged["each"]:
                failed += any(each[n] > limits[n] for n in limits)
                for n in limits:
                    worst[n] = max(worst[n], each[n])
    rec.spans = dict(spans.done)
    a0, b0 = inputs.pairs[0]
    rec.nbytes = counts.product_bytes(a0, b0, nnz_c)
    compared = {n: {"value": worst[n], "limit": limits[n]} for n in limits}
    return {"record": rec, "compared": compared,
            "correct": failed == 0, "failed": failed,
            "judged": sum(len(p) for p in programs)}


def _window(side, k: int, depth: int, seconds: float, hold: int,
            device: torch.device) -> dict:
    """The closed loop: product i runs value set i mod ``k``; ``depth``
    products are in flight, and the loop waits for the oldest before it
    enqueues another (a CUDA event per product).  The window closes at the
    first completion past ``seconds`` once product ``hold`` is done, and
    every product then in flight completes in it.  Returns ``w0`` and, per
    product, (enqueue start, enqueue end, wait start, completion) on
    ``perf_counter_ns``, the last outputs of each value set and product
    ``hold``'s as (value set, outputs); on a card, each product's device
    milliseconds and the device's idle milliseconds between products (CUDA
    events)."""
    cuda = device.type == "cuda"
    last, held, stamps, queue = [None] * k, None, [], collections.deque()
    events = []
    i, closing = 0, False
    w0 = time.perf_counter_ns()
    end = w0 + int(seconds * 1e9)
    while queue or not closing:
        if not closing:
            t0 = time.perf_counter_ns()
            if cuda:
                begin = torch.cuda.Event(enable_timing=True)
                begin.record()
            outs = side.product(i % k)
            t1 = time.perf_counter_ns()
            if cuda:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                events.append((begin, event))
            else:
                event = None
            queue.append((i, outs, event, t0, t1))
            i += 1
            if len(queue) < depth:
                continue
        j, outs, event, t0, t1 = queue.popleft()
        t2 = time.perf_counter_ns()
        if cuda:
            event.synchronize()
        t3 = time.perf_counter_ns()
        stamps.append((t0, t1, t2, t3))
        last[j % k] = outs
        if j == hold:
            held = (j % k, outs)
        if t3 >= end and j >= max(hold, k - 1):
            closing = True
    device_ms = [b.elapsed_time(e) for b, e in events]
    gaps_ms = [events[n][1].elapsed_time(events[n + 1][0])
               for n in range(len(events) - 1)]
    return {"w0": w0, "stamps": stamps, "last": last, "held": held,
            "device_ms": np.array(device_ms), "gaps_ms": np.array(gaps_ms)}


def read_metrics(entries, rec: Record) -> dict:
    """{name: {"value", "unit"}} of each metric entry whose reader finds
    something to read in ``rec``; none from a run off the card."""
    if rec.device_type != "cuda":
        return {}
    out = {}
    for m in entries:
        value = load_part("metrics", m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
