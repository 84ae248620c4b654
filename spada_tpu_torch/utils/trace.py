"""Structured tracing — the rebuild of the ``trace_exec`` feature.

The reference compiles ``trace_println!`` macros in or out at build time
(util.rs:1-24, Cargo.toml:20-22) and dumps per-cycle cache occupancy and
per-task anchors/shapes.  Here tracing is a runtime switch
(``SPADA_TRACE=1`` or :func:`enable`) emitting structured records; the
per-block cost attribution records are the same feedback signal the adaptive
planner consumes (simulator.rs:589-603).

:func:`profile` records a ``torch.profiler`` timeline of the host and the
CUDA device.

Copy of :mod:`spada_tpu.utils.trace` for spada_tpu_torch; only
:func:`profile` differs: it runs ``torch.profiler`` where the reference runs
``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

_enabled = os.environ.get("SPADA_TRACE", "") not in ("", "0")
_records: List[Dict[str, Any]] = []
_sink = None  # None = current sys.stderr at emit time


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def is_enabled() -> bool:
    return _enabled


def emit(kind: str, **fields) -> None:
    """Emit one structured trace record (no-op unless tracing is enabled)."""
    if not _enabled:
        return
    rec = {"t": time.perf_counter(), "kind": kind, **fields}
    _records.append(rec)
    try:
        print(json.dumps(rec), file=_sink or sys.stderr)
    except ValueError:
        pass  # sink closed (test harness teardown) — records still kept


def records(kind: Optional[str] = None) -> List[Dict[str, Any]]:
    return [r for r in _records if kind is None or r["kind"] == kind]


def clear() -> None:
    _records.clear()


@contextlib.contextmanager
def profile(logdir: str):
    """Host and CUDA profiler timeline (``torch.profiler``), written to
    ``logdir`` as a Chrome trace (``chrome://tracing``, Perfetto)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def span(kind: str, **fields):
    """Trace a wall-clock span; emits ``<kind>`` with ``dur_s`` on exit."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        emit(kind, dur_s=time.perf_counter() - t0, **fields)
