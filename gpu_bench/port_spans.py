"""The port's own spans, as the per-layer metrics read them.

The port records its steps in memory (``spada_tpu_torch.utils.trace``):
``plan`` with its modelled seconds, ``layout.structure``, ``layout.fill``
and ``layout.upload`` always, and one ``launch`` span per kernel launch
while a profiler records, as it does over the window of a traced run.  A
reader runs in the process of the run, after it.  A port that records no
such spans gives nothing here: every function then returns None.
"""

from __future__ import annotations

from typing import List, Optional


def _spans() -> Optional[list]:
    """Every span the port has kept, or None where it keeps none."""
    try:
        from spada_tpu_torch.utils import trace
    except ImportError:
        return None
    read = getattr(trace, "spans", None)
    return read() if read is not None else None


def _outside(spans: list, name: str, outer: str) -> list:
    """The spans called ``name`` with no span called ``outer`` above them."""
    by_id = {s.id: s for s in spans}

    def inside(s):
        p = by_id.get(s.parent)
        while p is not None:
            if p.name == outer:
                return True
            p = by_id.get(p.parent)
        return False

    return [s for s in spans if s.name == name and not inside(s)]


def layout_s(name: str, self_time: bool = False) -> Optional[float]:
    """Seconds of the spans called ``name`` (``layout.*``) outside the
    planner's ``plan``, summed; with ``self_time``, each span's duration less
    its children's.  None where there is no such span."""
    spans = _spans()
    if spans is None:
        return None
    picked = _outside(spans, name, "plan")
    if not picked:
        return None
    total = sum(s.end_ns - s.start_ns for s in picked)
    if self_time:
        ids = {s.id for s in picked}
        total -= sum(s.end_ns - s.start_ns for s in spans if s.parent in ids)
    return total / 1e9


def plan_t_est_s() -> Optional[float]:
    """The modelled seconds per product of the last plan (``plan``'s
    ``t_est_s``), or None."""
    spans = _spans()
    plans = [s for s in spans or () if s.name == "plan"]
    if not plans:
        return None
    return plans[-1].attrs.get("t_est_s")


def launch_us(launches: int = 0) -> List[float]:
    """Host microseconds of the kept ``launch`` spans, the last
    ``launches`` of them where that is given (the window's launches, which
    the port counted), in the order they ended."""
    spans = _spans()
    out = [(s.end_ns - s.start_ns) / 1e3 for s in spans or ()
           if s.name == "launch"]
    return out[-launches:] if launches else out
