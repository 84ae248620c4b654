"""The device trace of a window, from ``torch.profiler``'s CUDA activity
(CUPTI), reduced to what the metrics read: the time in which an operation ran
on the device, each operation's total, and the idle gaps, each named by the
host span that was open at its middle.
"""

from __future__ import annotations

import bisect
import collections
import time

import torch

#: the most entries of each list in the result's ``breakdown``
TOP = 10


class DeviceTrace:
    """``with DeviceTrace(on):`` records the device's operations while on."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def __enter__(self):
        if self.on:
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
        # host clocks at one instant: the trace's timestamps are on one of
        # the first two, spans on the third
        self.anchor = (time.time_ns(), time.monotonic_ns(),
                       time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.stop()
        return False

    def device_events(self):
        """[(start_ns, end_ns, name)] of every device operation recorded."""
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if str(e.device_type()).rsplit(".", 1)[-1] == "CUDA":
                start = int(e.start_ns())
                out.append((start, start + int(e.duration_ns()), e.name()))
        return out

    def reduce(self, w0_perf: int, w1_perf: int, spans) -> dict:
        """The window [w0_perf, w1_perf] (perf_counter ns) as traced:
        ``busy_s``, ``window_s``, ``device_ops`` and ``idle_gaps`` (the
        longest, each named by the span of ``spans`` — (name, start, end)
        in perf_counter ns, sorted — open at its middle, else
        ``"window"``), and ``clock``, the host clock the trace is on."""
        events = self.device_events()
        wall, mono, perf = self.anchor
        best = None
        for clock, base in (("time_ns", wall), ("monotonic_ns", mono)):
            off = base - perf
            w0, w1 = w0_perf + off, w1_perf + off
            inside = sum(1 for s, e, _ in events if s < w1 and e > w0)
            if best is None or inside > best[0]:
                best = (inside, clock, off)
        _, clock, off = best
        w0, w1 = w0_perf + off, w1_perf + off
        ivs = sorted((max(s, w0), min(e, w1), n) for s, e, n in events
                     if s < w1 and e > w0)
        per_op = collections.Counter()
        for s, e, n in ivs:
            per_op[n] += (e - s) / 1e9
        merged = []
        for s, e, _ in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged) / 1e9
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        starts = [s + off for _, s, _ in spans]

        def name_at(t):
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < spans[i][2] + off:
                return spans[i][0]
            return "window"

        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        return {
            "busy_s": busy,
            "window_s": (w1 - w0) / 1e9,
            "op_s": sum(per_op.values()),
            "device_ops": [[n, t] for n, t in per_op.most_common(TOP)],
            "idle_gaps": [[name_at((s + e) // 2), (e - s) / 1e9]
                          for s, e in gaps[:TOP]],
            "clock": clock,
            "events": len(ivs),
        }
