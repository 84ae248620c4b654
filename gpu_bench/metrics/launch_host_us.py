"""The median host time of the window's kernel launches, from a wrapper's
entry to its return (the port's ``launch`` spans, recorded while the
traced window's profiler runs), in microseconds."""

import numpy as np

from gpu_bench import port_spans


def read(rec):
    us = port_spans.launch_us(rec.launches)
    return float(np.median(us)) if us else None
