"""The 99th percentile of the host time of the window's kernel launches
(the port's ``launch`` spans, as ``launch_host_us``), in microseconds."""

import numpy as np

from gpu_bench import port_spans


def read(rec):
    us = port_spans.launch_us(rec.launches)
    return float(np.percentile(us, 99)) if us else None
