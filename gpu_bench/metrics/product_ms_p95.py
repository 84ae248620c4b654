"""The 95th percentile, over every product of the window, of the host clock
from a product's enqueue to the end of its ``torch.cuda.synchronize()``."""

import numpy as np


def read(rec):
    if rec.latencies_s is None or not len(rec.latencies_s):
        return None
    return float(np.percentile(rec.latencies_s, 95)) * 1e3
