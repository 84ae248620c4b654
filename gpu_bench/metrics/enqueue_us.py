"""The median over the window's products of the host time from a product's
start to the return of its last launch call, before the synchronise (the
``window.enqueue`` spans), in microseconds."""

import numpy as np


def read(rec):
    if rec.enqueue_s is None or not len(rec.enqueue_s):
        return None
    return float(np.median(rec.enqueue_s)) * 1e6
