"""The product's least time over the device time it took, in percent.

Least time: the larger of the useful FLOP over the card's f32 peak and the
least bytes (the inputs read once, C written once, in CSR form) over its HBM
bandwidth, both counted from the cell's inputs (``counts``).  Device time:
every operation the device ran in the traced window, whatever its name, over
the products the window completed."""

from gpu_bench.counts import least_time


def read(rec):
    if rec.trace is None or rec.trace["op_s"] <= 0 or not rec.products:
        return None
    return 100 * least_time(rec.flop, rec.nbytes)[0] / (
        rec.trace["op_s"] / rec.products)
