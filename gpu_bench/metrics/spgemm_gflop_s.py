"""Useful GFLOP of every product the window completed, over the window's
seconds (host clock).  A product's useful FLOP is counted from the cell's
inputs (``counts.useful_flop``), whatever the plan or the engine."""


def read(rec):
    if not rec.products or rec.window_s <= 0:
        return None
    return rec.products * rec.flop / rec.window_s / 1e9
