"""The share of the traced window in which no operation ran on the device,
in percent (``torch.profiler``'s CUDA activity)."""


def read(rec):
    if rec.trace is None or rec.trace["window_s"] <= 0:
        return None
    return 100 * (1 - rec.trace["busy_s"] / rec.trace["window_s"])
