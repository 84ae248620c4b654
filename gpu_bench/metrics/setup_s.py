"""Seconds from the process's start to the first timed product: imports, the
card's start, the inputs, the plan, the layout and upload, the kernels'
build where one is due, and the warm-up."""


def read(rec):
    return rec.setup_s or None
