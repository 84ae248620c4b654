"""Kernel launches the port counted (``spada_tpu_torch._build.launches``,
its ``_thin`` duplicates left out) over the window, per product."""


def read(rec):
    if not rec.products:
        return None
    return rec.launches / rec.products
