"""The share of the tile kernels' multiply-adds that the product needs:
100 x the useful FLOP / 2 of every product the window completed over the
``macs`` of the window's ``launch`` spans that carry them, summed (``macs``:
tm x tk x tn per item of a tile launch, scaled by the k-slices run where
the thin block skips A's all-zero slices), in percent.  The rest is padding:
the zeros of partly filled tiles, and rows rounded up to the panel height.
None where no launch span of the window carries ``macs``, as on a port that
counts none."""

from gpu_bench import port_spans


def read(rec):
    launches = [s for s in port_spans._spans() or () if s.name == "launch"]
    if rec.launches:
        launches = launches[-rec.launches:]
    macs = sum(s.attrs["macs"] for s in launches if "macs" in s.attrs)
    if not macs or not rec.products:
        return None
    return 100 * rec.flop / 2 * rec.products / macs
