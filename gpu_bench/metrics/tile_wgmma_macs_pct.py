"""The share of the tile kernels' multiply-adds that ran on the warpgroup
block of ``tile_spgemm``: 100 x the ``macs`` of the window's ``launch``
spans whose ``block`` is the warpgroup block's (``mma_wg``) over the
``macs`` of all the window's ``launch`` spans that carry them, in percent.
0 where every tile launch ran on another block, as on a port without the
block; None where no launch span of the window carries ``macs``."""

from gpu_bench import port_spans

#: the name the port gives the warpgroup block (``ops.engine._BLOCKS``)
WG_BLOCK = "mma_wg"


def read(rec):
    launches = [s for s in port_spans._spans() or () if s.name == "launch"]
    if rec.launches:
        launches = launches[-rec.launches:]
    tile = [s.attrs for s in launches if "macs" in s.attrs]
    total = sum(a["macs"] for a in tile)
    if not total:
        return None
    return 100 * sum(a["macs"] for a in tile
                     if a.get("block") == WG_BLOCK) / total
