"""The share of the thin tile block's k-slice steps that the window's
``tile_spgemm`` launches ran: 100 x the ``slices_run`` over the ``slices``
of the window's ``launch`` spans that carry them, summed (``slices``: the
steps of every item without the mask of A's all-zero slices; ``slices_run``:
with it), in percent.  None where no launch span of the window carries
them, as on a port that builds no mask."""

from gpu_bench import port_spans


def read(rec):
    launches = [s for s in port_spans._spans() or () if s.name == "launch"]
    if rec.launches:
        launches = launches[-rec.launches:]
    masked = [s.attrs for s in launches
              if "slices" in s.attrs and "slices_run" in s.attrs]
    total = sum(a["slices"] for a in masked)
    if not total:
        return None
    return 100 * sum(a["slices_run"] for a in masked) / total
