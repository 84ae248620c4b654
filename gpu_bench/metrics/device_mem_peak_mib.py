"""``torch.cuda.max_memory_allocated()`` from the start of planning to the
window's end, in MiB; the reference's check comes after and is not in it."""


def read(rec):
    if rec.mem_peak_bytes is None:
        return None
    return rec.mem_peak_bytes / 2**20
