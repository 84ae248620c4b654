"""Host seconds from the plan to every value set's operands on the device
with its launches prepared, synchronised (the ``setup.layout`` span)."""


def read(rec):
    return rec.spans.get("setup.layout")
