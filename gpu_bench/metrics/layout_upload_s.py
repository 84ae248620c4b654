"""Host seconds the port spent copying tiles, operands and worklist ids to
the device (its ``layout.upload`` spans outside planning), summed."""

from gpu_bench import port_spans


def read(rec):
    return port_spans.layout_s("layout.upload")
