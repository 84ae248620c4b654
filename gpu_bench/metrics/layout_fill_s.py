"""Host seconds the port spent filling value sets into the layout (its
``layout.fill`` spans outside planning: BSR tile scatters, the element
side's operand gather), summed."""

from gpu_bench import port_spans


def read(rec):
    return port_spans.layout_s("layout.fill")
