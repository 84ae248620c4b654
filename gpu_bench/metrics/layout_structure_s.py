"""Host seconds the port spent laying out the structure (its
``layout.structure`` spans outside planning: segments' tiles and worklists,
value maps, the element plan and stream layout), each span's self time:
its duration less its children's."""

from gpu_bench import port_spans


def read(rec):
    return port_spans.layout_s("layout.structure", self_time=True)
