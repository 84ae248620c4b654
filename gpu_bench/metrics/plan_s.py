"""Host seconds of the port's planning: ``cli.plan_spada`` (dispatch, tile
edge, panel plan) around which the benchmark keeps its ``setup.plan``
span."""


def read(rec):
    return rec.spans.get("setup.plan")
