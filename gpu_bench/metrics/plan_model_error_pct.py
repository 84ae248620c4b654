"""How far the planner's model missed the device: |the plan's modelled
seconds per product (the port's ``plan`` span, ``t_est_s``) - the traced
device seconds per product| over the latter, in percent.  Device seconds:
every operation of the traced window over the products it completed."""

from gpu_bench import port_spans


def read(rec):
    if rec.trace is None or rec.trace["op_s"] <= 0 or not rec.products:
        return None
    t_est = port_spans.plan_t_est_s()
    if t_est is None:
        return None
    device = rec.trace["op_s"] / rec.products
    return 100 * abs(t_est - device) / device
