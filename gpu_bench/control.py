"""The readings that a cell's limits are set from, at the cell's own size.

    python3 -m gpu_bench.control --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 1]

For each seed, in one process: the inputs, one plan, then a short window of
the program and, for the seeds in ``--control-seeds``, of the control (the
port's lower-precision path: bf16 tiles, or bf16 operands of the element
side's ``'xla'`` backend), each judged by the configuration's reference as a
run judges its window.  Prints one line per window and, last, the largest
reading of each compared number over the program's seeds (the lower reading)
and the smallest over the control's (the upper).  The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from gpu_bench import harness
from gpu_bench.cells import load_cell


def readings(cell, seeds, control_seeds, seconds, device, log=None):
    """{"program": {seed: compared}, "control": {seed: compared}}."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    out = {"program": {}, "control": {}}
    for seed in seeds:
        t0 = time.perf_counter()
        inputs = harness.make_inputs(cell, seed)
        run = harness.plan_cell(cell, inputs, device, lambda msg: None)
        for control in (False, True):
            if control and seed not in control_seeds:
                continue
            got = harness.measure(cell, inputs, run, seed, seconds, device,
                                  control=control)
            which = "control" if control else "program"
            values = {k: v["value"] for k, v in got["compared"].items()}
            out[which][seed] = values
            log(f"{cell.name} {which} seed {seed} ({run.choice} side, "
                f"{got['record'].products} products, "
                f"{time.perf_counter() - t0:.1f} s): "
                f"correct {got['correct']} {json.dumps(values)}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    got = readings(cell, seeds, control_seeds, args.seconds, device)
    summary = {}
    for name in cell.config["limits"]:
        prog = [v[name] for v in got["program"].values()]
        ctrl = [v[name] for v in got["control"].values()]
        summary[name] = {"lower": max(prog) if prog else None,
                         "upper": min(ctrl) if ctrl else None,
                         "limit": cell.config["limits"][name]}
    print(json.dumps({"workload": cell.name, "readings": got,
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
