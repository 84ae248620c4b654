"""One run of one cell of the benchmark on the card.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted`` (products in the window),
``failed`` (products the reference judged wrong), ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, ``setup_parts_s`` (the set-up's spans and,
apart, the kernels' build and load: the first run of a checkout builds them),
and last ``compared``: each number the reference compared beside its limit,
which also end standard error.  Exits
with another code than 0, and prints no result, where no card is found, the
cell asks for more cards than there are, or ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``spada_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_T0 = time.perf_counter()

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "spada_tpu")


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def power_limit_w():
    """The card's power limit in W, by ``nvidia-smi``; None where it cannot
    be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from gpu_bench.cells import load_cell

    cell = load_cell(args.workload)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: torch.cuda.is_available() is False")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} found")
        return 2

    from gpu_bench import counts, harness

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.init()
    spans = harness.Spans()
    with spans("setup.generate"):
        inputs = harness.make_inputs(cell, args.seed)
    torch.cuda.reset_peak_memory_stats(device)
    with spans("setup.plan"):
        run = harness.plan_cell(cell, inputs, device, log)
    log(f"{cell.name}: seed {args.seed}, the {run.choice} side")
    out = harness.measure(cell, inputs, run, args.seed, args.seconds, device,
                          trace=bool(args.trace), spans=spans,
                          origin=process_age_s)
    found = forbidden_modules()
    if found:
        log(f"loaded in the run: {', '.join(found)}")
        return 3
    rec = out["record"]
    entries = cell.per_layer if args.trace else cell.end_to_end
    name = torch.cuda.get_device_name(device)
    limit_w = power_limit_w()
    device_info = {"platform": "gpu", "kind": name, "count": 1,
                   "memory_peak_bytes": rec.mem_peak_bytes,
                   "power_limit_w": limit_w}
    result = {"correct": out["correct"], "attempted": rec.products,
              "failed": out["failed"],
              "metrics": harness.read_metrics(entries, rec),
              "device": device_info}
    if rec.trace is not None:
        device_info["busy_s"] = rec.trace["busy_s"]
        device_info["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    result["setup_parts_s"] = {"kernels.build_and_load": rec.compile_s,
                               **{k: v for k, v in rec.spans.items()
                                  if k.startswith("setup.")}}
    result["compared"] = out["compared"]
    log(f"{cell.name}: {rec.products} products in {rec.window_s:.3f} s on "
        f"{name} ({limit_w} W), setup {rec.setup_s:.3f} s of which the "
        f"kernels' build and load {rec.compile_s:.3f} s; spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in rec.spans.items()))
    if rec.trace is not None:
        log(f"trace: {rec.trace['events']} device operations in the window, "
            f"on the {rec.trace['clock']} clock")
    bound = counts.least_time(rec.flop, rec.nbytes)
    log(f"one product: {rec.flop} useful FLOP, {rec.nbytes} least bytes, "
        f"least time {bound[0] * 1e3:.6f} ms ({bound[1]}); the {rec.side} "
        f"side's {rec.items} work items")
    if len(rec.device_ms):
        dm, gm = rec.device_ms, rec.gaps_ms
        log(f"device per product (events): median {np.median(dm):.4f} ms, "
            f"p95 {np.percentile(dm, 95):.4f}, max {dm.max():.4f}; idle "
            f"between products {gm.sum():.3f} ms in all, longest "
            f"{gm.max(initial=0):.3f} ms, {int((gm > 1).sum())} over 1 ms")
    log(f"judged {out['judged']} products")
    for k, v in out["compared"].items():
        log(f"compared {k}: {v['value']} limit {v['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
