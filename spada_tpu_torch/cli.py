"""Command-line driver of the port: ``spada_tpu.cli`` on PyTorch, with a
``--device`` flag.

    python -m spada_tpu_torch.cli run spada SS cari config/default.json
    python -m spada_tpu_torch.cli run spada SS cari config/default.json --device cpu
    python -m spada_tpu_torch.cli run spada SS cari config/default.json --plan-scheme profiled
    python -m spada_tpu_torch.cli plan spada SS cari config/default.json
    python -m spada_tpu_torch.cli plan spada SS cari config/default.json --card --device cpu
    python -m spada_tpu_torch.cli traffic spada SS cari config/default.json

``build_parser``, ``load_workload``, ``_print_gemm_stats``,
``_print_first_rows``, ``_tile_bytes``, ``cmd_traffic`` and ``cmd_breuse``
are copies of the reference CLI's, held equal to it by
``tests/test_torch_host.py``.  The ``run`` mode replaces the roofline
constants, the per-item terms, the element path's fixed term and the tile
side's card terms of the config by the card's profile (its datasheet
peaks, the fits for the tile dtype and the element fit,
:func:`spada_tpu_torch.config.card_config`), so that it plans under the
card's model (:mod:`spada_tpu_torch.plan.card_model`), and reports the device time
of the multiply (:func:`~spada_tpu_torch.ops.spgemm.measure_device_perf`); on the
CPU, which has no device time, the wall time of a warm rerun.  ``plan``
prints the panel plan without executing it, the reference's plan at the
config's tile edge, or with ``--card`` the plan ``run`` executes
(:func:`plan_spada`); under ``--plan-scheme
profiled`` (in ``run`` too) the planner times the tile engine on
``--device`` (:func:`~spada_tpu_torch.plan.execute.make_profiled_measure`).
The ``traffic`` and ``breuse`` modes run the functional traffic model on
the host, as the reference's do.

:func:`run_spada` is the adaptive main path, shared with ``chip_smoke.py``:
tile/element dispatch -> tile-edge choice -> (optional densify) -> panel
plan (:func:`plan_spada`) -> execution.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from spada_tpu_torch.config import SpadaConfig, card_config
from spada_tpu_torch.convert import check_device
from spada_tpu_torch.io.workloads import GemmWorkload, load_pickled_gemms
from spada_tpu_torch.ops.spgemm import dispatch_dataflow, spgemm
from spada_tpu_torch.plan.planner import ExecutionPlan
from spada_tpu_torch.sparse.csr import CsrMatrix
from spada_tpu_torch.utils import trace
from spada_tpu_torch.utils.metrics import PerfReport, format_report


@dataclasses.dataclass
class SpadaRun:
    """What :func:`run_spada` ran and produced."""

    result: object                  # SpGemmResult (element) | PlanResult
    choice: str                     # engine used: 'tile' | 'element'
    config: SpadaConfig             # as run (tile edge re-chosen)
    dispatch: Optional[dict]        # dispatch_dataflow details, if it ran
    plan: Optional[ExecutionPlan]   # the panel plan (tile side)
    a: CsrMatrix                    # operands as run (after densify)
    b: CsrMatrix
    # densify's row permutation: row i of the result is input row
    # row_remap[i]; None when rows kept their order
    row_remap: Optional[np.ndarray] = None


def plan_spada(a: CsrMatrix, b: CsrMatrix, config: SpadaConfig,
               device="cuda", densify: bool = False,
               log: Callable[[str], None] = print,
               scheme: str = "analytic") -> SpadaRun:
    """The decisions of :func:`run_spada`, without the multiply: dispatch ->
    tile edge -> (densify) -> panel plan (``result`` None).  The tile edge
    and the plan come from :func:`~spada_tpu_torch.plan.card_model.
    planner_for`'s pair and the layout from :func:`~spada_tpu_torch.plan.
    card_densify.densify_workload`: the card's model under a
    ``CardConfig``, the reference's ``choose_tile_size``, ``plan_spgemm``
    and ``choose_densify`` under a ``SpadaConfig``.  ``config`` is copied,
    not changed; ``device`` is where ``scheme='profiled'`` times the tile
    engine.  Recorded as the span ``plan`` (attributes ``choice`` and
    ``t_est_s``, the modelled seconds of the chosen side where a model
    priced it) with the children ``plan.dispatch``, ``plan.tile_edge``,
    ``plan.densify`` and ``plan.panels``."""
    with trace.span("plan") as attrs:
        run = _plan_spada(a, b, config, device, densify, log, scheme)
        attrs["choice"] = run.choice
        if run.plan is not None:
            t_est = run.plan.meta.get("t_est")
        else:
            t_est = run.dispatch and run.dispatch["element"]["t_est"]
        if t_est is not None:
            attrs["t_est_s"] = t_est
    return run


def _plan_spada(a: CsrMatrix, b: CsrMatrix, config: SpadaConfig, device,
                densify: bool, log: Callable[[str], None],
                scheme: str) -> SpadaRun:
    from spada_tpu_torch.plan.card_densify import densify_workload
    from spada_tpu_torch.plan.card_model import planner_for

    config = dataclasses.replace(config)
    dev = check_device(device)
    tile_size, planner = planner_for(config)
    det = None
    choice = "tile"
    if config.element_dispatch == "always":
        choice = "element"
        log("dataflow dispatch: element (forced by element_dispatch)")
    elif config.element_dispatch == "auto":
        with trace.span("plan.dispatch"):
            choice, det = dispatch_dataflow(a, b, config)
        if choice == "element":
            log(f"dataflow dispatch: element "
                f"(E={det['element']['e_products']}, modeled "
                f"{det['element']['t_est']*1e3:.2f}ms vs tile "
                f"{min(v['t_est'] for v in det['tile'].values())*1e3:.2f}ms)")
    if choice == "element":
        return SpadaRun(None, "element", config, det, None, a, b)

    if det is not None:
        t_best, t_det = det["tile_T"], det["tile"]
    else:
        with trace.span("plan.tile_edge"):
            t_best, t_det = tile_size(a, b, config)
    row_remap = None
    if densify:
        with trace.span("plan.densify"):
            w2, dplan = densify_workload(GemmWorkload("run", a, b), config,
                                         t_best)
        if dplan.is_identity:
            log("densify: identity (structure already aligned)")
        else:
            log(f"densify: {dplan.candidate}")
            a, b, row_remap = w2.a, w2.b, w2.row_remap
            with trace.span("plan.tile_edge"):
                t_best, t_det = tile_size(a, b, config)
    if t_best != config.tile_k:
        config.tile_k = config.tile_n = t_best
        config.default_tm = t_best
        config.tm_choices = tuple(
            t for t in config.tm_choices if t <= t_best) + (t_best,)
    ests = ", ".join(f"{k}: {'>=' if v.get('bound') else ''}"
                     f"{v['t_est'] * 1e3:.2f}ms" for k, v in t_det.items())
    log(f"tile size: {t_best}  (model: {ests})")
    with trace.span("plan.panels"):
        measure = None
        if scheme == "profiled":
            from spada_tpu_torch.plan.execute import make_profiled_measure

            measure = make_profiled_measure(a, b, config, dev)
        plan = planner(a, b, config, scheme=scheme, measure=measure)
    t_est = plan.meta.get("t_est")
    log(f"plan[{scheme}]: {len(plan.panels)} panels, "
        f"tm histogram {plan.tm_histogram()}"
        + ("" if t_est is None else f", model {t_est * 1e3:.4f} ms"))
    return SpadaRun(None, "tile", config, det, plan, a, b, row_remap)


def run_spada(a: CsrMatrix, b: CsrMatrix, config: SpadaConfig,
              device="cuda", densify: bool = False,
              log: Callable[[str], None] = print,
              scheme: str = "analytic") -> SpadaRun:
    """The adaptive ``spada`` dataflow, as ``spada_tpu.cli``'s ``run`` mode
    sequences it: :func:`plan_spada` (dispatch -> tile edge -> panel plan,
    under ``scheme``, 'analytic' or 'profiled'), then ``spgemm(plan=)``, or
    the element side where dispatch sends the pair.  ``config`` is copied,
    not changed."""
    run = plan_spada(a, b, config, device, densify, log, scheme)
    dev = check_device(device)
    if run.choice == "element":
        res = spgemm(run.a, run.b, run.config, dataflow="element", device=dev)
    else:
        res = spgemm(run.a, run.b, run.config, dataflow="spada",
                     plan=run.plan, device=dev)
    return dataclasses.replace(run, result=res)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spada_tpu",
        description="TPU-native adaptive-dataflow SpGEMM (spada-sim rebuilt)",
    )
    p.add_argument("mode", choices=["run", "traffic", "breuse", "plan"])
    p.add_argument("dataflow",
                   choices=["ip", "op", "rowwise", "spada", "element"],
                   help="dataflow / accelerator analog (element = "
                        "ESC engine for scattered sparsity)")
    p.add_argument("category", choices=["SS", "NN", "ss", "nn"])
    p.add_argument("workload", help="matrix name (SS) or gemm name (NN)")
    p.add_argument("config", nargs="?", default=None, help="config JSON path")
    p.add_argument("-p", "--preprocess", action="store_true",
                   help="row-nnz-ascending reorder (preprocessing.rs:76-89)")
    p.add_argument("--no-result", action="store_true",
                   help="skip printing the first rows of C")
    p.add_argument("--window-k", type=int, default=None,
                   help="traffic mode: A-scalars per window (default full-K)")
    p.add_argument("--engine", default=None,
                   choices=["auto", "streaming", "cached", "panel", "xla",
                            "pallas_grid"],
                   help="tile engine override (default: config/auto)")
    p.add_argument("--dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="tile dtype override (bfloat16 implies fast MXU)")
    p.add_argument("--fast", action="store_true",
                   help="throughput profile: bf16 tiles + adaptive tile size")
    p.add_argument("--densify", default="auto", choices=["auto", "off"],
                   help="plan-time layout densification: k-grid anchor scan "
                        "+ degree-clustering permutations (plan/densify.py); "
                        "auto keeps identity when structure is already "
                        "aligned")
    p.add_argument("--plan-scheme", default="analytic",
                   choices=["analytic", "profiled"],
                   help="spada panel planner: closed-form byte model or "
                        "measured kernel latency (rowwise_perf_adjust.rs "
                        "scheme-3 signal)")
    return p


def load_workload(args, config: SpadaConfig) -> GemmWorkload:
    if args.category.upper() == "SS":
        w = GemmWorkload.from_suitesparse(config.ss_filepath, args.workload)
    else:
        import os

        if not os.path.exists(config.nn_filepath):
            # the reference ships no NN pickle (py2rust.rs:5-60 just reads
            # one); generate the stock pruned-layer GEMMs on first use so
            # `run spada NN <layer>` works out of the box
            from spada_tpu_torch.models.nn_workloads import write_nn_pickle

            print(f"generating NN workloads -> {config.nn_filepath}")
            write_nn_pickle(config.nn_filepath)
        w = load_pickled_gemms(config.nn_filepath, args.workload)
    if args.preprocess:
        w = w.preprocess_sorted()
    return w


def _print_gemm_stats(w: GemmWorkload) -> None:
    print(f"GEMM {w.name}: A {w.a.shape} nnz {w.a.nnz}  "
          f"B {w.b.shape} nnz {w.b.nnz}"
          + ("  [preprocessed]" if w.row_remap is not None else ""))


def _print_first_rows(c, w: GemmWorkload, n: int = 10) -> None:
    """First <=10 rows of C in original row ids (main.rs:113-116)."""
    c = w.restore_row_order(c)
    for i in range(min(n, c.shape[0])):
        cols, vals = c.row(i)
        head = ", ".join(
            f"({int(j)}: {v:.4g})" for j, v in list(zip(cols, vals))[:8]
        )
        more = " ..." if len(cols) > 8 else ""
        print(f"  C[{i}] ({len(cols)} nnz): {head}{more}")


def build_port_parser():
    p = build_parser()
    p.prog = "spada_tpu_torch"
    p.description = ("adaptive-dataflow SpGEMM on PyTorch and CUDA "
                     "(spada_tpu.cli on PyTorch)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--card", action="store_true",
                   help="plan mode: the plan run executes, under the card's "
                        "profile (the device's; on the CPU the datasheet's "
                        "H100)")
    return p


def cmd_run(args, config: SpadaConfig, w: GemmWorkload,
            device: torch.device) -> CsrMatrix:
    """Run one SpGEMM, print the report; returns C in the input row order."""
    from spada_tpu_torch.models.traffic import simulate_traffic
    from spada_tpu_torch.ops.spgemm import measure_device_perf

    dataflow = args.dataflow
    plan = None
    if dataflow == "spada":
        run = run_spada(w.a, w.b, config, device,
                        densify=args.densify == "auto",
                        scheme=args.plan_scheme)
        config, plan = run.config, run.plan
        if run.row_remap is not None:
            remap = (run.row_remap if w.row_remap is None
                     else w.row_remap[run.row_remap])
            w = GemmWorkload(w.name, run.a, run.b, remap)
        if run.choice == "element":
            dataflow = "element"
        res = run.result
    else:
        if dataflow == "op":
            from spada_tpu_torch.plan.planner import plan_op_dataflow

            op_tm, op_det = plan_op_dataflow(w.a, w.b, config)
            print(f"colwise plan (scheme {op_det['scheme']}): panel height "
                  f"{op_tm} from {op_det['anchors']} anchors, "
                  f"window-height votes {op_det['heights']}")
        res = spgemm(w.a, w.b, config, dataflow=dataflow, device=device)

    t_rb = time.perf_counter()
    c = res.to_csr()
    readback_s = time.perf_counter() - t_rb
    # the device time of the launches the run made; a failing timing fails
    # the run.  None only where there is no device time to take (the CPU,
    # or an element run that streamed row slabs)
    dev = measure_device_perf(w.a, w.b, config, dataflow=dataflow, plan=plan,
                              host_state=getattr(res, "host_state", None),
                              device=device)
    if dev is not None:
        elapsed = dev["engine_s"]
        util = ("" if dev["mxu_util_pct"] is None
                else f"{dev['mxu_util_pct']:.1f}% tensor-core peak | ")
        print(f"device perf: engine {dev['engine_s'] * 1e3:.3f} ms | "
              f"{dev['flops_per_s'] / 1e9:.1f} GFLOP/s ({util}"
              f"{dev['pct_hbm_sol']:.1f}% of HBM SoL) | "
              f"model HBM {dev['hbm_gbps']:.0f} GB/s | "
              f"result readback+extract {readback_s:.2f} s (excluded)")
    else:
        # the first run built and loaded the kernels: time a warm rerun
        elapsed = spgemm(w.a, w.b, config, dataflow=dataflow, plan=plan,
                         device=device).elapsed_s
        print(f"device perf: not measured ({device}); elapsed is the wall "
              f"time of a warm rerun | result readback+extract "
              f"{readback_s:.2f} s (excluded)")

    backend = (torch.cuda.get_device_name(device) if device.type == "cuda"
               else str(device))
    perf = PerfReport(
        workload=w.name, dataflow=dataflow, elapsed_s=elapsed,
        useful_flops=res.useful_flops, mxu_flops=res.mxu_flops, nnz_c=c.nnz,
        hbm_bytes_model=_tile_bytes(res), n_work_items=res.n_work_items,
        backend=backend,
    )
    traffic = simulate_traffic(w.a, w.b, config, compute_values=False).report
    print(format_report(perf, traffic, config))
    if not args.no_result:
        _print_first_rows(c, w)
    return w.restore_row_order(c)


def _tile_bytes(res) -> int:
    """Tile-engine HBM byte model: A+B tiles per work item, C tiles once.

    Uses the actual contraction tile edge and tile dtype the engine ran with
    (T may be re-chosen per matrix by choose_tile_size, and bf16 tiles move
    half the bytes of f32).
    """
    if getattr(res, "element", None) is not None:  # ESC element path
        el = res.element
        return (el.plan.operand_bytes() if hasattr(el, "plan")
                else el.operand_bytes())
    if hasattr(res, "segments"):  # PlanResult
        total = 0
        for seg in res.segments:
            r = seg.result
            total += (r.n_work_items * (seg.tm * r.tk + r.tk * r.tn)
                      * r.tile_itemsize)
            total += np.asarray(r.c_tiles).shape[0] * seg.tm * r.tn * 4
        return total
    tiles = np.asarray(res.c_tiles)
    return (res.n_work_items * (res.tm * res.tk + res.tk * res.tn)
            * res.tile_itemsize
            + tiles.shape[0] * res.tm * res.tn * 4)


def cmd_traffic(args, config: SpadaConfig, w: GemmWorkload) -> int:
    from spada_tpu_torch.models.traffic import simulate_traffic

    res = simulate_traffic(w.a, w.b, config, window_k=args.window_k)
    print("functional traffic model (reference counter semantics):")
    for k, v in res.report.as_dict().items():
        print(f"  {k}: {v}")
    from spada_tpu_torch.ops.spgemm import _count_useful_flops

    mults = _count_useful_flops(w.a, w.b) // 2
    print(f"  estimated_cycles: "
          f"{res.report.estimated_cycles(config, useful_mults=mults)}"
          f"  (machine: {config.pe_num} PEs x {config.lane_num} lanes, "
          f"{config.bandwidth_bytes_per_cycle:.0f} B/cyc)")
    if not args.no_result:
        _print_first_rows(res.c, w)
    return 0


def cmd_breuse(args, config: SpadaConfig, w: GemmWorkload) -> int:
    from spada_tpu_torch.models.traffic import simulate_traffic

    res = simulate_traffic(w.a, w.b, config, compute_values=False)
    r = res.report
    print(f"b_reuse: {r.b_reuse:.4f}  (touched {r.b_touched_words} / "
          f"distinct {r.b_distinct_words} words)")
    print(f"c_reuse: {r.c_reuse:.4f}  (touched {r.c_touched_words} / "
          f"final {r.c_final_words} words)")
    print(f"cache hit ratio: "
          f"{1 - r.cache.miss_count / max(r.b_touched_words, 1):.4f}")
    return 0


def cmd_plan(args, config: SpadaConfig, w: GemmWorkload,
             device: torch.device) -> int:
    """The planner's decisions, printed as the reference's ``plan`` mode
    prints them; ``--plan-scheme profiled`` times the tile engine on
    ``device``.  With ``--card`` the plan ``run`` executes: the card's
    profile on the config, then :func:`plan_spada`'s dispatch, tile edge,
    densify and plan."""
    if args.card:
        run = plan_spada(w.a, w.b, config, device,
                         densify=args.densify == "auto",
                         scheme=args.plan_scheme)
        if run.choice == "element":
            return 0
        plan, n_rows = run.plan, run.a.shape[0]
    else:
        from spada_tpu_torch.plan.planner import plan_spgemm

        measure = None
        if args.plan_scheme == "profiled":
            from spada_tpu_torch.plan.execute import make_profiled_measure

            measure = make_profiled_measure(w.a, w.b, config, device)
        plan = plan_spgemm(w.a, w.b, config, scheme=args.plan_scheme,
                           measure=measure)
        n_rows = w.a.shape[0]
    print(f"{len(plan.panels)} panels over {n_rows} rows "
          f"({plan.meta['n_groups']} row groups, "
          f"scheme {args.plan_scheme})")
    print(f"tm histogram (height -> rows): {plan.tm_histogram()}")
    for p in plan.panels[:20]:
        print(f"  rows [{p.row_start}, {p.row_end})  tm={p.tm}")
    if len(plan.panels) > 20:
        print(f"  ... {len(plan.panels) - 20} more")
    return 0


def _execute(args):
    """(exit code, C in input row order or None) of one parsed command."""
    config = SpadaConfig.from_json(args.config) if args.config else SpadaConfig()
    device = None
    if args.mode in ("run", "plan"):
        device = check_device(args.device)
    config.dataflow = args.dataflow
    if args.fast:
        config.engine_dtype = "bfloat16"
        config.precision = "default"
    if args.engine:
        config.engine = args.engine
    if args.dtype:
        config.engine_dtype = args.dtype
        if args.dtype == "bfloat16":
            config.precision = "default"
    if args.mode == "run" or (args.mode == "plan" and args.card):
        name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else None)
        config = card_config(config, name)
    w = load_workload(args, config)
    _print_gemm_stats(w)
    if args.mode == "traffic":
        return cmd_traffic(args, config, w), None
    if args.mode == "breuse":
        return cmd_breuse(args, config, w), None
    if args.mode == "plan":
        return cmd_plan(args, config, w, device), None
    return 0, cmd_run(args, config, w, device)


def execute(argv=None) -> Optional[CsrMatrix]:
    """Parse ``argv`` and run; returns C (input row order) for ``run``,
    None for the other modes."""
    return _execute(build_port_parser().parse_args(argv))[1]


def main(argv=None) -> int:
    """Exit code of one command: 0 when it ran."""
    return _execute(build_port_parser().parse_args(argv))[0]


if __name__ == "__main__":
    sys.exit(main())
