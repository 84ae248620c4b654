"""Adaptive against fixed dataflows, on the card (port of
``tools/eval_adaptive.py``).

For each workload the tile edge T and the plan are those ``run`` takes
under the bf16 profile, ``h100_config(engine_dtype="bfloat16",
precision="default")`` (the reference's ``SpadaConfig.fast()`` on the
card's rates and terms): ``plan.card_model.planner_for``'s pair, the
card's tile model.  These rows are timed on CUDA events, engine time
only, each tile row with its t_est under the card's model and under the
parent's (the reference's form, ``parent_config``) and both residuals:

- ``tm32`` and ``tm<T>``: one fixed panel height, one ``tile_spgemm``
  launch of the uniform row worklist;
- ``panel``: the ``tm<T>`` worklist on ``tile_panel`` (``run_worklist_
  panel``; the same prepared launch, ``prepare_worklist(engine="panel")``,
  is timed);
- ``spada``: the adaptive per-row-group plan (``plan_spgemm_card``), the
  sum of its per-segment ``tile_spgemm`` times as the reference sums them;
- ``spada+densify <cand>``: what ``run`` runs with densify on, where the
  layout is not the identity: the layout the config's scorer picks at T
  (``plan.card_densify.densify_for``: the card's model), then the T and
  the plan ``planner_for``'s pair takes on the transformed pair, timed as
  ``spada``; where the parent's scorer (``parent_config``: the
  reference's) picks another layout, that layout's row too.  Each
  workload logs both scorers' picks and host seconds;
- ``element (dispatched)`` or ``element (not dispatched)``: the element
  side, its ``esc_stream_group`` launch (one per row slab above 2^28
  products, as ``spgemm_element`` splits them), on every workload
  (``element="all"``, the default) or only where ``dispatch_dataflow``
  picks it (``element="dispatched"``);
- the dispatch's verdict: ``dispatch_dataflow``'s choice beside the
  modelled and measured sides (the tile side is ``spada``, the plan the
  main path runs, and its model the card's t_est of that plan), OK where
  the faster side measured is the one chosen,
  WRONG where not, ``-`` where one side was not timed.

The workloads are the reference's eight at n = 16384 (``--quick``: 8192),
its generators and seeds, and C = A·A of the graded Q1 FEM
``fem_q1_graded_csr(round(sqrt(n)) + 1, ...)`` at the default grading 1.05:
(129, 129), 16,384 nodes (``--quick``: (92, 92), 8,281), the structure the
per-row-group planner exists for.  The reference's SMEM launch splits and
``skip(slabs)`` have no counterpart: the kernel takes any worklist.  A row
whose tiles and C would not fit in the card's free memory prints
``skip(memory)`` with the bytes it needs; no smaller problem is timed in its
place.  Every timed C is gated against scipy on its first 2048 rows (bf16
tiles: 1e-2 of max|C|; the element side 1e-3).  The markdown tables go to
stdout, the last one every tile row's residuals under both models with
each model's median and largest |residual| (:func:`residual_table`).  On
the CPU the plain versions run and are gated, untimed.

    python -m spada_tpu_torch.tools.eval_adaptive [--quick]
    python -m spada_tpu_torch.tools.eval_adaptive --device cpu --n 1024
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np

from spada_tpu_torch.tools.harness import (card_name, device_s,
                                           element_entry, first_rows_ref,
                                           fmt_ms, gate, tile_rows)

#: the gate on C's first rows for bf16 tiles, max|d| / max|ref|
TILE_GATE = 1e-2


def fem_edges(n: int) -> int:
    """Elements per side of the graded FEM row set at eval size ``n``, so
    that its (edges - 1)^2 interior nodes come nearest n: 129 at 16384
    (16,384 nodes), 92 at 8192 (8,281)."""
    return int(round(np.sqrt(n))) + 1


def tile_bytes(a_bsr, b_bsr, wl, itemsize: int) -> int:
    """Device bytes of one tile launch: A and B tiles at ``itemsize``, the
    f32 C tiles, two ids per item and one pointer per C tile."""
    tm, tk = a_bsr.tiles.shape[1], a_bsr.tiles.shape[2]
    tn = b_bsr.tiles.shape[2]
    return ((a_bsr.tiles.shape[0] * tm * tk + b_bsr.tiles.shape[0] * tk * tn)
            * itemsize + wl.n_c_tiles * tm * tn * 4
            + 4 * (2 * wl.n_items + wl.n_c_tiles + 1))


def fits(dev, nbytes: int) -> bool:
    """Whether ``nbytes`` fit in 90% of the card's free memory (always on
    the CPU)."""
    if dev.type != "cuda":
        return True
    import torch

    torch.cuda.empty_cache()
    return nbytes <= 0.9 * torch.cuda.mem_get_info(dev)[0]


def workloads(n: int) -> Dict[str, tuple]:
    """{name: (A, B)}: the reference eval's eight pairs at size ``n``, its
    generators and seeds, then the graded FEM's A·A."""
    import scipy.sparse as sp

    from spada_tpu_torch.io.workloads import (banded_csr, banded_offset_csr,
                                              fem_q1_graded_csr,
                                              localized_powerlaw_csr,
                                              powerlaw_csr, rmat_csr)
    from spada_tpu_torch.models.nn_workloads import make_nn_gemms
    from spada_tpu_torch.sparse.csr import CsrMatrix

    f32 = np.float32
    # top half banded (fat panels), bottom half power-law (thin panels)
    mixed_a = CsrMatrix.from_scipy(sp.vstack([
        banded_csr(n // 2, n, 192, seed=10, dtype=f32).to_scipy(),
        localized_powerlaw_csr(n // 2, n, 32.0, window_frac=0.01,
                               hub_frac=0.02, seed=11, dtype=f32).to_scipy(),
    ]).tocsr())
    out = {
        "banded": (banded_csr(n, n, 192, seed=0, dtype=f32),
                   banded_csr(n, n, 192, seed=1, dtype=f32)),
        "loc-powerlaw": (
            localized_powerlaw_csr(n, n, 32.0, window_frac=0.01,
                                   hub_frac=0.02, seed=2, dtype=f32),
            localized_powerlaw_csr(n, n, 32.0, window_frac=0.01,
                                   hub_frac=0.02, seed=3, dtype=f32)),
        "uni-powerlaw": (powerlaw_csr(n, n, 16.0, seed=4, dtype=f32),
                         powerlaw_csr(n, n, 16.0, seed=5, dtype=f32)),
        "mixed": (mixed_a,
                  localized_powerlaw_csr(n, n, 24.0, window_frac=0.01,
                                         hub_frac=0.02, seed=12, dtype=f32)),
        "banded-offset": (banded_offset_csr(n, n, 192, 96, seed=6, dtype=f32),
                          banded_offset_csr(n, n, 192, 96, seed=7,
                                            dtype=f32)),
        "rmat": (rmat_csr(n, 12.0, seed=8, dtype=f32),
                 rmat_csr(n, 12.0, seed=9, dtype=f32)),
    }
    for label, blk in (("nn-bert-ffn1", None), ("nn-bert-ffn1-blk32", 32)):
        g = make_nn_gemms(density=0.1, structured_block=blk,
                          layers={"bert_ffn1": ((3072, 768), 512)})
        wa, wb = g["bert_ffn1"]
        out[label] = (CsrMatrix.from_scipy(wa.astype(f32)),
                      CsrMatrix.from_scipy(wb.astype(f32)))
    edges = fem_edges(n)
    fem = fem_q1_graded_csr(edges, edges, dtype=f32)
    out[f"fem-graded-{edges}"] = (fem, fem)
    return out


def bf16_config(name: Optional[str], T: Optional[int] = None):
    """The eval's profile on the card named ``name``; with ``T``, the
    reference's settings for a chosen tile edge (tk = tn = default_tm = T,
    the tm choices up to T)."""
    from spada_tpu_torch.config import h100_config

    if T is None:
        return h100_config(name, engine_dtype="bfloat16", precision="default")
    return h100_config(
        name, engine_dtype="bfloat16", precision="default", tile_k=T,
        tile_n=T, default_tm=T,
        tm_choices=tuple(t for t in (32, 64, 128, 256, 384, 512)
                         if t < T) + (T,))


def parent_config(cfg):
    """``cfg`` with the tile side's card terms in the reference's form: the
    parent's model (the reference's estimator on the card's square-tile
    per-item fit), which the card's model replaced."""
    import dataclasses

    from spada_tpu_torch.config import REFERENCE_TILE_TERMS

    return dataclasses.replace(cfg, **REFERENCE_TILE_TERMS)


def models(a, b, plan, cfg) -> tuple:
    """(the card's t_est, the parent's) of ``plan`` under ``cfg``
    (``plan.card_model.plan_t_est``)."""
    from spada_tpu_torch.plan.card_model import plan_t_est

    (card, _), (parent, _) = plan_t_est(a, b, plan, cfg, parent_config(cfg))
    return card, parent


def residual(model, s) -> Optional[float]:
    """(model - measured) / measured, None where either is missing."""
    if model is None or s is None or isinstance(s, str):
        return None
    return (model - s) / s


class _Rows:
    """One workload's rows: {label: (seconds | None | 'skip(memory) ...',
    work items, (the card model's s, the parent model's s) or None)}."""

    def __init__(self, name: str, log):
        self.name, self.log = name, log
        self.rows: Dict[str, tuple] = {}

    def add(self, label: str, s, w: int, model=None, note: str = ""):
        self.rows[label] = (s, w, model)
        shown = s if isinstance(s, str) else f"{fmt_ms(s)} ms"
        if model is not None:
            r = residual(model[0], s)
            shown += (f", model {model[0] * 1e3:.4f} ms"
                      + ("" if r is None else f" ({r:+.1%})")
                      + f", parent's model {model[1] * 1e3:.4f} ms")
        self.log(f"{self.name} {label}: {shown} W={w} {note}".rstrip())


def _tiles_on(bsr, dev):
    import torch

    from spada_tpu_torch.convert import bsr_to_torch

    return bsr_to_torch(bsr, dev, torch.bfloat16)


def _skip_memory(nbytes: int) -> str:
    return f"skip(memory): {nbytes / 1e9:.2f} GB"


def eval_workload(name: str, a, b, dev, gate_rows: int = 2048,
                  log: Callable[[str], None] = print,
                  element: str = "all") -> tuple:
    """(T, rows, verdict) of one workload (see the module docstring);
    ``element``: 'all' or 'dispatched', where the element side is timed;
    verdict: {"choice", "tile_model_s", "element_model_s", "tile_s",
    "element_s", "ok"}, the measured seconds None where not timed."""
    import torch

    from spada_tpu_torch.io.workloads import GemmWorkload
    from spada_tpu_torch.ops.engine import prepare_worklist, run_worklist_panel
    from spada_tpu_torch.ops.spgemm import dispatch_dataflow
    from spada_tpu_torch.ops.worklist import build_worklist
    from spada_tpu_torch.plan.card_densify import (densify_for,
                                                   densify_workload)
    from spada_tpu_torch.plan.card_model import planner_for
    from spada_tpu_torch.plan.planner import ExecutionPlan, PanelSpec
    from spada_tpu_torch.sparse.bsr import BsrMatrix

    if element not in ("all", "dispatched"):
        raise ValueError(f"element={element!r}: 'all' or 'dispatched'")
    card = card_name(dev)
    tile_size, planner = planner_for(bf16_config(card))
    T, det = tile_size(a, b, bf16_config(card))
    cfg = bf16_config(card, T)
    ref = first_rows_ref(a, b, gate_rows)
    c_shape = (a.shape[0], b.shape[1])
    b_bsr = BsrMatrix.from_csr(b, T, T, dtype=np.float32)
    out = _Rows(name, log)

    def launch(a_bsr, wl, engine="cached"):
        return prepare_worklist(wl, _tiles_on(a_bsr, dev),
                                _tiles_on(b_bsr, dev), engine=engine)

    for label, tm in (("tm32", 32), (f"tm{T}", T)):
        a_bsr = BsrMatrix.from_csr(a, tm, T, dtype=np.float32)
        wl = build_worklist(a_bsr, b_bsr, order="row")
        need = tile_bytes(a_bsr, b_bsr, wl, 2)
        model = models(a, b, ExecutionPlan([PanelSpec(0, a.shape[0], tm)],
                                           T, T), cfg)
        if not fits(dev, need + (need if tm == T else 0)):
            out.add(label, _skip_memory(need), wl.n_items, model)
            continue
        call = launch(a_bsr, wl)
        err = gate(tile_rows(call(), wl.c_tile_row, wl.c_tile_col, tm, T,
                             c_shape, gate_rows), ref, TILE_GATE,
                   f"{name} {label}")
        out.add(label, device_s(call, dev), wl.n_items, model,
                note=f"gate {err:.1e}")
        del call
        if tm == T:
            a_t, b_t = _tiles_on(a_bsr, dev), _tiles_on(b_bsr, dev)
            c = run_worklist_panel(a_t, b_t, wl.a_tid, wl.b_tid, wl.o_tid,
                                   wl.n_c_tiles)[0]
            err = gate(tile_rows(c, wl.c_tile_row, wl.c_tile_col, T, T,
                                 c_shape, gate_rows), ref, TILE_GATE,
                       f"{name} panel")
            del c
            call = prepare_worklist(wl, a_t, b_t, engine="panel")
            out.add("panel", device_s(call, dev), wl.n_items, model,
                    note=f"gate {err:.1e}")
            del call, a_t, b_t

    plan = planner(a, b, cfg)
    spada_model = _time_plan(out, "spada", a, b, plan, cfg, dev, gate_rows)

    # the layout each scorer picks at T, then the T and plan ``run`` takes
    # on the transformed pair
    picks = {}
    for who, c in (("card", cfg), ("parent", parent_config(cfg))):
        t0 = time.perf_counter()
        picks[who] = (densify_for(c)(a, b, T, c), time.perf_counter() - t0)
    log(f"{name} densify: the card's scorer picks "
        f"{_pick(picks['card'][0])} in {picks['card'][1]:.3f} s, the "
        f"parent's {_pick(picks['parent'][0])} in "
        f"{picks['parent'][1]:.3f} s")
    timed = set()
    for who, (dplan, _) in picks.items():
        if dplan.is_identity or dplan.candidate in timed:
            continue
        timed.add(dplan.candidate)
        w2, _ = densify_workload(GemmWorkload(name, a, b), cfg, T, dplan)
        T2, _ = tile_size(w2.a, w2.b, bf16_config(card))
        cfg2 = bf16_config(card, T2)
        _time_plan(out, f"spada+densify {dplan.candidate}", w2.a, w2.b,
                   planner(w2.a, w2.b, cfg2), cfg2, dev, gate_rows,
                   note=f"{who}'s pick, tile={T2}")

    choice, ddet = dispatch_dataflow(a, b, cfg)
    e = ddet["element"]["e_products"]
    e_s = None
    if choice == "element" or element == "all":
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        calls, csr = element_entry(a, b, dev, cap=cfg.element_cap)
        err = gate(csr[:gate_rows], ref, 1e-3, f"{name} element")
        e_s = device_s(lambda: [c() for c in calls], dev)
        picked = "dispatched" if choice == "element" else "not dispatched"
        out.add(f"element ({picked})", e_s, e,
                note=f"E={e} in {len(calls)} launch(es), model "
                     f"{ddet['element']['t_est'] * 1e3:.4f} ms, gate "
                     f"{err:.1e}")
        del calls, csr
    t_s = out.rows.get("spada", (None,))[0]
    t_s = None if isinstance(t_s, str) else t_s
    ok = "-"
    if t_s is not None and e_s is not None:
        ok = "OK" if (choice == "tile") == (t_s <= e_s) else "WRONG"
    verdict = {"choice": choice,
               "tile_model_s": spada_model[0],
               "element_model_s": ddet["element"]["t_est"], "tile_s": t_s,
               "element_s": e_s, "ok": ok,
               "densify": {who: (_pick(p), sec)
                           for who, (p, sec) in picks.items()}}
    log(f"{name} dispatch: {verdict_line(verdict)}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return T, out.rows, verdict


def _pick(dplan) -> str:
    """A densify plan's candidate, the identity by that name."""
    return "identity" if dplan.is_identity else dplan.candidate


def _time_plan(out: "_Rows", label: str, a, b, plan, cfg, dev,
               gate_rows: int, note: str = "") -> tuple:
    """Add the row ``label``: ``plan``'s segments on ``a``, ``b`` (tiles of
    ``cfg``'s T), one ``tile_spgemm`` launch each, their times summed as
    the reference sums them, C's first rows gated against scipy.  Returns
    the plan's (card model, parent's model) t_est."""
    from spada_tpu_torch.ops.engine import prepare_worklist
    from spada_tpu_torch.plan.execute import iter_plan_segments
    from spada_tpu_torch.sparse.bsr import BsrMatrix

    T = plan.tile_k
    b_bsr = BsrMatrix.from_csr(b, T, T, dtype=np.float32)
    segs = list(iter_plan_segments(a, b_bsr, plan))
    need = sum(tile_bytes(a_bsr, b_bsr, wl, 2) for *_, a_bsr, wl in segs)
    W = sum(wl.n_items for *_, wl in segs)
    model = models(a, b, plan, cfg)
    if not fits(dev, need):
        out.add(label, _skip_memory(need), W, model)
        return model
    total, got = 0.0, None
    b_t = _tiles_on(b_bsr, dev)
    for tm, _, bases, a_bsr, wl in segs:
        call = prepare_worklist(wl, _tiles_on(a_bsr, dev), b_t,
                                engine="cached")
        part = tile_rows(call(), wl.c_tile_row, wl.c_tile_col, tm, T,
                         (a.shape[0], b.shape[1]), gate_rows, bases)
        got = part if got is None else got + part
        s = device_s(call, dev)
        total = None if s is None else total + s
        del call
    err = gate(got, first_rows_ref(a, b, gate_rows), TILE_GATE,
               f"{out.name} {label}")
    out.add(label, total, W, model,
            note=f"({note + ', ' if note else ''}tm hist "
                 f"{plan.tm_histogram()}) gate {err:.1e}")
    return model


def verdict_line(v: dict) -> str:
    """One workload's dispatch verdict in a line."""
    return (f"{v['choice']} (model tile {v['tile_model_s'] * 1e3:.4f} ms, "
            f"element {v['element_model_s'] * 1e3:.4f}); measured spada "
            f"{fmt_ms(v['tile_s'])}, element {fmt_ms(v['element_s'])} ms: "
            f"{v['ok']}")


def run(n: int = 16384, device="cuda", gate_rows: int = 2048,
        log: Callable[[str], None] = print, element: str = "all") -> list:
    """[(workload, T, rows, verdict)] of every workload at size ``n``;
    prints the markdown table."""
    from spada_tpu_torch.convert import check_device

    dev = check_device(device)
    t0 = time.perf_counter()
    sets = workloads(n)
    log(f"workloads at n={n} generated in {time.perf_counter() - t0:.1f} s;"
        f" card {card_name(dev) or 'none (cpu)'}")
    results = []
    for name, (a, b) in sets.items():
        t0 = time.perf_counter()
        results.append((name, *eval_workload(name, a, b, dev, gate_rows,
                                             log, element)))
        log(f"{name}: {time.perf_counter() - t0:.1f} s host+device")
    log(report(results, n, card_name(dev)))
    return results


def report(results, n: int, card: Optional[str]) -> str:
    """The reference's markdown, one table per workload, with each tile
    plan's t_est under the card's model and under the parent's beside its
    ms, then :func:`residual_table`."""
    lines = [f"# EVAL — adaptive planner vs fixed panel heights "
             f"({card or 'CPU: not timed'})", "",
             f"n={n}; engine time (bf16 tiles, f32 C), CUDA events; W = tile "
             "products issued (element: scalar products).", ""]
    for name, T, rows, verdict in results:
        lines += [f"## {name}  (tile={T})", "",
                  "| setting | engine ms | work items | model ms | residual "
                  "| parent's model ms | residual |",
                  "|---|---|---|---|---|---|---|"]
        for label, (s, w, model) in rows.items():
            shown = s if isinstance(s, str) else fmt_ms(s)
            cols = ["", "", "", ""]
            if model is not None:
                cols = [fmt_ms(model[0]), _pct(residual(model[0], s)),
                        fmt_ms(model[1]), _pct(residual(model[1], s))]
            lines.append(f"| {label} | {shown} | {w} | "
                         + " | ".join(cols) + " |")
        lines += ["", f"dispatch: {verdict_line(verdict)}", ""]
    return "\n".join(lines + [residual_table(
        [(f"{name} {label}", s, model)
         for name, _, rows, _ in results
         for label, (s, _, model) in rows.items() if model is not None])])


def _pct(r: Optional[float]) -> str:
    return "" if r is None else f"{r:+.1%}"


def residual_table(points) -> str:
    """Markdown: every (label, measured s, (card model s, parent model s))
    point with both models' residuals, then each model's median |residual|
    and largest |residual| over the measured points."""
    lines = ["## the models' residuals", "",
             "| point | measured ms | model ms | residual | parent's model "
             "ms | residual |", "|---|---|---|---|---|---|"]
    res = ([], [])
    for label, s, (card, parent) in points:
        r = (residual(card, s), residual(parent, s))
        for acc, x in zip(res, r):
            if x is not None:
                acc.append(abs(x))
        shown = s if isinstance(s, str) else fmt_ms(s)
        lines.append(f"| {label} | {shown} | {fmt_ms(card)} | {_pct(r[0])} "
                     f"| {fmt_ms(parent)} | {_pct(r[1])} |")
    lines.append("")
    for what, acc in zip(("the card's model", "the parent's model"), res):
        lines.append(f"{what}: " + (
            f"median |residual| {np.median(acc):.1%}, largest {max(acc):.1%}"
            f" over {len(acc)} points" if acc else "no measured point"))
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--quick", action="store_true", help="n = 8192")
    p.add_argument("--n", type=int, default=None, help="matrix size")
    p.add_argument("--element", default="all", choices=("all", "dispatched"),
                   help="time the element side on every workload, or only "
                        "where dispatch picks it")
    args = p.parse_args(argv)
    run(args.n or (8192 if args.quick else 16384), device=args.device,
        element=args.element)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
