"""Fit the planner's per-item terms on the card (port of
``tools/probe_item_overhead.py``).

``SpadaConfig.engine_item_overhead_s`` (by tile edge T),
``engine_acc_s_per_elem`` and ``engine_item_fixed_s`` are what one work
item costs the tile kernel beyond the planner's roofline term.
``choose_tile_size`` reads the per-T dict; the per-row-group estimator
and the densify scorer read ``acc * tm * tn + fixed``.

Method: ``banded_csr(65536, 65536, 384, seed=0 / 1)`` at T in {128, 256,
384, 512}.  For each T: the BSR pair at T x T, a row worklist, and one
``tile_spgemm`` launch (``prepare_worklist(engine="cached")``) timed on
CUDA events (``utils.timing.cuda_time``).  The per-item overhead is

    (elapsed - model) / W,    model = t_est(T) - W * t_item(T),

with W and ``t_est`` from ``choose_tile_size``'s ``details[T]`` under
``h100_config`` for the tile dtype: the model term is the planner's own
``max(unique_bytes / hbm, 2 W T^3 / peak_flops_bf16)``.  So the fitted dict
makes ``choose_tile_size`` reproduce the measured time at each T.  The
reference subtracted the MXU term alone, at the v5e's 197 TFLOP/s; that is
its model's term only where the MXU term binds, and on its own chip.  The
port subtracts the term the model adds on the card's datasheet rates, so
that no part of the measured time is counted twice or left out.  Then, as
the reference does, ``np.linalg.lstsq`` fits ``overhead ~= acc * T^2 +
fixed`` over the four points; the residuals say how far the planner's form
is from the card.  The card's overhead grows about as T^3, so that fit's
fixed term comes out negative; the terms the config takes
(``config.fit_item_terms``) are the same fit with both terms held >= 0,
printed beside it.

Both tile dtypes: f32 (``h100_config()``'s) and bf16 (the reference's fit
and ``SpadaConfig.fast()``'s).  Each launch's C is gated against scipy on
its first 2048 rows: f32 to 1e-4 of max|C|, bf16 to 1e-2.  On the CPU the
plain version runs, is gated, and is not timed (no fit).

``--thin`` (:func:`run_thin`) also measures the same overhead where the
per-row-group estimator and the densify scorer charge it, on thin row
panels: ``tools/sweep_thin``'s ``tile_spgemm`` case (``banded_csr(m, m,
384)``, m = ``--thin-n``, 32768; uniform panels of tm 8-128 at tk = tn =
128, one launch each), the overhead of a (tm, tn) item

    (elapsed - panel_cost_model's own term) / W,

the model term ``max(bytes / hbm, mxu_flops / peak_flops_bf16)`` of
``plan.estimator.panel_cost_model`` for that panel height, so that no part
of the time is counted twice.  The reference fits square tiles only; these
points are the port's.  It prints them as ``config._THIN_FIT`` records them
(overhead, and the item time elapsed / W), then the constrained fit of
``acc * tm * tn + fixed`` to them and the square points of the same run
together (``config.fit_item_terms``, each residual relative to its item's
time), with every point's residual.  The planner does not take that fit
(``config.h100_config`` says why).

    python -m spada_tpu_torch.tools.probe_item_overhead
    python -m spada_tpu_torch.tools.probe_item_overhead --thin
    python -m spada_tpu_torch.tools.probe_item_overhead --device cpu --n 2048
    python -m spada_tpu_torch.tools.probe_item_overhead --thin --device cpu --n 2048 --thin-n 2048
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from spada_tpu_torch.tools.harness import (card_name, device_s,
                                           first_rows_ref, fmt_ms, gate,
                                           tile_rows)

TS = (128, 256, 384, 512)
#: the thin panels' tk = tn
THIN_T = 128
DTYPES = ("float32", "bfloat16")
#: the gate on C's first rows, max|d| / max|ref|, by tile dtype
GATE = {"float32": 1e-4, "bfloat16": 1e-2}


def model_terms(a, b, config, ts: Sequence[int] = TS) -> Dict[int, tuple]:
    """{T: (W, seconds)}: ``choose_tile_size``'s item count and its term
    other than the per-item overhead, ``t_est - W * t_item``."""
    from spada_tpu_torch.plan.planner import choose_tile_size

    _, det = choose_tile_size(a, b, config, candidates=tuple(ts))
    return {T: (d["W"], d["t_est"] - d["W"] * _t_item(config, T))
            for T, d in det.items()}


def _t_item(config, T: int) -> float:
    # choose_tile_size's lookup, default included
    return config.engine_item_overhead_s.get(T, 0.18e-6 * (T / 128) ** 1.5)


def fit_overhead(ts: Sequence[int], overheads: Sequence[float]) -> tuple:
    """(acc, fixed, residuals): the reference's least-squares fit of
    ``overhead ~= acc * T^2 + fixed``; residual = overhead - fit."""
    t = np.asarray(ts, np.float64)
    ov = np.asarray(overheads, np.float64)
    lhs = np.stack([t ** 2, np.ones_like(t)], axis=1)
    (acc, fixed), *_ = np.linalg.lstsq(lhs, ov, rcond=None)
    return float(acc), float(fixed), ov - (acc * t ** 2 + fixed)


def fitted_terms(points: Dict[int, float]) -> dict:
    """The ``SpadaConfig`` per-item fields of measured overheads
    ``{T: seconds per item}``, as ``config.item_fit`` makes them."""
    from spada_tpu_torch.config import fit_item_terms

    acc, fixed = fit_item_terms(points)
    return {"engine_item_overhead_s": {int(T): float(o)
                                       for T, o in points.items()},
            "engine_acc_s_per_elem": acc, "engine_item_fixed_s": fixed}


def run(n: int = 65536, band: int = 384, ts: Sequence[int] = TS,
        dtypes: Sequence[str] = DTYPES, device="cuda",
        gate_rows: int = 2048,
        log: Callable[[str], None] = print) -> Dict[str, dict]:
    """Each T's launch per dtype, gated and (on a card) timed, then the fit.
    Returns {dtype: {"points": {T: {"W", "elapsed_s", "model_s",
    "overhead_s", "residual_s", "nonneg_residual_s", "relerr"}}, "terms":
    the fitted fields (:func:`fitted_terms`) or None on the CPU}}."""
    import torch

    from spada_tpu_torch.config import h100_config
    from spada_tpu_torch.convert import bsr_to_torch, check_device
    from spada_tpu_torch.io.workloads import banded_csr
    from spada_tpu_torch.ops.engine import prepare_worklist
    from spada_tpu_torch.ops.spgemm import tile_dtype
    from spada_tpu_torch.ops.worklist import build_worklist
    from spada_tpu_torch.sparse.bsr import BsrMatrix

    dev = check_device(device)
    name = card_name(dev)
    t0 = time.perf_counter()
    a = banded_csr(n, n, bandwidth=band, seed=0, dtype=np.float32)
    b = banded_csr(n, n, bandwidth=band, seed=1, dtype=np.float32)
    ref = first_rows_ref(a, b, gate_rows)
    c_shape = (n, n)
    log(f"banded {n}^2, band {band}: nnz {a.nnz} / {b.nnz} "
        f"({time.perf_counter() - t0:.1f} s host); card {name or 'none (cpu)'}")
    cfgs = {dt: h100_config(name, engine_dtype=dt) for dt in dtypes}
    models = {dt: model_terms(a, b, cfgs[dt], ts) for dt in dtypes}
    out = {dt: {"points": {}, "terms": None} for dt in dtypes}
    for T in ts:
        t0 = time.perf_counter()
        a_bsr = BsrMatrix.from_csr(a, T, T, dtype=np.float32)
        b_bsr = BsrMatrix.from_csr(b, T, T, dtype=np.float32)
        wl = build_worklist(a_bsr, b_bsr, order="row")
        host_s = time.perf_counter() - t0
        for dt in dtypes:
            W, model = models[dt][T]
            if W != wl.n_items:
                raise RuntimeError(f"T={T}: choose_tile_size counts W={W}, "
                                   f"the worklist {wl.n_items}")
            call = prepare_worklist(
                wl, bsr_to_torch(a_bsr, dev, tile_dtype(cfgs[dt])),
                bsr_to_torch(b_bsr, dev, tile_dtype(cfgs[dt])),
                engine="cached")
            c = call()
            err = gate(tile_rows(c, wl.c_tile_row, wl.c_tile_col, T, T,
                                 c_shape, gate_rows), ref, GATE[dt],
                       f"{dt} tiles, T={T}")
            del c
            el = device_s(call, dev)
            over = None if el is None else (el - model) / W
            out[dt]["points"][T] = {"W": W, "elapsed_s": el,
                                    "model_s": model, "overhead_s": over,
                                    "relerr": err}
            log(f"  {dt:8s} T={T:3d} W={W:6d} nC={wl.n_c_tiles:6d} elapsed "
                f"{fmt_ms(el)} ms  model {model * 1e3:.3f} ms -> overhead "
                + ("not timed" if over is None else f"{over * 1e9:.1f} ns")
                + f"/item  gate {err:.1e} (BSR + worklist {host_s:.1f} s)")
            del call
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    for dt in dtypes:
        pts = out[dt]["points"]
        if any(p["overhead_s"] is None for p in pts.values()):
            continue
        terms = fitted_terms({T: p["overhead_s"] for T, p in pts.items()})
        acc, fixed, res = fit_overhead(list(pts), [p["overhead_s"]
                                                   for p in pts.values()])
        acc0 = terms["engine_acc_s_per_elem"]
        fixed0 = terms["engine_item_fixed_s"]
        for T, p, r in zip(pts, pts.values(), res):
            p["residual_s"] = float(r)
            p["nonneg_residual_s"] = p["overhead_s"] - (acc0 * T ** 2
                                                        + fixed0)
        out[dt]["terms"] = terms
        log(f"\n{dt} tiles on {name}:")
        log(fit_table(pts))
        log(f"lstsq fit: overhead ~= {acc:.4e} * T^2 + {fixed * 1e9:.1f} ns")
        log(f"fit with terms >= 0 (the config's): overhead ~= {acc0:.4e} * "
            f"T^2 + {fixed0 * 1e9:.1f} ns")
        per_t = {T: float(f"{o:.4g}")
                 for T, o in terms["engine_item_overhead_s"].items()}
        log(f"engine_item_overhead_s = {per_t}")
    return out


def fit_table(points: Dict[int, dict]) -> str:
    """Markdown: per T, W, elapsed, the model term, overhead, and the
    residuals of both fits."""
    lines = ["| T | W | elapsed ms | model ms | overhead ns/item | "
             "lstsq residual ns | residual (terms >= 0) ns |",
             "|---|---|---|---|---|---|---|"]
    for T, p in points.items():
        lines.append(f"| {T} | {p['W']} | {p['elapsed_s'] * 1e3:.3f} | "
                     f"{p['model_s'] * 1e3:.3f} | "
                     f"{p['overhead_s'] * 1e9:.1f} | "
                     f"{p['residual_s'] * 1e9:.1f} | "
                     f"{p['nonneg_residual_s'] * 1e9:.1f} |")
    return "\n".join(lines)


def panel_model_s(a, bt, tm: int, config) -> tuple:
    """(W, seconds): ``panel_cost_model``'s item count for uniform row
    panels of height ``tm`` over all of A's rows against ``bt`` (B's
    ``BTileStructure``), and its term other than the per-item overhead,
    ``max(bytes / hbm, mxu_flops / peak_flops_bf16)``, at the tile dtype's
    itemsize."""
    from spada_tpu_torch.plan.estimator import panel_cost_model

    itemsize = 2 if config.engine_dtype == "bfloat16" else 4
    d = panel_cost_model(a, 0, a.shape[0], tm, bt, itemsize=itemsize)
    return d["work"], max(d["bytes"] / config.hbm_bytes_per_s,
                          d["mxu_flops"] / config.peak_flops_bf16)


def thin_points(rows, a, b, card: Optional[str],
                T: int = THIN_T) -> Dict[str, dict]:
    """{dtype: {(tm, T): (overhead s, item s)}} of the timed
    ``tile_spgemm`` cases of ``tools/sweep_thin`` rows on the pair ``a``,
    ``b`` at tk = tn = ``T``: (elapsed - :func:`panel_model_s`) / W, and
    elapsed / W, under ``h100_config(card)``'s rates."""
    from spada_tpu_torch.config import h100_config
    from spada_tpu_torch.plan.estimator import BTileStructure

    bt = BTileStructure(b, T, T)
    out: Dict[str, dict] = {}
    for r in rows:
        if r["engine"] != "tile_spgemm" or r["ms"] is None:
            continue
        cfg = h100_config(card, engine_dtype=r["dtype"])
        W, model = panel_model_s(a, bt, r["tm"], cfg)
        if W != r["W"]:
            raise RuntimeError(f"tm={r['tm']}: panel_cost_model counts "
                               f"W={W}, the worklist {r['W']}")
        el = r["ms"] * 1e-3
        out.setdefault(r["dtype"], {})[(r["tm"], T)] = ((el - model) / W,
                                                        el / W)
    return out


def union_fit(points: dict) -> dict:
    """The constrained fit of ``acc * tm * tn + fixed`` to ``points``
    ({shape: (overhead s, item s)}, a shape T or (tm, tn)), each residual
    relative to its item's time: {"acc", "fixed", "points": {shape:
    (overhead s, item s, residual s)}}, residual = overhead - (acc * tm *
    tn + fixed)."""
    from spada_tpu_torch.config import fit_item_terms, item_shape

    acc, fixed = fit_item_terms({k: o for k, (o, _) in points.items()},
                                {k: s for k, (_, s) in points.items()})
    return {"acc": acc, "fixed": fixed, "points": {
        k: (o, s, o - (acc * int(np.prod(item_shape(k))) + fixed))
        for k, (o, s) in points.items()}}


def union_table(fit: dict) -> str:
    """Markdown: every point of :func:`union_fit` with its fit and
    residual, absolute and relative to the item's time."""
    from spada_tpu_torch.config import item_shape

    lines = ["| points | tm x tn | overhead ns/item | item ns | fit ns | "
             "residual ns | residual / item |", "|---|---|---|---|---|---|---|"]
    for k, (o, s, r) in fit["points"].items():
        tm, tn = item_shape(k)
        src = "square (T)" if not isinstance(k, tuple) else "thin (tm, tn)"
        lines.append(f"| {src} | {tm} x {tn} | {o * 1e9:.2f} | "
                     f"{s * 1e9:.2f} | {(o - r) * 1e9:.2f} | {r * 1e9:.2f} | "
                     f"{r / s:+.1%} |")
    return "\n".join(lines)


def run_thin(n: int = 65536, thin_n: int = 32768, band: int = 384,
             tms: Optional[Sequence[int]] = None,
             dtypes: Sequence[str] = DTYPES, device="cuda",
             gate_rows: int = 2048,
             log: Callable[[str], None] = print) -> Dict[str, dict]:
    """The square points (:func:`run` at ``n``), then the thin points on
    the card (``tools/sweep_thin``'s ``tile_spgemm`` case at ``thin_n`` and
    ``tms``, default the sweep's, gated), then per dtype the fit of both
    together and its residuals.  Returns {dtype: {"points": {(tm, tn):
    (overhead s, item s)}, "fit": :func:`union_fit`}}; on the CPU, where
    nothing is timed, no dtype."""
    from spada_tpu_torch.convert import check_device
    from spada_tpu_torch.tools import sweep_thin

    dev = check_device(device)
    name = card_name(dev)
    square = run(n, band, TS, dtypes, dev, gate_rows, log)
    a, b = sweep_thin.banded_pair(thin_n, band)
    rows = sweep_thin.run(thin_n, band, THIN_T, tms or sweep_thin.TMS,
                          dtypes, dev, gate_rows, ab=(a, b), log=log)
    out = {}
    for dt, pts in thin_points(rows, a, b, name).items():
        both = {T: (p["overhead_s"], p["elapsed_s"] / p["W"])
                for T, p in square[dt]["points"].items()}
        fit = union_fit({**both, **pts})
        out[dt] = {"points": pts, "fit": fit}
        log(f"\n{dt} tiles on {name}: thin points for config._THIN_FIT:")
        log("    " + repr({k: (float(f"{o:.4g}"), float(f"{s:.4g}"))
                           for k, (o, s) in pts.items()}))
        log(union_table(fit))
        log(f"fit on the square and thin points, relative to each item's "
            f"time, terms >= 0: overhead ~= {fit['acc']:.4e} * tm * tn + "
            f"{fit['fixed'] * 1e9:.2f} ns")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=65536,
                   help="matrix size of the square points")
    p.add_argument("--band", type=int, default=384, help="band half-width")
    p.add_argument("--dtypes", default=",".join(DTYPES))
    p.add_argument("--thin", action="store_true",
                   help="also the thin row panels' points, and the fit on "
                        "both")
    p.add_argument("--thin-n", type=int, default=32768,
                   help="matrix size of the thin points")
    args = p.parse_args(argv)
    if args.thin:
        run_thin(args.n, args.thin_n, args.band,
                 dtypes=args.dtypes.split(","), device=args.device)
    else:
        run(args.n, args.band, dtypes=args.dtypes.split(","),
            device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
