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

``--latency`` (:func:`run_latency`, :func:`run_resident`) and ``--items``
(:func:`run_items`) measure the terms of the card's own tile model
(``plan/card_model.py``), which ``config.h100_config`` carries as
``_TILE_LATENCY``, ``_TILE_LAUNCH_S``, ``_TILE_ITEM`` and ``_TILE_L2``
(``_TILE_RESIDENT`` and ``_TILE_SMS`` are recorded beside them, carried
by no config): one block's time per item and one
launch's time, from one C tile with runs of 1 to 64 items of each item
shape the planner can pick (:func:`card_shapes`), and how many blocks of
each shape one SM holds; then the time per item on a full grid and the L2
rate of re-read tiles, from the thin points' banded pair at every such
shape.  Each prints the table ``config.py`` records.  On the CPU both run
at T = 128 alone (:data:`TS_CPU`), gated and untimed, and the resident
blocks are not measured.  ``--waves`` (:func:`run_waves`) times grids of
equal runs from half a block per SM to 16 blocks per SM: how blocks that
share SMs, and blocks past the first wave, take their time.

    python -m spada_tpu_torch.tools.probe_item_overhead
    python -m spada_tpu_torch.tools.probe_item_overhead --thin
    python -m spada_tpu_torch.tools.probe_item_overhead --latency --items
    python -m spada_tpu_torch.tools.probe_item_overhead --waves
    python -m spada_tpu_torch.tools.probe_item_overhead --latency --items --device cpu --thin-n 2048 --band 64
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
#: the run lengths of ``--latency``'s one C tile
RUNS = (1, 2, 4, 8, 16, 32, 64)
#: ``--latency`` and ``--items``' tile edges on the CPU, where nothing is
#: timed
TS_CPU = (128,)
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
    ``b`` at tk = tn = ``T`` on the blocks the planner prices (not the
    warpgroup block): (elapsed - :func:`panel_model_s`) / W, and elapsed /
    W, under ``h100_config(card)``'s rates."""
    from spada_tpu_torch.config import h100_config
    from spada_tpu_torch.plan.estimator import BTileStructure

    bt = BTileStructure(b, T, T)
    out: Dict[str, dict] = {}
    for r in rows:
        if (r["kernel"] != "tile_spgemm" or r["block"] == "mma_wg"
                or r["ms"] is None):
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


def card_shapes(ts: Sequence[int] = TS,
                tms: Sequence[int] = (8, 16, 32, 64, 128)) -> list:
    """(tm, T) of every item shape the planner can pick at tile edges
    ``ts``: each of ``tms`` up to T, and T itself (``cli.run_spada``'s
    tm choices at a chosen T)."""
    return [(tm, T) for T in ts
            for tm in sorted({*(t for t in tms if t <= T), T})]


def _synthetic_tiles(tm: int, T: int, n: int, dt: str, dev, seed: int):
    import torch

    g = torch.Generator().manual_seed(seed)
    a = torch.randn((n, tm, T), generator=g).to(dev, getattr(torch, dt))
    b = torch.randn((n, T, T), generator=g).to(dev, getattr(torch, dt))
    return a, b


def run_latency(ts: Sequence[int] = TS, dtypes: Sequence[str] = DTYPES,
                runs: Sequence[int] = RUNS, device="cuda",
                log: Callable[[str], None] = print) -> Dict[str, dict]:
    """The card's time per item of one block, and of one launch: for each
    item shape of :func:`card_shapes` and tile dtype, one C tile whose run
    is ``L`` items (item i: A tile i times B tile i, random tiles) for
    each L of ``runs``, each one ``tile_spgemm`` launch
    (``prepare_cached``) timed as ``ops.spgemm._time_segments`` times a
    plan's launches (``harness.device_s``) and held to its plain version
    (1e-5 of max|C|).  The latency is the least-squares slope of the time
    over L, the intercept what the launch costs beyond its items.  Also
    an empty worklist's call (one C tile, no item: the wrapper's zeroed C).
    Returns {dtype: {"latency": {(tm, T): (slope s, intercept s, {L: s})},
    "empty_s"}}, the times None on the CPU (checked, not timed), and logs
    the tables ``config._TILE_LATENCY`` and ``_TILE_LAUNCH_S`` record."""
    import torch

    from spada_tpu_torch.convert import check_device
    from spada_tpu_torch.ops.engine import (prepare_cached,
                                            run_worklist_reference)

    dev = check_device(device)
    name = card_name(dev)
    log(f"one C tile, runs of {list(runs)} items; card {name or 'none (cpu)'}")
    out = {}
    for dt in dtypes:
        lat = {}
        for tm, T in card_shapes(ts):
            a, b = _synthetic_tiles(tm, T, max(runs), dt, dev, tm * 7 + T)
            times = {}
            for L in runs:
                ids = np.arange(L, dtype=np.int32)
                call = prepare_cached(a, b, ids, ids, np.zeros(L, np.int32),
                                      1)
                plain = run_worklist_reference(
                    a, b, *(torch.from_numpy(x).to(dev) for x in
                            (ids, ids, np.zeros(L, np.int32))), 1)
                err = float((call() - plain).abs().max()
                            / plain.abs().max().clamp_min(1e-30))
                if not err <= 1e-5:
                    raise RuntimeError(f"{dt} {tm}x{T}, run of {L}: kernel "
                                       f"vs plain {err:.2e}")
                times[L] = device_s(call, dev)
            if None in times.values():
                lat[(tm, T)] = (None, None, times)
                continue
            slope, icpt = np.polyfit(list(times), list(times.values()), 1)
            lat[(tm, T)] = (float(slope), float(icpt), times)
            log(f"  {dt:8s} {tm:3d} x {T:3d}: {slope * 1e9:8.1f} ns per "
                f"item, intercept {icpt * 1e6:6.2f} us  (" + ", ".join(
                    f"{L}: {t * 1e6:.1f}" for L, t in times.items()) + " us)")
            del a, b
        a, b = _synthetic_tiles(128, 128, 1, dt, dev, 0)
        empty = prepare_cached(a, b, np.zeros(0, np.int32),
                               np.zeros(0, np.int32), np.zeros(0, np.int32),
                               1)
        if float(empty().abs().max()) != 0.0:
            raise RuntimeError("an empty worklist's C tile is not zero")
        out[dt] = {"latency": lat, "empty_s": device_s(empty, dev)}
    if dev.type == "cuda":
        for dt, r in out.items():
            log(f"\n{dt} tiles on {name}: for config._TILE_LATENCY:")
            log("    " + repr({k: float(f"{v[0]:.4g}")
                               for k, v in r["latency"].items()}))
            log(f"empty worklist's call {r['empty_s'] * 1e6:.2f} us")
        log(f"launch (median intercept, both dtypes) for "
            f"config._TILE_LAUNCH_S: {launch_s(out):.4g}")
    return out


def launch_s(latency: Dict[str, dict]) -> float:
    """The median over shapes and dtypes of :func:`run_latency`'s
    intercepts: one launch's time beyond its items."""
    return float(np.median([v[1] for r in latency.values()
                            for v in r["latency"].values()]))


def item_point(wl, tm: int, T: int, itemsize: int) -> dict:
    """A worklist's counts as the card's model takes them: W, C tiles, the
    longest run, the A tiles it uses and the B tiles it touches (each read
    once from HBM, with C, as ``hbm`` bytes) and the bytes read again
    (``reread``)."""
    a_b, b_b = tm * T * itemsize, T * T * itemsize
    W = int(wl.n_items)
    ua, ub = len(np.unique(wl.a_tid)), len(np.unique(wl.b_tid))
    runs = np.bincount(np.asarray(wl.o_tid), minlength=wl.n_c_tiles)
    return {"W": W, "n_c": int(wl.n_c_tiles), "longest": int(runs.max()),
            "hbm": ua * a_b + ub * b_b + wl.n_c_tiles * tm * T * itemsize,
            "reread": (W - ua) * a_b + (W - ub) * b_b}


def run_items(n: int = 32768, band: int = 384, ts: Sequence[int] = TS,
              dtypes: Sequence[str] = DTYPES, device="cuda",
              gate_rows: int = 2048,
              log: Callable[[str], None] = print) -> Dict[str, dict]:
    """The card's time per item on a full grid, and the L2 rate of re-read
    tiles: ``tools/sweep_thin``'s banded pair (``banded_csr(n, n, band)``)
    in uniform panels of every item shape of :func:`card_shapes`, one
    ``tile_spgemm`` launch each, gated against scipy on C's first rows and
    timed; every grid has more blocks than the card has SMs.  Per point:
    the item time beside C's write, ``(elapsed - C tiles * tm * T * 4 /
    hbm rate) / W`` (the model adds each C tile's f32 write back), and the
    rate the re-read tiles came at beyond the distinct tiles' HBM time,
    ``reread / (elapsed - hbm / hbm rate)``.  Returns
    {dtype: {(tm, T): point}} (:func:`item_point` with ``elapsed_s``,
    ``item_s`` and ``l2_rate``, the times None on the CPU) and logs the
    tables ``config._TILE_ITEM`` and ``_TILE_L2`` record: the highest
    rate, so that the byte term is at most every point's time."""
    import torch

    from spada_tpu_torch.config import datasheet_peaks
    from spada_tpu_torch.convert import bsr_to_torch, check_device
    from spada_tpu_torch.ops.engine import prepare_cached
    from spada_tpu_torch.plan.card_model import block_pieces
    from spada_tpu_torch.ops.worklist import build_worklist
    from spada_tpu_torch.sparse.bsr import BsrMatrix
    from spada_tpu_torch.tools import sweep_thin

    dev = check_device(device)
    name = card_name(dev)
    hbm = datasheet_peaks(name)["hbm_bytes_per_s"]
    a, b = sweep_thin.banded_pair(n, band)
    ref = first_rows_ref(a, b, gate_rows)
    log(f"banded {n}^2, band {band}; card {name or 'none (cpu)'}")
    out: Dict[str, dict] = {dt: {} for dt in dtypes}
    by_t: dict = {}
    for tm, T in card_shapes(ts):
        by_t.setdefault(T, []).append(tm)
    for T, tms in by_t.items():
        b_bsr = BsrMatrix.from_csr(b, T, T, dtype=np.float32)
        for tm in tms:
            a_bsr = BsrMatrix.from_csr(a, tm, T, dtype=np.float32)
            wl = build_worklist(a_bsr, b_bsr, order="row")
            for dt in dtypes:
                tdt = getattr(torch, dt)
                call = prepare_cached(
                    bsr_to_torch(a_bsr, dev, tdt),
                    bsr_to_torch(b_bsr, dev, tdt), wl.a_tid, wl.b_tid,
                    wl.o_tid, wl.n_c_tiles)
                err = gate(tile_rows(call(), wl.c_tile_row, wl.c_tile_col,
                                     tm, T, (n, n), gate_rows), ref,
                           GATE[dt], f"{dt} {tm}x{T}")
                p = item_point(wl, tm, T, tdt.itemsize)
                el = device_s(call, dev)
                c_s = wl.n_c_tiles * tm * T * 4 / hbm
                p.update(elapsed_s=el, relerr=err,
                         blocks=wl.n_c_tiles * block_pieces(tm, T, T,
                                                            tdt.itemsize),
                         item_s=None if el is None else (el - c_s) / p["W"],
                         l2_rate=None)
                if el is not None and el > p["hbm"] / hbm:
                    p["l2_rate"] = p["reread"] / (el - p["hbm"] / hbm)
                out[dt][(tm, T)] = p
                log(f"  {dt:8s} {tm:3d} x {T:3d}: W={p['W']:6d} "
                    f"nC={p['n_c']:6d} blocks={p['blocks']:6d} longest "
                    f"{p['longest']:3d} elapsed {fmt_ms(el)} ms = "
                    + ("not timed" if el is None else
                       f"{el / p['W'] * 1e9:.2f} ns/item, "
                       f"{p['item_s'] * 1e9:.2f} beside C's write")
                    + "; re-read "
                    + ("-" if p["l2_rate"] is None else
                       f"{p['l2_rate'] / 1e12:.2f} TB/s")
                    + f"  gate {err:.1e}")
                del call
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    if dev.type == "cuda":
        rates = [p["l2_rate"] for r in out.values() for p in r.values()
                 if p["l2_rate"] is not None]
        l2 = torch.cuda.get_device_properties(dev).L2_cache_size
        for dt, r in out.items():
            log(f"\n{dt} tiles on {name}: for config._TILE_ITEM:")
            log("    " + repr({k: float(f"{p['item_s']:.4g}")
                               for k, p in r.items()}))
        log(f"for config._TILE_L2: ({max(rates):.4g}, {l2})")
    return out


#: the item shapes of :func:`run_resident`: every height the planner can
#: pick at T = 128..512 (the eval's tm choices run to 384)
RESIDENT_TMS = (8, 16, 32, 64, 128, 256, 384)


def run_resident(ts: Sequence[int] = TS, dtypes: Sequence[str] = DTYPES,
                 device="cuda",
                 log: Callable[[str], None] = print) -> Optional[dict]:
    """The card's resident blocks: for each item shape of
    :func:`card_shapes` (heights :data:`RESIDENT_TMS`) and tile dtype, the
    block ``tile_spgemm`` runs it on and how many of that block one SM
    holds at once (``ops.engine.tile_resident_blocks``), and the card's SM
    count.  Returns {"sms": n, dtype: {(tm, T): blocks per SM}} and logs
    the tables ``config._TILE_RESIDENT`` and ``_TILE_SMS`` record; None on
    the CPU, which has no such query."""
    import torch

    from spada_tpu_torch.convert import check_device
    from spada_tpu_torch.ops.engine import tile_resident_blocks

    dev = check_device(device)
    if dev.type != "cuda":
        log("resident blocks: not measured (no card)")
        return None
    out: dict = {"sms": torch.cuda.get_device_properties(
        dev).multi_processor_count}
    for dt in dtypes:
        out[dt] = {}
        for tm, T in card_shapes(ts, RESIDENT_TMS):
            block, n = tile_resident_blocks(tm, T, T, dt, dev)
            out[dt][(tm, T)] = n
            log(f"  {dt:8s} {tm:3d} x {T:3d}: {block:11s} {n} per SM")
    log(f"\non {card_name(dev)}: for config._TILE_RESIDENT:")
    log("    " + repr({dt: out[dt] for dt in dtypes}))
    log(f"for config._TILE_SMS: {out['sms']}")
    return out


#: :func:`run_waves`' item shapes (dtype, tm, T) and grids (blocks per SM)
WAVE_SHAPES = (("float32", 8, 128), ("float32", 32, 128),
               ("float32", 64, 128), ("float32", 128, 128),
               ("bfloat16", 8, 128), ("bfloat16", 32, 128),
               ("bfloat16", 64, 128), ("bfloat16", 128, 128),
               ("bfloat16", 64, 256))
WAVE_GRIDS = (0.5, 1, 1.5, 2, 3, 4, 6, 8, 12, 16)


def run_waves(run: int = 4, shapes=WAVE_SHAPES, grids=WAVE_GRIDS,
              device="cuda",
              log: Callable[[str], None] = print) -> Dict[tuple, dict]:
    """One ``tile_spgemm`` launch of N C tiles with a run of ``run`` items
    each (item i: A tile i % 64 times B tile i % 64, random tiles), for N
    = SMs times each of ``grids``, at each item shape of ``shapes``: how a
    grid's time grows once its blocks share SMs and once they exceed what
    the SMs hold at once (beside the card model's latency term, ``plan/
    card_model.py``, which prices neither).  Each launch held to its plain version (1e-5 of
    max|C|) and timed as :func:`run_latency` times.  Returns {(dtype, tm,
    T): {N: seconds}}; on the CPU two small grids, checked, untimed."""
    import torch

    from spada_tpu_torch.convert import check_device
    from spada_tpu_torch.ops.engine import (prepare_cached,
                                            run_worklist_reference)
    from spada_tpu_torch.plan.card_model import block_pieces

    dev = check_device(device)
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 2)
    log(f"grids of C tiles with runs of {run} items; card "
        f"{card_name(dev) or 'none (cpu)'}, {sms} SMs")
    out: Dict[tuple, dict] = {}
    for dt, tm, T in shapes:
        a, b = _synthetic_tiles(tm, T, 64, dt, dev, tm * 7 + T)
        pieces = block_pieces(tm, T, T, 2 if dt == "bfloat16" else 4)
        times = {}
        for g in grids if dev.type == "cuda" else grids[:2]:
            n_c = max(1, int(round(g * sms / pieces)))
            items = np.arange(n_c * run, dtype=np.int32)
            ids = items % 64
            o = (items // run).astype(np.int32)
            call = prepare_cached(a, b, ids, ids, o, n_c)
            plain = run_worklist_reference(
                a, b, *(torch.from_numpy(x).to(dev) for x in (ids, ids, o)),
                n_c)
            err = float((call() - plain).abs().max()
                        / plain.abs().max().clamp_min(1e-30))
            if not err <= 1e-5:
                raise RuntimeError(f"{dt} {tm}x{T}, {n_c} C tiles: kernel "
                                   f"vs plain {err:.2e}")
            times[n_c * pieces] = device_s(call, dev)
            del call, plain
        out[(dt, tm, T)] = times
        log(f"  {dt:8s} {tm:3d} x {T:3d}: " + ", ".join(
            f"{n}: {fmt_ms(t)}" for n, t in times.items()) + " ms by blocks")
        del a, b
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
                   help="matrix size of the thin points and of --items")
    p.add_argument("--latency", action="store_true",
                   help="the card model's per-item latency of one block and "
                        "its launch time, per item shape")
    p.add_argument("--items", action="store_true",
                   help="the card model's time per item on a full grid and "
                        "its L2 rate, per item shape, on the thin points' "
                        "pair")
    p.add_argument("--waves", action="store_true",
                   help="grids of C tiles from one block per SM to 16, "
                        "runs of 4 and 16 items: how blocks that share SMs "
                        "run")
    args = p.parse_args(argv)
    dtypes = args.dtypes.split(",")
    if args.latency or args.items or args.waves:
        from spada_tpu_torch.convert import check_device

        # the CPU runs the plain versions, untimed: T = 128 alone
        ts = TS_CPU if check_device(args.device).type == "cpu" else TS
        if args.latency:
            run_latency(ts, dtypes=dtypes, device=args.device)
            run_resident(ts, dtypes=dtypes, device=args.device)
        if args.items:
            run_items(args.thin_n, args.band, ts, dtypes=dtypes,
                      device=args.device)
        if args.waves:
            for length in (4, 16):
                run_waves(length, device=args.device)
    elif args.thin:
        run_thin(args.n, args.thin_n, args.band,
                 dtypes=args.dtypes.split(","), device=args.device)
    else:
        run(args.n, args.band, dtypes=args.dtypes.split(","),
            device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
