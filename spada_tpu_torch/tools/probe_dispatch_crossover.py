"""The tile/element dispatch crossover, measured on the card (port of
``tools/probe_dispatch_crossover.py``).

Family: n = 32768 band-384 matrices with the per-row fill r swept downward
(192, 96, 48, 24, 12).  The band geometry, so the tile worklist and the tile
side's time, stays about the same while the element side's product count E
~ r^2 shrinks, so the family walks across the dispatch boundary.  For each
member:

- ``dispatch_dataflow`` under ``h100_config(engine_dtype="bfloat16")``, the
  tile dtype the reference modelled and ran, once with the reference's
  per-item terms, planner form and element fixed time (``SpadaConfig``'s
  per-item terms, ``choose_tile_size`` and ``estimate_element_time``'s 30
  us, fitted on its chip) and once with the card's (``h100_config``'s
  own: the card's tile model, ``plan.card_model.card_tile_size``);
- the tile side as the bench's tile entry runs it (``bench.py``
  ``_tile_entry``): the T the tile model takes under those terms
  (:func:`tile_model`), one uniform row worklist, bf16 tiles, one
  ``tile_spgemm`` launch;
- the element side as the bench's element entry runs it
  (``_element_entry``): ``spgemm_element(backend="auto")``'s one ESC plan
  and one ``esc_stream_group`` launch (one per row slab above 2^28
  products, as ``spgemm_element`` splits them);
- both sides gated against scipy on their first 2048 rows (bf16 tiles
  1e-2 of max|C|, the element side 1e-3) and timed on CUDA events.

It prints the reference's table, one row per fill and set of terms: the
dispatch, the modelled tile and element ms, the measured ones, each
model's residual, the winner and OK / WRONG.  A WRONG row is a finding, not a failure.  On the CPU the
plain versions run and are gated, and nothing is timed.

``--element-fit`` (:func:`run_element_fit`) measures the element model's
fixed term instead: for each multiply of a family that runs from tiny to
large plans (the crossover's pairs at n = 32768 and at n = 8192, fills
192..12; the graded FEM's A·A at 129 edges; locpl, the localized
power-law pair of 65536^2 at degree 32), the ESC plan's streamed bytes
(``ops.spgemm.element_plan_bytes``, the bytes ``estimate_element_time``
charges) and the device time of its ``esc_stream_group`` launches, gated
like the element side above, with the host's enqueue time of the same
launches beside it (not in the fit).  Then ``config.fit_element_fixed``:
``t ~= bytes / hbm + fixed``, at the card's datasheet byte rate, each
residual relative to t, ``fixed`` >= 0; the points print as
``config._ELEMENT_FIT`` records them.  On the CPU the family shrinks to
:data:`ELEMENT_FIT_CPU` (n = 1024, the FEM at 33 edges, no locpl), run
and gated, untimed.

    python -m spada_tpu_torch.tools.probe_dispatch_crossover
    python -m spada_tpu_torch.tools.probe_dispatch_crossover --element-fit
    python -m spada_tpu_torch.tools.probe_dispatch_crossover --device cpu --n 2048 --fills 48,12
    python -m spada_tpu_torch.tools.probe_dispatch_crossover --element-fit --device cpu --fills 48,12
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np

from spada_tpu_torch.tools.harness import (card_name, device_s,
                                           element_entry, enqueue_s,
                                           first_rows_ref, fmt_ms, gate,
                                           reference_item_terms, tile_rows)

FILLS = (192, 96, 48, 24, 12)
#: the element fit's sizes of the crossover's pairs
ELEMENT_FIT_NS = (32768, 8192)
#: the element fit's graded FEM (edges per side) and locpl pair (n, degree)
ELEMENT_FIT_FEM = 129
ELEMENT_FIT_LOCPL = (65536, 32.0)
#: the element fit's family on the CPU, where nothing is timed: the same
#: path at small sizes
ELEMENT_FIT_CPU = {"ns": (1024,), "fem_edges": 33, "locpl": None}


def banded_fill_csr(n, bandwidth, fill, seed, dtype=np.float32):
    """Band of half-width ``bandwidth`` with only ``fill`` nonzeros/row."""
    rng = np.random.default_rng(seed)
    from spada_tpu_torch.sparse.csr import CsrMatrix

    rows = np.repeat(np.arange(n), fill)
    offs = rng.integers(-bandwidth, bandwidth + 1, n * fill)
    cols = np.clip(rows + offs, 0, n - 1)
    vals = rng.standard_normal(n * fill).astype(dtype)
    return CsrMatrix.from_coo((n, n), rows, cols, vals)


def configs(name: Optional[str]) -> dict:
    """{terms: the bf16 profile on the card named ``name``}."""
    from spada_tpu_torch.config import (REFERENCE_ELEMENT_FIXED_S,
                                        h100_config)

    return {"v5e": h100_config(name, engine_dtype="bfloat16",
                               element_fixed_s=REFERENCE_ELEMENT_FIXED_S,
                               **reference_item_terms()),
            "fit": h100_config(name, engine_dtype="bfloat16")}


def tile_model(a, b, cfg) -> tuple:
    """(T, seconds): the tile edge and the tile model's time the main path
    would run under ``cfg`` (``plan.card_model.planner_for``'s tile-edge
    choice, in full; dispatch itself may leave a clearly slower tile side
    at a bound)."""
    from spada_tpu_torch.plan.card_model import planner_for

    T, det = planner_for(cfg)[0](a, b, cfg)
    return T, det[T]["t_est"]


def tile_side(a, b, T: int, dev, ref, gate_rows: int) -> tuple:
    """(seconds or None, W, relerr): one bf16 ``tile_spgemm`` launch of the
    uniform T x T row worklist, gated to 1e-2."""
    import torch

    from spada_tpu_torch.convert import bsr_to_torch
    from spada_tpu_torch.ops.engine import prepare_worklist
    from spada_tpu_torch.ops.worklist import build_worklist
    from spada_tpu_torch.sparse.bsr import BsrMatrix

    a_bsr = BsrMatrix.from_csr(a, T, T, dtype=np.float32)
    b_bsr = BsrMatrix.from_csr(b, T, T, dtype=np.float32)
    wl = build_worklist(a_bsr, b_bsr, order="row")
    call = prepare_worklist(wl, bsr_to_torch(a_bsr, dev, torch.bfloat16),
                            bsr_to_torch(b_bsr, dev, torch.bfloat16),
                            engine="cached")
    err = gate(tile_rows(call(), wl.c_tile_row, wl.c_tile_col, T, T,
                         (a.shape[0], b.shape[1]), gate_rows), ref, 1e-2,
               f"tile side, T={T}")
    return device_s(call, dev), wl.n_items, err


def run(fills: Sequence[int] = FILLS, n: int = 32768, band: int = 384,
        device="cuda", gate_rows: int = 2048,
        log: Callable[[str], None] = print) -> list:
    """One row per fill and set of terms: (fill, terms, T, dispatch, model
    tile s, model element s, measured tile s, measured element s, winner,
    verdict)."""
    import torch

    from spada_tpu_torch.convert import check_device
    from spada_tpu_torch.ops.element import expansion_products
    from spada_tpu_torch.ops.spgemm import dispatch_dataflow

    dev = check_device(device)
    name = card_name(dev)
    cfgs = configs(name)
    log(f"n={n} band={band}, bf16 tiles; card {name or 'none (cpu)'}")
    rows = []
    for fill in fills:
        t0 = time.perf_counter()
        a = banded_fill_csr(n, band, fill, seed=fill)
        b = banded_fill_csr(n, band, fill, seed=fill + 1)
        ref = first_rows_ref(a, b, gate_rows)
        e = expansion_products(a, b)
        decided = {k: (*dispatch_dataflow(a, b, cfg), *tile_model(a, b, cfg))
                   for k, cfg in cfgs.items()}
        tile = {}
        for k, (choice, det, T, t_model) in decided.items():
            log(f"fill={fill} [{k}]: dispatch={choice} T={T} modeled tile "
                f"{t_model * 1e3:.3f} elem "
                f"{det['element']['t_est'] * 1e3:.3f} ms "
                f"({det['element'].get('bytes_model')})")
            if T not in tile:
                tile[T] = tile_side(a, b, T, dev, ref, gate_rows)
                log(f"  tile T={T}: {fmt_ms(tile[T][0])} ms W={tile[T][1]} "
                    f"gate {tile[T][2]:.1e}")
        calls, csr = element_entry(a, b, dev)
        err = gate(csr[:gate_rows], ref, 1e-3, f"element side, fill {fill}")
        e_s = device_s(lambda: [c() for c in calls], dev)
        log(f"  element E={e}: {fmt_ms(e_s)} ms, {len(calls)} launch(es), "
            f"gate {err:.1e} "
            f"({time.perf_counter() - t0:.1f} s host+device)")
        del calls, csr
        for k, (choice, det, T, t_model) in decided.items():
            t_s = tile[T][0]
            if t_s is None:
                winner, ok = "-", "-"
            else:
                winner = "tile" if t_s < e_s else "element"
                ok = "OK" if winner == choice else "WRONG"
            rows.append((fill, k, T, choice, t_model,
                         det["element"]["t_est"], t_s, e_s, winner, ok))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log(table(rows))
    return rows


def table(rows) -> str:
    """The reference's markdown table, with the terms and T beside the
    fill and each side's model residual, (model - measured) / measured."""
    def ms(x):
        return "not timed" if x is None else f"{x * 1e3:.4f}"

    def res(model, s):
        return "" if s is None else f"{(model - s) / s:+.1%}"

    lines = ["| fill | terms | T | dispatch | model tile | model elem | "
             "meas tile | meas elem | tile residual | elem residual | "
             "winner | verdict |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for fill, k, T, choice, mt, me, t_s, e_s, winner, ok in rows:
        lines.append(f"| {fill} | {k} | {T} | {choice} | {ms(mt)} | "
                     f"{ms(me)} | {ms(t_s)} | {ms(e_s)} | {res(mt, t_s)} | "
                     f"{res(me, e_s)} | {winner} | {ok} |")
    return "\n".join(lines)


def element_family(fills: Sequence[int] = FILLS,
                   ns: Sequence[int] = ELEMENT_FIT_NS,
                   fem_edges: Optional[int] = ELEMENT_FIT_FEM,
                   locpl: Optional[tuple] = ELEMENT_FIT_LOCPL):
    """(label, A, B) of each multiply of the element fit, generated one at
    a time: the crossover's pairs at each n of ``ns`` and fill of
    ``fills``, the graded FEM's A·A at ``fem_edges`` edges, locpl at
    ``locpl`` = (n, degree); None leaves one out."""
    from spada_tpu_torch.io.workloads import (fem_q1_graded_csr,
                                              localized_powerlaw_csr)

    for n in ns:
        for fill in fills:
            yield (f"banded-fill {n} {fill}",
                   banded_fill_csr(n, 384, fill, seed=fill),
                   banded_fill_csr(n, 384, fill, seed=fill + 1))
    if fem_edges:
        fem = fem_q1_graded_csr(fem_edges, fem_edges, dtype=np.float32)
        yield f"fem-graded-{fem_edges}", fem, fem
    if locpl:
        m, deg = locpl
        yield (f"locpl {m} {deg:g}",
               localized_powerlaw_csr(m, m, deg, seed=1, dtype=np.float32),
               localized_powerlaw_csr(m, m, deg, seed=2, dtype=np.float32))


def element_point(a, b, dev, cap: int = 512, gate_rows: int = 2048) -> dict:
    """One multiply of the element side (:func:`harness.element_entry`),
    gated to 1e-3: {"e_products", "bytes" (``element_plan_bytes``),
    "launches", "device_s", "enqueue_s", "relerr"}; the times None on the
    CPU."""
    from spada_tpu_torch.ops.element import expansion_products
    from spada_tpu_torch.ops.spgemm import element_plan_bytes

    ref = first_rows_ref(a, b, gate_rows)
    calls, csr = element_entry(a, b, dev, cap=cap)
    err = gate(csr[:gate_rows], ref, 1e-3, "element side")
    del csr

    def multiply():
        return [c() for c in calls]

    return {"e_products": expansion_products(a, b),
            "bytes": element_plan_bytes(a, b, cap=cap)["bytes"],
            "launches": len(calls), "device_s": device_s(multiply, dev),
            "enqueue_s": enqueue_s(multiply, dev), "relerr": err}


def run_element_fit(fills: Sequence[int] = FILLS,
                    ns: Sequence[int] = ELEMENT_FIT_NS, device="cuda",
                    fem_edges: Optional[int] = ELEMENT_FIT_FEM,
                    locpl: Optional[tuple] = ELEMENT_FIT_LOCPL,
                    gate_rows: int = 2048,
                    log: Callable[[str], None] = print) -> dict:
    """Each multiply of :func:`element_family` measured
    (:func:`element_point`), then the fit.  Returns {"points": {label:
    point}, "fixed": ``config.fit_element_fixed``'s seconds, or None on the
    CPU}."""
    import torch

    from spada_tpu_torch.config import datasheet_peaks, fit_element_fixed
    from spada_tpu_torch.convert import check_device

    dev = check_device(device)
    name = card_name(dev)
    bw = datasheet_peaks(name)["hbm_bytes_per_s"]
    log(f"element fit at {bw / 1e12:.2f} TB/s; card {name or 'none (cpu)'}")
    points = {}
    for label, a, b in element_family(fills, ns, fem_edges, locpl):
        t0 = time.perf_counter()
        p = points[label] = element_point(a, b, dev, gate_rows=gate_rows)
        log(f"  {label}: E={p['e_products']} bytes {p['bytes']} in "
            f"{p['launches']} launch(es): {fmt_ms(p['device_s'])} ms, host "
            f"enqueue {fmt_ms(p['enqueue_s'])} ms, gate {p['relerr']:.1e} "
            f"({time.perf_counter() - t0:.1f} s host+device)")
        del a, b
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    fixed = None
    if dev.type == "cuda":
        fixed = fit_element_fixed({k: (p["bytes"], p["device_s"])
                                   for k, p in points.items()}, bw)
        log("points for config._ELEMENT_FIT:")
        log("    " + repr({k: (p["bytes"], float(f"{p['device_s']:.4g}"))
                           for k, p in points.items()}))
    log(element_table(points, bw, fixed))
    if fixed is not None:
        log(f"fit, relative to each t, fixed >= 0: t ~= bytes / "
            f"{bw / 1e12:.2f} TB/s + {fixed * 1e6:.3f} us")
    return {"points": points, "fixed": fixed}


def element_table(points: dict, bw: float, fixed: Optional[float]) -> str:
    """Markdown: per multiply its products, bytes, launches, device ms, the
    byte term, the fit's ms and residual (relative to t), host enqueue
    ms."""
    def ms(x):
        return "not timed" if x is None else f"{x * 1e3:.4f}"

    lines = ["| multiply | E | bytes | launches | device ms | bytes/hbm ms | "
             "fit ms | residual | host enqueue ms |",
             "|---|---|---|---|---|---|---|---|---|"]
    for k, p in points.items():
        t, by = p["device_s"], p["bytes"] / bw
        fit = None if fixed is None else by + fixed
        res = "" if fit is None or t is None else f"{(t - fit) / t:+.1%}"
        lines.append(f"| {k} | {p['e_products']} | {p['bytes']} | "
                     f"{p['launches']} | {ms(t)} | {by * 1e3:.4f} | "
                     f"{ms(fit)} | {res} | {ms(p['enqueue_s'])} |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--fills", default=",".join(map(str, FILLS)))
    p.add_argument("--n", type=int, default=32768,
                   help="the crossover's matrix size")
    p.add_argument("--element-fit", action="store_true",
                   help="the element model's fixed term, measured on the "
                        "family's sizes (on the CPU: ELEMENT_FIT_CPU's)")
    args = p.parse_args(argv)
    fills = [int(x) for x in args.fills.split(",")]
    if args.element_fit:
        from spada_tpu_torch.convert import check_device

        small = check_device(args.device).type == "cpu"
        run_element_fit(fills, device=args.device,
                        **(ELEMENT_FIT_CPU if small else {}))
    else:
        run(fills, n=args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
