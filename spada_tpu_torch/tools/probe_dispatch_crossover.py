"""The tile/element dispatch crossover, measured on the card (port of
``tools/probe_dispatch_crossover.py``).

Family: n = 32768 band-384 matrices with the per-row fill r swept downward
(192, 96, 48, 24, 12).  The band geometry, so the tile worklist and the tile
side's time, stays about the same while the element side's product count E
~ r^2 shrinks, so the family walks across the dispatch boundary.  For each
member:

- ``dispatch_dataflow`` under ``h100_config(engine_dtype="bfloat16")``, the
  tile dtype the reference modelled and ran, once with the reference's
  per-item terms (``SpadaConfig``'s, fitted on its chip) and once with the
  card's fit (``h100_config``'s own);
- the tile side as the bench's tile entry runs it (``bench.py``
  ``_tile_entry``): ``choose_tile_size``'s T under those terms, one uniform
  row worklist, bf16 tiles, one ``tile_spgemm`` launch;
- the element side as the bench's element entry runs it
  (``_element_entry``): ``spgemm_element(backend="auto")``'s one ESC plan
  and one ``esc_stream_group`` launch (one per row slab above 2^28
  products, as ``spgemm_element`` splits them);
- both sides gated against scipy on their first 2048 rows (bf16 tiles
  1e-2 of max|C|, the element side 1e-3) and timed on CUDA events.

It prints the reference's table, one row per fill and set of terms: the
dispatch, the modelled tile and element ms, the measured ones, the winner
and OK / WRONG.  A WRONG row is a finding, not a failure.  On the CPU the
plain versions run and are gated, and nothing is timed.

    python -m spada_tpu_torch.tools.probe_dispatch_crossover
    python -m spada_tpu_torch.tools.probe_dispatch_crossover --device cpu --n 2048 --fills 48,12
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np

from spada_tpu_torch.tools.harness import (card_name, device_s,
                                           element_entry, first_rows_ref,
                                           fmt_ms, gate,
                                           reference_item_terms, tile_rows)

FILLS = (192, 96, 48, 24, 12)


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
    from spada_tpu_torch.config import h100_config

    return {"v5e": h100_config(name, engine_dtype="bfloat16",
                               **reference_item_terms()),
            "fit": h100_config(name, engine_dtype="bfloat16")}


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
        decided = {k: dispatch_dataflow(a, b, cfg) for k, cfg in cfgs.items()}
        tile = {}
        for k, (choice, det) in decided.items():
            T = det["tile_T"]
            log(f"fill={fill} [{k}]: dispatch={choice} T={T} modeled tile "
                f"{det['tile'][T]['t_est'] * 1e3:.3f} elem "
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
        for k, (choice, det) in decided.items():
            T = det["tile_T"]
            t_s = tile[T][0]
            if t_s is None:
                winner, ok = "-", "-"
            else:
                winner = "tile" if t_s < e_s else "element"
                ok = "OK" if winner == choice else "WRONG"
            rows.append((fill, k, T, choice, det["tile"][T]["t_est"],
                         det["element"]["t_est"], t_s, e_s, winner, ok))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log(table(rows))
    return rows


def table(rows) -> str:
    """The reference's markdown table, with the terms and T beside the
    fill."""
    def ms(x):
        return "not timed" if x is None else f"{x * 1e3:.3f}"

    lines = ["| fill | terms | T | dispatch | model tile | model elem | "
             "meas tile | meas elem | winner | verdict |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for fill, k, T, choice, mt, me, t_s, e_s, winner, ok in rows:
        lines.append(f"| {fill} | {k} | {T} | {choice} | {ms(mt)} | "
                     f"{ms(me)} | {ms(t_s)} | {ms(e_s)} | {winner} | {ok} |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--fills", default=",".join(map(str, FILLS)))
    p.add_argument("--n", type=int, default=32768)
    args = p.parse_args(argv)
    run([int(x) for x in args.fills.split(",")], n=args.n,
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
