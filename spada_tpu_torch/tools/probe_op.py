"""The op dataflow's k-major engine against its byte bound and the row
schedule (port of ``tools/probe_op.py``).

``spgemm(dataflow="op")`` builds a k-major worklist (k outermost: the
partials of one C tile are spread over the whole list), which no tile
kernel can run, so ``select_engine`` sends it to the plain scatter-add
engine (``run_worklist_reference``: gather, ``bmm``, ``index_add_``), as
the reference sends it to XLA.  This probe asks whether a hand-written
k-major kernel would have headroom on the card, by timing, per tile dtype
(bf16, then f32, the reference's order):

- the op path: ``build_worklist(order="k")`` through
  ``prepare_worklist(engine="xla")``, the launch ``spgemm(dataflow="op")``
  makes;
- its byte bound: every item reads its A and B tile and read-modify-writes
  its f32 C tile in HBM (the k-major order visits C tiles out of turn, so
  partials cannot stay on chip: the op dataflow's structural cost),
  ``(W * 2 T^2 * isz + 2 * W * T^2 * 4) / HBM``; beside it the bound if C
  stayed on chip, ``(W * 2 T^2 * isz + nC * T^2 * 4) / HBM``; HBM is the
  card's datasheet rate (``config.datasheet_peaks``);
- the row schedule: the same operands under ``order="row"`` on
  ``tile_spgemm`` (``prepare_worklist(engine="cached")``; T = 384 runs its
  wide tensor-core block), the reference's cross-dataflow comparison.

The operands are the reference's: ``banded_csr(16384, 16384, 384, seed=0
/ 1)`` at T = 384: 377 items over 254 A and B tiles, 150 MB of f32 tiles
(75 MB bf16), well above the card's 50 MB L2, so the times are of tiles
read from HBM.  The op path's C must equal the row schedule's within 1e-5 of
max|C|, and both scipy's on C's first 2048 rows (f32 tiles < 1e-4, bf16 <
1e-2).  Times are ``utils.timing.cuda_time`` medians; with ``--device
cpu`` the plain versions run, gated, and their times are CPU wall seconds,
labelled so, with no share of the bound.

    python -m spada_tpu_torch.tools.probe_op
    python -m spada_tpu_torch.tools.probe_op --device cpu --n 2048 \\
        --band 128 --T 128
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict

import numpy as np

from spada_tpu_torch.tools.harness import (call_s, card_name,
                                           first_rows_ref, gate, tile_rows)

DTYPES = ("bfloat16", "float32")
#: the rows of C gated against scipy
GATE_ROWS = 2048
#: the gate on C's first rows against scipy, max|d| / max|ref|, by tile dtype
GATE = {"float32": 1e-4, "bfloat16": 1e-2}
#: the op path's C against the row schedule's, max|d| / max|C|
AGREE = 1e-5


def bounds(W: int, n_c: int, T: int, itemsize: int, hbm: float) -> tuple:
    """(read-modify-write s, on-chip C s): the k-major byte bound of ``W``
    items of T x T tiles of ``itemsize`` bytes, C read and written once per
    item in f32; and the bound if the ``n_c`` C tiles were written once."""
    ab = W * 2 * T * T * itemsize
    return (ab + 2 * W * T * T * 4) / hbm, (ab + n_c * T * T * 4) / hbm


def run(n: int = 16384, band: int = 384, T: int = 384, device="cuda",
        log: Callable[[str], None] = print) -> Dict[str, dict]:
    """Per tile dtype: the op path and the row schedule, gated and timed.
    Returns {dtype: {"W", "n_c", "op_s", "row_s", "rmw_s", "onchip_s",
    "share" (RMW bound over op time; None on the CPU), "ratio" (op over
    row), "agree", "gate_op", "gate_row", "timed" ('cuda' or 'cpu wall'),
    "op_device" (where the op path's C lies)}}."""
    import torch

    from spada_tpu_torch.config import datasheet_peaks
    from spada_tpu_torch.convert import bsr_to_torch, check_device
    from spada_tpu_torch.io.workloads import banded_csr
    from spada_tpu_torch.ops.engine import prepare_worklist
    from spada_tpu_torch.ops.worklist import build_worklist
    from spada_tpu_torch.sparse.bsr import BsrMatrix

    dev = check_device(device)
    name = card_name(dev)
    hbm = datasheet_peaks(name)["hbm_bytes_per_s"]
    t0 = time.perf_counter()
    a = banded_csr(n, n, bandwidth=band, seed=0, dtype=np.float32)
    b = banded_csr(n, n, bandwidth=band, seed=1, dtype=np.float32)
    a_bsr = BsrMatrix.from_csr(a, T, T, dtype=np.float32)
    b_bsr = BsrMatrix.from_csr(b, T, T, dtype=np.float32)
    wlk = build_worklist(a_bsr, b_bsr, order="k")
    wlr = build_worklist(a_bsr, b_bsr, order="row")
    ref = first_rows_ref(a, b, GATE_ROWS)
    W, n_c = wlk.n_items, wlk.n_c_tiles
    n_tiles = a_bsr.tiles.shape[0] + b_bsr.tiles.shape[0]
    log(f"banded {n}^2, band {band}, T={T}: W={W} nC={n_c}, "
        f"{n_tiles} A+B tiles ({n_tiles * T * T * 4 / 1e6:.0f} MB f32), "
        f"{time.perf_counter() - t0:.1f} s host; card "
        f"{name or 'none (cpu: plain versions, wall times)'}, HBM "
        f"{hbm / 1e12:.2f} TB/s (datasheet)")
    timed = "cuda" if dev.type == "cuda" else "cpu wall"
    out = {}
    for dt in DTYPES:
        tdt = getattr(torch, dt)
        at, bt = bsr_to_torch(a_bsr, dev, tdt), bsr_to_torch(b_bsr, dev, tdt)
        op_call = prepare_worklist(wlk, at, bt, engine="xla")
        row_call = prepare_worklist(wlr, at, bt, engine="cached")
        c_op, c_row = op_call(), row_call()
        agree = float((c_op - c_row).abs().max()
                      / c_row.abs().max().clamp_min(1e-30))
        if not agree <= AGREE:
            raise RuntimeError(f"{dt} tiles: the op path's C differs from "
                               f"the row schedule's by {agree:.3e} of max|C| "
                               f"(limit {AGREE:g})")
        errs = [gate(tile_rows(c, wl.c_tile_row, wl.c_tile_col, T, T,
                               (n, n), GATE_ROWS), ref, GATE[dt],
                     f"{dt} tiles, {label}")
                for c, wl, label in ((c_op, wlk, "op path"),
                                     (c_row, wlr, "row schedule"))]
        op_device = str(c_op.device)
        del c_op, c_row
        op_s, row_s = call_s(op_call, dev), call_s(row_call, dev)
        rmw_s, onchip_s = bounds(W, n_c, T, tdt.itemsize, hbm)
        share = rmw_s / op_s if dev.type == "cuda" else None
        out[dt] = {"W": W, "n_c": n_c, "op_s": op_s, "row_s": row_s,
                   "rmw_s": rmw_s, "onchip_s": onchip_s, "share": share,
                   "ratio": op_s / row_s, "agree": agree,
                   "gate_op": errs[0], "gate_row": errs[1], "timed": timed,
                   "op_device": op_device}
        reached = ("not measured (cpu)" if share is None
                   else f"{share:.1%} reached")
        log(f"[{dt}] op/k-major W={W} nC={n_c}: op path {op_s * 1e3:.3f} ms "
            f"({timed}) | k-major RMW bound {rmw_s * 1e3:.3f} ms "
            f"({reached}) | if-C-stayed-on-chip bound {onchip_s * 1e3:.3f} "
            f"ms | spada/row tile_spgemm {row_s * 1e3:.3f} ms ({timed}) | "
            f"op/spada {op_s / row_s:.2f}x | op vs row {agree:.1e}, gates "
            f"{errs[0]:.1e} / {errs[1]:.1e}")
        del op_call, row_call, at, bt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=16384, help="matrix size")
    p.add_argument("--band", type=int, default=384, help="band half-width")
    p.add_argument("--T", type=int, default=384, help="tile edge")
    args = p.parse_args(argv)
    run(args.n, args.band, args.T, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
