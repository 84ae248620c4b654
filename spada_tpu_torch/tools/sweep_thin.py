"""The thin-panel sweep: the tile kernels on uniform row panels of height 8
to 128, the heights the per-row-group planner picks among
(``config.tm_choices``).

Input: ``banded_csr(n, n, 384, seed=0 / 1)`` (the pair of
``probe_item_overhead``), or with ``pair="cari"`` the CLI's stock matrix
(``matrices/cari.mtx``, C = A A^T, from the working directory), B in T x T
tiles, A in tm x T tiles for each tm
of :data:`TMS`, one row worklist per tm, f32 and bf16 tiles, built once per
tm and run by each engine of ``engines`` (:data:`ENGINES`, in that order):
``tile_spgemm`` (:func:`~spada_tpu_torch.ops.engine.prepare_cached`, the
default), ``tile_stream`` at each ogroup of :data:`OGROUPS`, ``tile_panel``
with f32 output on the k-transposed copy of A, and ``tile_grid``.  Each
case is one launch, gated against its plain version (1e-5 of max|C|) and
against scipy on C's first 2048 rows (f32 tiles 1e-4, bf16 1e-2); on a card
``tile_stream`` at ogroup 1 and ``tile_panel`` must also give
``tile_spgemm``'s C bit for bit, so asking for either runs ``tile_spgemm``
too, first.  ``grid_chunks`` adds, on the thin block, a ``tile_grid`` case
for each G given to its C entry point (``tile_grid G=g``), beside
``tile_grid``'s own case at the G of ``ops.engine.grid_chunk``: the
measurement behind that rule.  Then it is timed on CUDA events
(``utils.timing.cuda_time``) beside:

- the block it ran on (:func:`~spada_tpu_torch.ops.engine.tile_block`);
- W, the ns per item, and the bound (``config.roofline_bound`` on
  ``config.tile_work``: the pair's useful products, each tile read once, C
  written once);
- the plain version's time;
- the library call: ``torch.bmm`` of :data:`LIB_ITEMS` (A, B) item pairs
  gathered beforehand, in the tile dtype (cuBLAS, TF32 off), as ns per item;
  for the cases of ``lib_whole`` also one ``torch.bmm`` of all W pairs, in
  ms.

Timing launches are taken back out of the launch counts
(``harness.call_s``), so a run counts one launch of its kernel per case.
On the CPU the plain versions run and are gated, not timed.

    python -m spada_tpu_torch.tools.sweep_thin
    python -m spada_tpu_torch.tools.sweep_thin --engines tile_spgemm,tile_stream,tile_panel,tile_grid
    python -m spada_tpu_torch.tools.sweep_thin --engines tile_spgemm,tile_grid --grid-chunks 1,2,4,8,16
    python -m spada_tpu_torch.tools.sweep_thin --pair cari --tms 64 --engines tile_grid --grid-chunks 1,2,4
    python -m spada_tpu_torch.tools.sweep_thin --device cpu --n 2048
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from spada_tpu_torch.tools.harness import (card_name, device_s,
                                           first_rows_ref, gate, tile_rows)

TMS = (8, 16, 32, 64, 128)
DTYPES = ("float32", "bfloat16")
#: the gate on C's first rows, max|d| / max|ref|, by tile dtype
GATE = {"float32": 1e-4, "bfloat16": 1e-2}
#: the gate of a kernel against its plain version, of max|C|
PLAIN_TOL = 1e-5
#: the item pairs of the library call's per-item time
LIB_ITEMS = 16384
#: the tile kernels the sweep runs, in this order
ENGINES = ("tile_spgemm", "tile_stream", "tile_panel", "tile_grid")
#: tile_stream's group sizes: run_worklist_streaming's default and the
#: reference's
OGROUPS = (1, 8)
#: tile_stream's ring, run_worklist_streaming's default nbuf
NBUF = 8
#: the cases that must give tile_spgemm's C bit for bit on a card
BITWISE = ("tile_stream og=1", "tile_panel")
#: the operand pairs: the banded pair, or the CLI's stock matrix
PAIRS = ("banded", "cari")


def banded_pair(n: int = 32768, band: int = 384) -> tuple:
    """The sweep's operands: ``banded_csr(n, n, band, seed=0 / 1)``, f32."""
    from spada_tpu_torch.io.workloads import banded_csr

    return (banded_csr(n, n, bandwidth=band, seed=0, dtype=np.float32),
            banded_csr(n, n, bandwidth=band, seed=1, dtype=np.float32))


def relerr(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def run(n: int = 32768, band: int = 384, T: int = 128,
        tms: Sequence[int] = TMS, dtypes: Sequence[str] = DTYPES,
        device="cuda", gate_rows: int = 2048,
        lib_whole: Sequence[tuple] = (),
        engines: Sequence[str] = ("tile_spgemm",),
        pair: str = "banded", grid_chunks: Sequence[int] = (),
        ab: Optional[tuple] = None,
        log: Callable[[str], None] = print) -> List[dict]:
    """Every (dtype, tm, engine case) case, gated and (on a card) timed;
    the engines run in :data:`ENGINES`' order, ``tile_spgemm`` added where
    ``tile_stream`` or ``tile_panel`` is asked for.  ``ab``: the banded
    pair (:func:`banded_pair`) when the caller has it.  Returns one dict per
    case: engine (the case's label), kernel, dtype, tm, block, W, n_c, ms,
    ns_item, plain_ms, bound_ms, bound_by, lib_ns_item, lib_ms (the bmm of
    all W pairs, for the (dtype, tm) cases of ``lib_whole``, else None),
    chunk (``tile_grid``'s G on the thin block: the one given, or on a card
    the rule's; else None),
    plain_err (of max|C|), plain_abs_err, gate_err, same_bits (whether C
    equals ``tile_spgemm``'s bit for bit; None for ``tile_spgemm`` and
    where it did not run)."""
    from spada_tpu_torch.config import roofline_bound, tile_work
    from spada_tpu_torch.convert import (bsr_to_torch, check_device,
                                         worklist_to_torch)
    from spada_tpu_torch.config import SpadaConfig
    from spada_tpu_torch.io.workloads import GemmWorkload
    from spada_tpu_torch.ops.engine import (grid_chunk, sm_count,
                                            thin_pieces, tile_block)
    from spada_tpu_torch.ops.worklist import build_worklist
    from spada_tpu_torch.sparse.bsr import BsrMatrix
    from spada_tpu_torch.utils.timing import cuda_time

    unknown = set(engines) - set(ENGINES)
    if pair not in PAIRS:
        raise ValueError(f"unknown pair {pair!r}; expected one of {PAIRS}")
    if unknown:
        raise ValueError(f"unknown engines {sorted(unknown)}; expected some "
                         f"of {ENGINES}")
    asked = set(engines)
    if asked & {"tile_stream", "tile_panel"}:
        asked.add("tile_spgemm")  # the C they must equal bit for bit
    engines = [e for e in ENGINES if e in asked]
    dev = check_device(device)
    name = card_name(dev)
    t0 = time.perf_counter()
    if pair == "cari":
        w = GemmWorkload.from_suitesparse(SpadaConfig().ss_filepath, "cari")
        a, b = w.a.astype(np.float32), w.b.astype(np.float32)
        what = f"cari {a.shape[0]} x {a.shape[1]}"
    else:
        a, b = ab or banded_pair(n, band)
        what = f"banded {n}^2, band {band}"
    c_shape = (a.shape[0], b.shape[1])
    ref = first_rows_ref(a, b, gate_rows)
    b_bsr = BsrMatrix.from_csr(b, T, T, dtype=np.float32)
    log(f"{what}, T = {T}: nnz {a.nnz} / {b.nnz} "
        f"({time.perf_counter() - t0:.1f} s host); card {name or 'none (cpu)'}")
    rows = []
    for tm in tms:
        t0 = time.perf_counter()
        a_bsr = BsrMatrix.from_csr(a, tm, T, dtype=np.float32)
        wl = build_worklist(a_bsr, b_bsr, order="row")
        dwl = worklist_to_torch(wl, dev)
        host_s = time.perf_counter() - t0
        W = int(wl.n_items)
        for dt in dtypes:
            tdt = getattr(torch, dt)
            a_t = bsr_to_torch(a_bsr, dev, tdt)
            b_t = bsr_to_torch(b_bsr, dev, tdt)
            flops, nbytes = tile_work(a_t, b_t, W, wl.n_c_tiles, a, b)
            bound_s, by = roofline_bound(flops, nbytes, name, dt,
                                         matmul=True)
            lib_ns = lib_ms = None
            if dev.type == "cuda":
                def bmm_s(k):
                    """one bmm of the first k item pairs, gathered first"""
                    ag = a_t[dwl.a_tid[:k].long()]
                    bg = b_t[dwl.b_tid[:k].long()]
                    return device_s(lambda: torch.bmm(ag, bg), dev)

                k = min(LIB_ITEMS, W)
                lib_ns = bmm_s(k) / k * 1e9
                if (dt, tm) in lib_whole:
                    lib_ms = bmm_s(W) * 1e3
            c_spgemm = None
            thin = tile_block(tm, T, T, tdt, "tile_grid") == "mma_thin"
            rule_g = (grid_chunk(W, thin_pieces(tm, T), sm_count(dev))
                      if thin and dev.type == "cuda" else None)
            chunks = tuple(grid_chunks) if thin else ()
            for label, kernel, call, plain, g in _cases(
                    engines, a_t, b_t, wl, dwl, dev, chunks, rule_g):
                c, p = call(), plain()
                p_err, p_abs = relerr(c, p), float((c - p).abs().max())
                del p
                if not p_err <= PLAIN_TOL:
                    raise RuntimeError(f"{dt} tm={tm}: {label} vs plain "
                                       f"{p_err:.3e} > {PLAIN_TOL:g}")
                g_err = gate(tile_rows(c, wl.c_tile_row, wl.c_tile_col, tm,
                                       T, c_shape, gate_rows), ref, GATE[dt],
                             f"{label}, {dt} tiles, tm={tm}")
                same = None
                if kernel == "tile_spgemm":
                    c_spgemm = c
                elif c_spgemm is not None:
                    same = bool(torch.equal(c, c_spgemm))
                    if (dev.type == "cuda" and label in BITWISE
                            and not same):
                        raise RuntimeError(f"{dt} tm={tm}: {label} is not "
                                           f"tile_spgemm's C bit for bit")
                del c
                row = {"engine": label, "kernel": kernel, "dtype": dt,
                       "tm": tm, "W": W, "n_c": int(wl.n_c_tiles),
                       "block": tile_block(tm, T, T, tdt, kernel),
                       "ms": None, "ns_item": None, "plain_ms": None,
                       "bound_ms": bound_s * 1e3, "bound_by": by,
                       "lib_ns_item": lib_ns, "lib_ms": lib_ms,
                       "plain_err": p_err, "plain_abs_err": p_abs,
                       "gate_err": g_err, "same_bits": same, "chunk": g}
                if dev.type == "cuda":
                    k_s = device_s(call, dev)
                    p_s = cuda_time(plain, warmup=1, reps=3)[0]
                    row.update(ms=k_s * 1e3, ns_item=k_s / W * 1e9,
                               plain_ms=p_s * 1e3)
                rows.append(row)
                log(case_line(row) + f"  (BSR + worklist {host_s:.1f} s)")
            del a_t, b_t, c_spgemm
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    log(report(rows, name))
    return rows


def _cases(engines, a_t, b_t, wl, dwl, dev, grid_chunks=(), rule_g=None):
    """(label, kernel, call, plain, G) of each engine case on one operand
    set: the calls the engines' ``run_worklist_*`` make (``tile_stream``
    with their nbuf, once per ogroup of :data:`OGROUPS`; ``tile_grid`` at
    the rule's G, ``rule_g``, and at each G of ``grid_chunks``)."""
    from spada_tpu_torch.convert import item_ptr_of
    from spada_tpu_torch.ops import engine as E

    ai, bi, oi, tp, n_c = (dwl.a_tid, dwl.b_tid, dwl.o_tid, dwl.tile_ptr,
                           dwl.n_c_tiles)
    cases = []
    for eng in engines:
        if eng == "tile_spgemm":
            cases.append((eng, eng, E.prepare_cached(
                a_t, b_t, wl.a_tid, wl.b_tid, wl.o_tid, n_c),
                lambda: E.run_worklist_reference(a_t, b_t, ai, bi, oi, n_c),
                None))
        elif eng == "tile_stream":
            for og in OGROUPS:
                ip = torch.from_numpy(item_ptr_of(wl.o_tid, n_c, og)).to(dev)
                args = (a_t, b_t, ai, bi, oi, ip, n_c, og, NBUF)
                cases.append((f"tile_stream og={og}", eng,
                              lambda args=args: E.tile_stream(*args),
                              lambda args=args: E.tile_stream_reference(
                                  *args), None))
        elif eng == "tile_panel":
            args = (a_t.transpose(1, 2).contiguous(), b_t, ai, bi, tp)
            cases.append((eng, eng, lambda args=args: E.tile_panel(*args),
                          lambda args=args: E.tile_panel_reference(*args),
                          None))
        else:
            args = (a_t, b_t, ai, bi, oi, n_c)

            def plain(args=args):
                return E.tile_grid_reference(*args)

            cases.append((eng, eng, lambda args=args: E.tile_grid(*args),
                          plain, rule_g))
            for g in grid_chunks:
                cases.append((f"tile_grid G={g}", eng,
                              lambda args=args, g=g: E._tile_grid_launch(
                                  *args, chunk=g), plain, g))
    return cases


def _f(x, fmt: str) -> str:
    return "not timed" if x is None else format(x, fmt)


def case_line(r: dict) -> str:
    same = {None: "", True: ", tile_spgemm's bits",
            False: ", not tile_spgemm's bits"}[r["same_bits"]]
    return (f"  {r['engine']:16s} {r['dtype']:8s} tm={r['tm']:3d} on "
            f"{r['block']:11s} "
            f"W={r['W']:7d} nC={r['n_c']:6d}  {_f(r['ms'], '.3f')} ms, "
            f"{_f(r['ns_item'], '.1f')} ns/item  plain "
            f"{_f(r['plain_ms'], '.3f')} ms  bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']})  bmm {_f(r['lib_ns_item'], '.1f')} ns/item"
            + ("" if r["lib_ms"] is None else
               f", of all W pairs {r['lib_ms']:.3f} ms")
            + f"  vs plain {r['plain_err']:.1e}, vs scipy {r['gate_err']:.1e}"
            + same + ("" if r["chunk"] is None else f", G {r['chunk']}"))


def report(rows: List[dict], card: Optional[str]) -> str:
    """Markdown: one line per case."""
    lines = [f"thin-panel sweep on {card or 'the CPU (not timed)'}:",
             "| tiles | tm | block | engine | G | W | ms | ns/item | plain ms "
             "| bound ms | bmm ns/item |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['dtype']} | {r['tm']} | {r['block']} | {r['engine']} | "
            f"{'' if r['chunk'] is None else r['chunk']} | {r['W']} | "
            f"{_f(r['ms'], '.3f')} | {_f(r['ns_item'], '.1f')} | "
            f"{_f(r['plain_ms'], '.3f')} | {r['bound_ms']:.3f} "
            f"({r['bound_by']}) | {_f(r['lib_ns_item'], '.1f')} |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=32768, help="matrix size")
    p.add_argument("--band", type=int, default=384, help="band half-width")
    p.add_argument("--T", type=int, default=128, help="tk = tn")
    p.add_argument("--tms", default=",".join(map(str, TMS)))
    p.add_argument("--dtypes", default=",".join(DTYPES))
    p.add_argument("--engines", default="tile_spgemm",
                   help=f"some of {','.join(ENGINES)}")
    p.add_argument("--pair", default="banded", choices=PAIRS)
    p.add_argument("--grid-chunks", default="",
                   help="tile_grid's thin cases also at these G, e.g. "
                        "1,2,4,8,16")
    args = p.parse_args(argv)
    run(args.n, args.band, args.T, [int(x) for x in args.tms.split(",")],
        args.dtypes.split(","), args.device, engines=args.engines.split(","),
        pair=args.pair,
        grid_chunks=[int(x) for x in args.grid_chunks.split(",") if x])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
