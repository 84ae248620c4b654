"""The warpgroup block of ``tile_spgemm`` at the expert cell's tile shape.

A grouped product as ``deepseek-v3-experts-ep32.prefill-4k``'s: ``experts``
experts of about ``rows`` rows each (each count drawn from the seed, rarely
a multiple of 64, so some 64-row panels straddle two experts), H's rows of
expert e nonzero only in its ``k_tiles`` x T columns, times the stacked
expert weights (``k_tiles`` x ``cols`` B tiles of T x T per expert), in
64 x T A tiles: one row worklist, each C tile's run ``k_tiles`` items (two
experts' on a straddling panel).  The same operands run on:

- ``thin``: a direct ``tile_spgemm`` launch, the thin block
  (``tile_spgemm_thin<float, 64, false>``);
- ``wg``: the prepared launch (``ops.engine.prepare_cached``), the
  warpgroup block over its schedule of panel pairs;

each timed on CUDA events (``tools.harness.call_s``), beside the bound
(``config.roofline_bound``: the useful FLOP at the 3xTF32 rate, 165 TFLOP/s,
or each tile read once and C written once at the HBM rate), the plain
version and one batched ``torch.matmul`` of the experts' dense blocks (f32,
TF32 off), with both C gated against the plain version's and against the
float64 product of the first ``check`` C tiles (max|d| / max|ref|).  On the
CPU the plain version runs, gated, untimed.

    python -m spada_tpu_torch.tools.sweep_wgmma
    python -m spada_tpu_torch.tools.sweep_wgmma --device cpu --experts 2 \
        --rows 96 --k-tiles 2 --cols 2 --T 128
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from spada_tpu_torch.tools.harness import call_s, card_name, fmt_ms

#: the gate of each kernel's C against the plain version's and float64's,
#: of max|C|
TOL = 1e-5


def grouped_product(experts: int, rows: int, k_tiles: int, cols: int,
                    T: int, seed: int, dev) -> dict:
    """The operands and worklist of the grouped product (module doc), f32
    tiles on ``dev``, and its useful FLOP."""
    rng = np.random.default_rng(seed)
    counts = rows + rng.integers(-rows // 40 - 1, rows // 40 + 2, experts)
    counts = np.maximum(counts, 1)
    first = np.r_[0, np.cumsum(counts)]
    n_panels = -(-int(first[-1]) // 64)
    expert_of = np.repeat(np.arange(experts), counts)
    present = [np.unique(expert_of[64 * p:64 * p + 64])
               for p in range(n_panels)]
    # A tile (p, e, i): panel p's rows of expert e, its k-tile i
    tile_p = np.repeat(np.arange(n_panels), [len(x) * k_tiles
                                             for x in present])
    tile_e = np.repeat(np.concatenate(present), k_tiles)
    a_of, n = {}, 0
    for p in range(n_panels):
        for e in present[p]:
            a_of[p, e] = n
            n += k_tiles
    a_ids, b_ids, o_ids = [], [], []
    for p in range(n_panels):
        for j in range(cols):
            for e in present[p]:
                for i in range(k_tiles):
                    o_ids.append(p * cols + j)
                    a_ids.append(a_of[p, e] + i)
                    b_ids.append((e * k_tiles + i) * cols + j)
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((n, 64, T), generator=gen, device=dev)
    owner = torch.from_numpy(np.r_[expert_of, np.full(
        n_panels * 64 - len(expert_of), -1)]).to(dev).view(n_panels, 64)
    a *= (owner[torch.from_numpy(tile_p).to(dev)]
          == torch.from_numpy(tile_e).to(dev)[:, None]).unsqueeze(2)
    b = torch.randn((experts * k_tiles * cols, T, T), generator=gen,
                    device=dev)
    flop = 2 * int(counts.sum()) * k_tiles * T * cols * T
    return {"a": a, "b": b, "a_ids": np.array(a_ids, np.int32),
            "b_ids": np.array(b_ids, np.int32),
            "o_ids": np.array(o_ids, np.int32), "n_c": n_panels * cols,
            "counts": counts, "flop": flop, "panels": n_panels}


def _f64(op: dict, n_tiles: int) -> torch.Tensor:
    """float64 C of the first ``n_tiles`` C tiles."""
    o = op["o_ids"]
    w = int(np.searchsorted(o, n_tiles))
    a, b = op["a"], op["b"]
    c = torch.zeros((n_tiles, a.shape[1], b.shape[2]), dtype=torch.float64,
                    device=a.device)
    ai, bi, oi = (torch.from_numpy(x[:w]).to(a.device).long()
                  for x in (op["a_ids"], op["b_ids"], o))
    for s in range(0, w, 256):
        c.index_add_(0, oi[s:s + 256], torch.bmm(
            a[ai[s:s + 256]].double(), b[bi[s:s + 256]].double()))
    return c


def _dense_matmul(op: dict, k_tiles: int, cols: int, T: int):
    """A call of one batched torch.matmul of the experts' dense blocks,
    each padded to the most rows."""
    counts, a = op["counts"], op["a"]
    most = int(counts.max())
    gen = torch.Generator(device=a.device).manual_seed(1)
    h = torch.randn((len(counts), most, k_tiles * T), generator=gen,
                    device=a.device)
    w = torch.randn((len(counts), k_tiles * T, cols * T), generator=gen,
                    device=a.device)
    return lambda: torch.matmul(h, w)


def run(experts: int = 8, rows: int = 4096, k_tiles: int = 8,
        cols: int = 28, T: int = 256, seed: int = 0, device: str = "cuda",
        check: int = 64, log=print) -> list:
    """One row per kernel: kernel (``thin`` or ``wg``), block, launches,
    ms, useful tflop_s, pct_bound (the bound's share of ms), err (against
    float64), plain_err and plain_abs_err (against the plain version),
    plain_ms, bound_ms, bound_by and lib_ms (times None on the CPU);
    raises where an error passes :data:`TOL`."""
    from spada_tpu_torch import _build
    from spada_tpu_torch.config import roofline_bound, tile_work
    from spada_tpu_torch.convert import tile_ptr_of
    from spada_tpu_torch.ops.engine import (prepare_cached,
                                            run_worklist_reference,
                                            tile_spgemm)

    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    op = grouped_product(experts, rows, k_tiles, cols, T, seed, dev)
    n_c, check = op["n_c"], min(check, op["n_c"])
    ids = [torch.from_numpy(x).to(dev) for x in
           (op["a_ids"], op["b_ids"], tile_ptr_of(op["o_ids"], n_c))]
    o_dev = torch.from_numpy(op["o_ids"]).to(dev)
    prepared = prepare_cached(op["a"], op["b"], op["a_ids"], op["b_ids"],
                              op["o_ids"], n_c)
    sched = prepared.schedule
    units = ("none" if sched is None
             else f"{sched.pairs} pairs, {sched.singles} singles")
    log(f"{experts} experts, {int(op['counts'].sum())} rows, "
        f"{op['panels']} panels, T {T}, {k_tiles} k-tiles x {cols} columns: "
        f"W = {len(op['a_ids'])}, {op['flop'] / 1e9:.2f} useful GFLOP; "
        f"schedule: {units}; card {card_name(dev) or 'none (cpu)'}")
    exact = _f64(op, check)
    _, nbytes = tile_work(op["a"], op["b"], len(op["a_ids"]), n_c)
    bound, by = roofline_bound(op["flop"], nbytes, card_name(dev), "float32",
                               matmul=True)
    plain = (lambda: run_worklist_reference(op["a"], op["b"], ids[0], ids[1],
                                            o_dev, n_c))
    c_plain = plain()
    rows_out = []
    cases = {"thin": ("mma_thin",
                      lambda: tile_spgemm(op["a"], op["b"], *ids)),
             "wg": (prepared.block, prepared)}
    for name, (block, call) in cases.items():
        before = _build.launches.copy()
        c = call()
        ran = dict(_build.launches - before)
        err = float((c[:check].double() - exact).abs().max()
                    / exact.abs().max())
        p_abs = float((c - c_plain).abs().max())
        p_err = p_abs / float(c_plain.abs().max())
        del c
        if not (err <= TOL and p_err <= TOL):
            raise RuntimeError(f"{name}: {err:.3e} of max|C| from float64, "
                               f"{p_err:.3e} from the plain version "
                               f"(limit {TOL:g})")
        s = call_s(call, dev, warmup=1, reps=5) if dev.type == "cuda" else None
        row = {"kernel": name, "block": block, "launches": ran,
               "ms": None if s is None else s * 1e3, "err": err,
               "plain_err": p_err, "plain_abs_err": p_abs}
        if s is not None:
            row["tflop_s"] = op["flop"] / s / 1e12
            row["pct_bound"] = 100 * bound / s
        rows_out.append(row)
        log(f"  {name:5s} on {block}: {fmt_ms(s)} ms"
            + ("" if s is None else f", {row['tflop_s']:.1f} TFLOP/s useful, "
               f"{row['pct_bound']:.1f}% of the bound")
            + f"; vs float64 {err:.2e}, vs plain {p_err:.2e}; "
            f"launches {ran}")
    del c_plain
    p_s = call_s(plain, dev, warmup=1, reps=3) if dev.type == "cuda" else None
    lib_s = (call_s(_dense_matmul(op, k_tiles, cols, T), dev, warmup=1,
                    reps=5) if dev.type == "cuda" else None)
    for row in rows_out:
        row.update(plain_ms=None if p_s is None else p_s * 1e3,
                   bound_ms=bound * 1e3, bound_by=by,
                   lib_ms=None if lib_s is None else lib_s * 1e3)
    log(f"  bound {bound * 1e3:.3f} ms ({by}); plain {fmt_ms(p_s)} ms; "
        f"torch.matmul of the dense expert blocks {fmt_ms(lib_s)} ms")
    return rows_out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--experts", type=int, default=8)
    p.add_argument("--rows", type=int, default=4096,
                   help="mean rows per expert")
    p.add_argument("--k-tiles", type=int, default=8)
    p.add_argument("--cols", type=int, default=28)
    p.add_argument("--T", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    run(args.experts, args.rows, args.k_tiles, args.cols, args.T, args.seed,
        args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
