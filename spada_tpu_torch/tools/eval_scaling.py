"""Weak scaling, halo against psum-merge, D = 1..8 (port of
``tools/eval_scaling.py``).

Weak scaling: the banded pair grows with D (n = 8192 * D rows, band 256,
row panels of tm = 128; ``--quick``: 2048 * D, band 96, tm 64), so the
work per rank stays about constant.  At each D the pair is partitioned for
both strategies: halo (``partition_halo``, D ranks) and psum-merge
(``partition_spgemm``, n_dp x n_tp = D/2 x 2 for even D, else D x 1).
Three things are reported, and they must not be conflated:

1. *Functional*, the counterpart of the reference's virtual mesh: a gloo
   group of D ranks on the CPU (spawned processes, a ``FileStore`` in a
   temporary directory, all D's groups at once) runs ``spgemm_halo`` and
   ``spgemm_sharded`` (the plain f32 engine, as the reference's runs off
   the TPU); every rank must return the same C, gated against scipy as the
   reference gates it: ``allclose(rtol=1e-4, atol=1e-4)`` on all of C up to
   n = 16384, above that each rank panel's first 256 rows (max|d| /
   max|ref| < 1e-4).  Not timed.
2. *Measured on the card*: every rank's body (``halo_rank`` with its
   received tiles read from the problem by ``halo_received``;
   ``sharded_rank`` for each (d, t)) on bf16 tiles, the model's
   ``tile_itemsize`` of 2, timed one after another on the one card
   (``cuda_time``, the median of 5): the busiest body's ms, and the
   max/mean of the bodies' ms.  Each body's panels are gated against scipy
   (bf16 tiles: 1e-2 of max|C| on their first 256 rows; psum-merge's
   summed over tp).  No link byte moves on one card.
3. *Modeled*: ``parallel.scaling``'s closed form (the reference's):
   busiest-shard roofline compute on the card's datasheet rates, plus the
   planned bytes over the datasheet link rate (``h100_config``'s
   ``ici_bytes_per_s``: NVLink from one GPU to one peer, one way; a
   placeholder, not measured), halo transfers overlapped with the local
   segment.

With ``--device cpu`` the configuration is ``SpadaConfig()`` (the
reference's own, whose link rate is its chip's) and the bodies run their
plain versions, timed in CPU wall seconds and labelled so.  The table goes
to stdout and, with ``--out PATH``, to that file; by default no file is
written.

    python -m spada_tpu_torch.tools.eval_scaling [--quick] [--out PATH]
    python -m spada_tpu_torch.tools.eval_scaling --device cpu --quick
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import pickle
import sys
import tempfile
import time
from typing import Callable, Dict, List, Sequence

import numpy as np

from spada_tpu_torch.tools.harness import (call_s, card_name, gate,
                                           gloo_group, rank_path,
                                           spawn_groups, tile_rows)

DEVICES = (1, 2, 4, 8)
#: (rows per rank, band half-width, tm): the reference's sizes
FULL = (8192, 256, 128)
QUICK = (2048, 96, 64)
#: the functional gate compares all of C up to this n, panels above it
FULL_GATE_MAX = 16384
#: the rows of each rank panel gated against scipy
PANEL_ROWS = 256
#: the panel gate, max|d| / max|ref|: f32 tiles (functional), bf16 (card)
F32_GATE, BF16_GATE = 1e-4, 1e-2
#: per-collective limit in the functional groups' ranks
COLLECTIVE_TIMEOUT_S = 300
#: the limit on all of the functional groups together
GROUPS_TIMEOUT_S = 900


@dataclasses.dataclass
class Point:
    """One D of the sweep: the banded pair and its two partitions."""

    D: int
    a: object
    b: object
    halo: object
    reduce: object


def reduce_mesh(D: int) -> tuple:
    """(n_dp, n_tp) of the psum-merge at D ranks: tp 2 for even D."""
    n_tp = 2 if D % 2 == 0 else 1
    return D // n_tp, n_tp


def point(D: int, size: tuple, config) -> Point:
    """The banded pair at D (seeds 0 and 1, f32) and both partitions."""
    from spada_tpu_torch.io.workloads import banded_csr
    from spada_tpu_torch.parallel import partition_halo, partition_spgemm

    base_n, band, tm = size
    n = base_n * D
    a = banded_csr(n, n, bandwidth=band, seed=0, dtype=np.float32)
    b = banded_csr(n, n, bandwidth=band, seed=1, dtype=np.float32)
    return Point(D, a, b, partition_halo(a, b, D, config, tm=tm),
                 partition_spgemm(a, b, *reduce_mesh(D), config, tm=tm))


def panel_gate(a, b, view, c_tiles, limit: float, label: str) -> float:
    """The worst max|d| / max|ref| over each rank panel's first
    :data:`PANEL_ROWS` rows of C (``c_tiles`` [n_dp, >= nC, tm, tn],
    ``view`` a ``ShardedProblem`` or ``halo_view``) against scipy; raises
    above ``limit``."""
    a_sp = a.to_scipy()
    b64 = b.to_scipy().astype(np.float64)
    worst = 0.0
    for d in range(view.n_dp):
        r0 = int(view.row_base[d])
        r1 = (int(view.row_base[d + 1]) if d + 1 < view.n_dp
              else view.shape[0])
        rows = min(PANEL_ROWS, r1 - r0)
        if rows <= 0:
            continue
        nc = int(view.n_c_tiles[d])
        got = tile_rows(c_tiles[d, :nc], view.c_tile_row[d, :nc],
                        view.c_tile_col[d, :nc], view.tm, view.tn,
                        (r1 - r0, view.shape[1]), rows)
        ref = (a_sp[r0:r0 + rows].astype(np.float64) @ b64).tocsr()
        worst = max(worst, gate(got, ref, limit, f"{label}, panel {d}"))
    return worst


def check_functional(p: Point, view, c_tiles, label: str, ref=None
                     ) -> str:
    """The reference's gate of a functional run's C: where ``ref`` (scipy's
    C, up to :data:`FULL_GATE_MAX`) is given, ``allclose(rtol=1e-4,
    atol=1e-4)`` on every element, |d| - rtol |ref| <= atol evaluated on
    the sparse patterns (elsewhere both are 0); without it, the panels'
    first rows."""
    from spada_tpu_torch.parallel.spgemm import ShardedResult

    if ref is not None:
        got = ShardedResult(view, c_tiles).to_csr().to_scipy()
        worst = float((abs(got - ref) - 1e-4 * abs(ref)).max())
        if not worst <= 1e-4:
            raise RuntimeError(f"{label}: C is not allclose(rtol=1e-4, "
                               f"atol=1e-4) to scipy's: |d| - rtol |ref| "
                               f"reaches {worst:.3e}")
        return "allclose(rtol=1e-4, atol=1e-4) on all of C"
    err = panel_gate(p.a, p.b, view, c_tiles, F32_GATE, label)
    return f"panels' first {PANEL_ROWS} rows {err:.1e}"


def functional(points: Sequence[Point],
               log: Callable[[str], None] = print) -> Dict[int, tuple]:
    """Each point's gloo group of D ranks on the CPU (:func:`run_groups`),
    every rank's C the same, gated.  Returns {D: (halo C tiles, psum-merge
    C tiles)}, each [n_dp, nCmax + 1, tm, tn] f32."""
    from spada_tpu_torch.parallel.halo import halo_view

    t0 = time.perf_counter()
    out = run_groups({p.D: (p.halo, p.reduce) for p in points})
    log(f"  functional: gloo groups of {[p.D for p in points]} ranks on "
        f"the CPU, {time.perf_counter() - t0:.1f} s; every rank returned "
        f"the same C")
    for p in points:
        c_h, c_r = out[p.D]
        ref = (p.a.to_scipy().astype(np.float64) @ p.b.to_scipy()
               if p.a.shape[0] <= FULL_GATE_MAX else None)
        g_h = check_functional(p, halo_view(p.halo), c_h, f"halo D={p.D}",
                               ref)
        g_r = check_functional(p, p.reduce, c_r,
                               f"psum-merge {reduce_mesh(p.D)}", ref)
        log(f"  D={p.D} n={p.a.shape[0]}: halo {g_h}; psum-merge "
            f"{reduce_mesh(p.D)} {g_r}")
    return out


def run_groups(jobs: Dict[int, tuple]) -> Dict[int, tuple]:
    """Run ``spgemm_halo`` and ``spgemm_sharded`` on each job's (halo
    problem, psum-merge problem) in a spawned gloo group of D ranks on the
    CPU (``harness.spawn_groups``), every group at once, in a temporary
    directory: the problems go to the ranks and the results come back
    through files.  Rank 0 returns its C tiles, the others a digest of
    theirs, which must match.  Raises if a rank raises or the groups
    outlast :data:`GROUPS_TIMEOUT_S`."""
    with tempfile.TemporaryDirectory(prefix="eval_scaling_") as tmp:
        dirs = {}
        for D, probs in jobs.items():
            dirs[D] = os.path.join(tmp, f"D{D}")
            os.mkdir(dirs[D])
            with open(os.path.join(dirs[D], "problems.pkl"), "wb") as f:
                pickle.dump(probs, f)
        spawn_groups([(D, work) for D, work in dirs.items()], _rank_main,
                     GROUPS_TIMEOUT_S)
        out = {}
        for D, work in dirs.items():
            res = []
            for r in range(D):
                with open(rank_path(work, r), "rb") as f:
                    res.append(pickle.load(f))
            c = res[0]
            want = tuple(_digest(x) for x in c)
            for r, got in enumerate(res[1:], 1):
                if tuple(got) != want:
                    raise RuntimeError(f"D={D}: rank {r}'s C differs from "
                                       f"rank 0's")
            out[D] = c
    return out


def _digest(x: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def _rank_main(rank: int, world: int, work: str) -> None:
    """One rank of a functional group: both entry points on the CPU."""
    import warnings

    import torch

    from spada_tpu_torch.parallel import spgemm_halo, spgemm_sharded

    # torch's notice that the collectives the entry points call are renamed
    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_num_threads(1)
    with open(os.path.join(work, "problems.pkl"), "rb") as f:
        halo, reduce = pickle.load(f)
    with gloo_group(rank, world, work, COLLECTIVE_TIMEOUT_S):
        c = (spgemm_halo(halo, device="cpu", engine="xla").c_tiles,
             spgemm_sharded(reduce, device="cpu", engine="xla").c_tiles)
        tmp = rank_path(work, rank) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(c if rank == 0 else tuple(_digest(x) for x in c), f)
        os.replace(tmp, rank_path(work, rank))


def halo_bodies(problem, dev, dtype=None) -> tuple:
    """Every halo rank's body on ``dev`` (``tile_spgemm`` on ``dtype``
    tiles, bf16 by default), its received tiles read from the problem: (ms
    per body, C tiles [D, nCmax + 1, tm, tn])."""
    import torch

    from spada_tpu_torch.parallel.halo import halo_rank, halo_received

    p, dtype = problem, dtype or torch.bfloat16
    c = np.zeros((p.n_dev, p.nCmax + 1, p.tm, p.tn), np.float32)
    ms = []
    for r in range(p.n_dev):
        got = {k: torch.from_numpy(halo_received(p, r, k)).to(dev, dtype)
               for k in range(1, p.n_dev)}
        body = halo_rank(p, r, dev, "cached", dtype)
        c[r] = body(got.__getitem__).cpu().numpy()
        ms.append(call_s(body, dev, got.__getitem__, warmup=1, reps=5) * 1e3)
        del body, got
    return ms, c


def reduce_bodies(problem, dev, dtype=None) -> tuple:
    """Every psum-merge rank's body on ``dev`` (``tile_spgemm`` on
    ``dtype`` tiles, bf16 by default): (ms per body in (d, t) order, C
    tiles [n_dp, nCmax + 1, tm, tn] summed over tp)."""
    import torch

    from spada_tpu_torch.parallel.spgemm import sharded_rank

    p, dtype = problem, dtype or torch.bfloat16
    c = np.zeros((p.n_dp, p.nCmax + 1, p.tm, p.tn), np.float32)
    ms = []
    for d in range(p.n_dp):
        for t in range(p.n_tp):
            body = sharded_rank(p, d, t, dev, "cached", dtype)
            c[d] += body().cpu().numpy()
            ms.append(call_s(body, dev, warmup=1, reps=5) * 1e3)
            del body
    return ms, c


def card(points: Sequence[Point], dev, config,
         log: Callable[[str], None] = print) -> List[dict]:
    """Every rank body of each point timed on ``dev`` and gated, beside the
    model's estimates under ``config``.  One row per point."""
    from spada_tpu_torch.parallel.halo import halo_view
    from spada_tpu_torch.parallel.scaling import (estimate_halo_scaling,
                                                  estimate_reduce_scaling)

    rows = []
    for p in points:
        h_est = estimate_halo_scaling(p.halo, config)
        r_est = estimate_reduce_scaling(p.reduce, config)
        h_ms, c_h = halo_bodies(p.halo, dev)
        g_h = panel_gate(p.a, p.b, halo_view(p.halo), c_h, BF16_GATE,
                         f"halo D={p.D} bodies")
        r_ms, c_r = reduce_bodies(p.reduce, dev)
        g_r = panel_gate(p.a, p.b, p.reduce, c_r, BF16_GATE,
                         f"psum-merge {reduce_mesh(p.D)} bodies")
        del c_h, c_r
        row = {"D": p.D, "n": p.a.shape[0], "halo": h_est, "reduce": r_est,
               "halo_ms": h_ms, "reduce_ms": r_ms,
               "halo_imb": max(h_ms) / np.mean(h_ms),
               "reduce_imb": max(r_ms) / np.mean(r_ms)}
        rows.append(row)
        log(f"  D={p.D} n={row['n']}: halo eff={h_est.efficiency:.3f} (comm "
            f"{h_est.comm_s * 1e3:.3f} ms, overlap "
            f"{h_est.overlap_s * 1e3:.3f} ms; busiest body {max(h_ms):.3f} "
            f"ms, model {h_est.compute_s * 1e3:.3f} ms; gate {g_h:.1e})  "
            f"reduce eff={r_est.efficiency:.3f} (comm "
            f"{r_est.comm_s * 1e3:.3f} ms; busiest body {max(r_ms):.3f} ms, "
            f"model {r_est.compute_s * 1e3:.3f} ms; gate {g_r:.1e})")
        if dev.type == "cuda":
            import torch

            torch.cuda.empty_cache()
    return rows


def table(rows: Sequence[dict], size: tuple, config, name) -> str:
    """The markdown report: the reference's columns, then the measured
    ones, under a header that says which is which."""
    base_n, band, tm = size
    timed = (f"device ms on {name}" if name
             else "CPU wall ms of the plain versions, not a device time")
    lines = [
        "# Weak-scaling evaluation (halo vs psum-merge), one card",
        "",
        "**What is measured and what is modeled.**",
        "",
        "1. *Functional*: `spgemm_halo` and `spgemm_sharded` in gloo groups "
        "of D ranks on the CPU, every rank's C the same and gated against "
        "scipy. Not timed.",
        f"2. *Measured*, in {timed}: every rank's body (`halo_rank`, "
        "`sharded_rank`; `tile_spgemm` on bf16 tiles) one after another; "
        "the busiest body and max/mean of the bodies. The halo bodies read "
        "their received tiles from the problem: no link byte moves on one "
        "card.",
        "3. *Modeled*: the efficiency, comm and compute columns are "
        "`parallel/scaling.py`'s closed form: busiest-shard roofline compute "
        f"at {config.hbm_bytes_per_s / 1e12:.2f} TB/s and "
        f"{config.peak_flops_bf16 / 1e12:.0f} TFLOP/s bf16, plus the planned "
        f"bytes at {config.ici_bytes_per_s / 1e9:.0f} GB/s per link one way "
        "(a datasheet rate, not measured), halo transfers overlapped with "
        "the local segment.",
        "",
        f"Workload: banded n = {base_n}·D, band {band}, tm {tm}; work per "
        "rank about constant. Psum-merge mesh (n_dp, n_tp): tp 2 for even "
        "D.",
        "",
        "| D | n | halo eff (modeled) | halo comm (hidden) ms, modeled | "
        "reduce eff (modeled) | reduce comm ms, modeled | "
        "imbalance h/r (plan) | halo busiest body ms (measured) / compute "
        "ms (model) | reduce busiest body ms (measured) / compute ms (model) "
        "| imbalance h/r (measured, body ms) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        h, rd = r["halo"], r["reduce"]
        lines.append(
            f"| {r['D']} | {r['n']} | {h.efficiency:.1%} | "
            f"{h.comm_s * 1e3:.3f} ({h.overlap_s * 1e3:.3f}) | "
            f"{rd.efficiency:.1%} | {rd.comm_s * 1e3:.3f} | "
            f"{h.imbalance:.2f} / {rd.imbalance:.2f} | "
            f"{max(r['halo_ms']):.3f} / {h.compute_s * 1e3:.3f} | "
            f"{max(r['reduce_ms']):.3f} / {rd.compute_s * 1e3:.3f} | "
            f"{r['halo_imb']:.2f} / {r['reduce_imb']:.2f} |")
    return "\n".join(lines) + "\n"


def run(quick: bool = False, device="cuda", out=None,
        log: Callable[[str], None] = print) -> List[dict]:
    """The sweep at one size: each D's functional group, then its rank
    bodies on ``device``; prints the table and writes it to ``out`` if
    given.  Returns the table's rows."""
    from spada_tpu_torch.config import SpadaConfig, h100_config
    from spada_tpu_torch.convert import check_device

    dev = check_device(device)
    name = card_name(dev)
    config = h100_config(name) if name else SpadaConfig()
    size = QUICK if quick else FULL
    t0 = time.perf_counter()
    points = [point(D, size, config) for D in DEVICES]
    log(f"banded pairs and partitions at D = {list(DEVICES)}: "
        f"{time.perf_counter() - t0:.1f} s host")
    functional(points, log=log)
    rows = card(points, dev, config, log)
    text = table(rows, size, config, name)
    log(text)
    if out:
        with open(out, "w") as f:
            f.write(text)
        log(f"wrote {out}")
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--quick", action="store_true",
                   help="2048 rows per rank, band 96, tm 64")
    p.add_argument("--out", default=None,
                   help="also write the table to this file")
    args = p.parse_args(argv)
    run(args.quick, args.device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
