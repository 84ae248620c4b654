"""Smoke run of spada_tpu_torch on one NVIDIA GPU.

Run from the repository root, with no arguments, on a machine with a CUDA
card, the CUDA toolkit (nvcc) and PyTorch built for CUDA:

    python3 chip_smoke.py

It builds the hand-written kernels from ``spada_tpu_torch/csrc`` and drives
the port's main path, ``spgemm(dataflow="spada")`` through the CLI and
``run_spada``:

1. environment: versions, the card's name and power limit, nvcc, build time,
   and the HMMA (tensor-core) instructions of the tensor-core kernels of
   ``tile_spgemm``, ``tile_stream``, ``tile_panel`` and ``tile_grid``
   (each its wide and its thin block) and ``tile_probe_mma``
   (``cuobjdump -sass``): a kernel with none, or a
   toolkit without cuobjdump, fails the run;
2. each kernel against its plain PyTorch version on the card
   (``tile_spgemm`` at tm 8-512, tn = tk in {128, 512}: its wide and thin
   tensor-core blocks; ``tile_stream`` with ogroup 1
   and 8, ``tile_panel`` with f32 and bf16 output, ``tile_grid``, at tm
   8-512: max|d|/max|ref| <= 1e-5, the bf16 output its own f32 output
   rounded once and within one bf16 ulp plus 1e-5 of max|ref| of the plain
   value, empty runs exact zeros, ``tile_stream`` at ogroup 1 and
   ``tile_panel``'s f32 output ``tile_spgemm``'s C bit for bit, and each
   thin shape counted as a launch of the thin block, which the kernels
   report; at tn = 64 and tm 8, 16 and 64 ``tile_spgemm``, ``tile_stream``,
   ``tile_panel`` and ``tile_grid`` on their narrow SIMT blocks,
   ``tile_spgemm`` against
   the plain version too; ``esc_stream_mul`` bitwise; ``esc_stream_red``:
   <= 1e-6; ``esc_stream_group`` on plans of 1 to 10 classes bitwise its
   per-class kernels, twice the same bits);
3. ``cari`` through the port's CLI, equal to scipy (rtol 1e-4, atol 1e-3),
   once on the auto engine (``tile_spgemm``), once under each
   ``--engine streaming | panel | pallas_grid``, each launching its kernel
   and not ``tile_spgemm``, on its thin block (cari is one tm-64 panel;
   ``pallas_grid``'s engine time printed beside the items each of its
   blocks takes, ``ops.engine.grid_chunk``'s G), and once with
   ``--plan-scheme profiled``; each
   run prints its ``device perf:`` line, whose shares of a peak must be at
   most 100%; then the ``plan`` mode under both schemes (exit 0; the
   profiled one launches ``tile_spgemm``);
4. the NN pair (16384^2 block-sparse weight x 16384x4096 ReLU activations,
   f32) through ``run_spada`` twice: under ``h100_config`` (the card's
   per-item fit; the main path) and under the reference's per-item terms
   (its T = 512 plan runs the tensor-core block at full width whatever the
   fit picks; the run fails if neither plan reaches that block): each
   dispatched to the tile kernel, gated against scipy/numpy on its first
   2048 rows (max|d|/max|ref| < 1e-4), on every plan segment kernel and
   plain version compared (<= 1e-5) and timed, each labelled with the block
   it runs on; ``measure_device_perf`` on the run's ``host_state`` within
   10% of the sum of those kernel times, its shares at most 100%; then (4b) ``spgemm_csr`` on the pair in 4 output slabs of
   64 MB of C tiles, one ``tile_spgemm`` launch each, gated the same way,
   its peak device memory beside a one-shot ``spgemm``'s; then (4c) the
   thin-panel sweep (``tools/sweep_thin``): the banded 32768^2 pair
   (band 384) at T = 128 in uniform row panels of tm 8, 16, 32, 64 and
   128, f32 and bf16 tiles, the operands built once per tm and run by
   each tile kernel (``tile_spgemm``; ``tile_stream`` at ogroup 1 and 8;
   ``tile_panel``, f32 output; ``tile_grid``), one launch per case, each
   against its plain version (<= 1e-5) and scipy (f32 < 1e-4, bf16 <
   1e-2), ``tile_stream`` at ogroup 1 and ``tile_panel`` bit for bit
   ``tile_spgemm``'s C, printed with its block, ms, W, ns per item, bound,
   and one ``torch.bmm`` of 16384 gathered item pairs as ns per item (for
   the f32 tm-64 case of the kernels line also one of all W pairs, in
   ms);
5. the localized power-law pair (65536^2, degree 32): dispatched to the
   element side, one grouped launch per multiply and no per-class launch,
   gated against scipy on 2048 rows (< 1e-3); on every class the per-class
   wrappers and the grouped launch held to the plain versions (mul bitwise,
   red 1e-6) and to each other (bitwise); the grouped launch timed beside
   the per-class launches, the plain versions and the library calls, with
   the host's enqueue time per multiply; the red block shapes and the
   grouped launch's class orders swept; then, on a 8192^2 cut of the pair,
   ``spgemm_element(backend="xla")`` and row-slab runs of both backends
   (four slabs or more) against scipy (1e-5 of max|C|);
   ``measure_device_perf`` of the element side within 10% of the grouped
   launch's own time, its share of HBM SoL at most 100%;
6. the engine override at full width: phase 4's fitted plan of the NN pair
   run again through ``spgemm(..., plan=)`` under each ``engine``
   streaming, panel and pallas_grid, gated against scipy/numpy (< 1e-4) and
   against phase 4's ``tile_spgemm`` result (<= 1e-5), each kernel timed
   beside its plain version on the launches the run made (``tile_stream``
   also at ogroup 1 against 8, in one timing); then each of the three
   kernels against its plain version (<= 1e-5), timed, on every segment of
   phase 4's other plan;
7. the probes (``spada_tpu_torch.tools``) at their tools' sizes: every mode
   of ``tile_probe`` on the banded 65536^2 / T=256 / bf16 workload of
   ``probe_kernel`` and ``probe_manual``, on the FP32 SIMT block
   (``block="simt"``) and on the tensor-core block with its own modes, and
   the tensor-core block's modes on the same pair as f32 tiles (modes that
   write zeros or nothing bitwise equal to their plain versions, the rest,
   full and flat among them, within 1e-5 of max|C|, ``onepass`` within 1e-5
   of the product of the operands rounded to TF32, ``nofold`` within 5e-4),
   ``probe_panel3d`` (``tile_spgemm`` and
   ``tile_panel`` on runs of two slot tiles, 1e-5; its library call one
   ``torch.bmm`` of the gathered run pairs) and
   ``probe_pallas_stream`` (the stream kernels as the main path launches
   them, and the probe's bulk-copy pipeline of the same functions at a
   sweep of stage sizes, ring depths and blocks per SM: every stage row
   bitwise the main path's kernel, mul bitwise its plain version, red
   within 1e-6; the red rows also timed with L2 flushed; each kernel's
   fastest stage row goes into the kernels line), each mode timed beside
   its bound;
8. the sparse MLP (``spada_tpu_torch.models.sparse_nn``): ``entry()``'s
   forward against a dense f64 forward of the same tiles (< 1e-5), then two
   layers of the bench's NN weight width (16384^2, density 0.2, 128^2
   tiles, batch 1024, f32): forward and one step's tile gradients against
   dense f64 (< 1e-4), three SGD steps with a falling loss, and forward and
   step times beside one dense ``torch.matmul`` layer (TF32 off);
9. the distributed strategies (``spada_tpu_torch.parallel``): (a) on a
   one-rank NCCL group in this process (a ``HashStore``), the nn pair at
   128-edge tiles through ``partition_spgemm`` and ``spgemm_sharded``
   (``tile_spgemm``; f32 tiles against scipy < 1e-4 and equal to phase 4's
   single-device C to 1e-5, bf16 tiles against scipy < 1e-2),
   ``spgemm_halo`` at D = 1 (the sharded bf16 C to 1e-5), the locpl pair
   through ``spgemm_element_dp`` (one ``esc_stream_group`` launch, scipy
   < 1e-3), ``make_sharded_train_step`` on a (1, 1) mesh (parameters and
   loss after one step equal to ``make_train_step``'s to 1e-5), and
   ``run_worklist_panel`` on phase 4's plan under each run order (C equal
   to row order's to 1e-5); (b) every rank's body of a (4, 2) psum-merge
   and a D = 4 halo partition of the nn pair (f32 tiles, each panel
   against scipy on its first rows and the single-device C) and of a D = 4
   element partition of locpl (the slabs put together against scipy), one
   after another on this card; (c) where there are two cards or more, (a)'s
   entry points across ``min(count, 8)`` cards, one NCCL rank per card
   (otherwise one line says why not).  Host partition seconds and device
   ms per strategy and rank body are printed beside the nvidia-smi line;
10. the planner's calibration and evaluation tools
   (``spada_tpu_torch.tools``) at reduced depth, every C gated against
   scipy on its first 2048 rows: (a) ``probe_item_overhead`` on the banded
   32768^2 pair, T = 128..512, f32 and bf16 tiles, the per-item fit
   printed; (b) ``probe_dispatch_crossover`` at fills 48 and 12 under the
   reference's per-item terms and the card's fit, and at fill 192 the
   dispatch and the tile side only (its element side, 9.4e8 products and
   two minutes of host planning, is left to the tool; no verdict); (c)
   ``eval_adaptive`` at n = 8192 (``--quick``) on the row sets banded,
   loc-powerlaw, nn-bert-ffn1-blk32 and the graded FEM, which cover every
   row type, the element side timed where dispatch picks it (the FEM must
   be dispatched there), each workload's densify pick and host seconds
   under the card's scorer and the parent's, and the ``spada+densify``
   rows of both picks (blk32 must time one); (d) ``bench_value_refresh``
   with 2 batches; (e) phase 4's two plans side by side: T, tm histogram,
   W, blocks and ``measure_device_perf``, and each densify scorer's pick
   and host seconds on nn at its T; (f) the resident blocks the card
   reports for every item shape (``tile_resident_blocks``), beside the
   record ``config._TILE_RESIDENT`` and ``_TILE_SMS``, the terms ``h100_config``
   carries (the per-T overheads, acc and fixed per tile dtype,
   ``element_fixed_s``),
   the thin points of phase 4c's ``tile_spgemm`` cases beside the recorded
   ones (``config._THIN_FIT``), and the graded FEM at 129 edges through
   ``eval_adaptive`` with both sides timed and the dispatch's OK / WRONG
   verdict (it must be dispatched to the element side); (g) the card's
   tile model (``plan/card_model.py``) and the parent's model beside the
   measured ms on cari (the CLI), phase 4's two nn plans, every tile row of
   (c) and phase 4c's ``tile_spgemm`` cases, with each model's median and
   largest |residual|; (h) cari through the CLI's ``run`` and ``plan
   --card``: both must print the same tile edge, densify and plan lines,
   and ``plan --card``'s panels must be the plan ``cli.plan_spada``
   makes.
11. the last two reference tools (``spada_tpu_torch.tools``): (a)
   ``probe_op`` at its size (banded 16384^2, band 384, T = 384, bf16 then
   f32 tiles): the op dataflow's k-major worklist on the plain scatter-add
   engine, on the card, against its two byte bounds and the row schedule
   on ``tile_spgemm`` (at least one launch), the two C within 1e-5 of
   max|C| and each against scipy on its first 2048 rows; (b)
   ``eval_scaling``: its functional gloo groups of D = 1, 2, 4, 8 ranks on
   the CPU at ``--quick`` size (every rank's C the same, ``allclose``
   against scipy on all of C), then every rank body of the halo and
   psum-merge partitions at full size (n = 8192·D) for D = 1, 2, 4 on this
   card (D = 8 is cut: with it the phase takes about 63 s, over its 60 s
   budget), bf16 tiles, each panel gated against scipy (1e-2), and the
   table beside the scaling model's columns.

Beside each kernel's time the script computes its bound, the larger of two
times on the datasheet placeholders of ``config.h100_config``: the useful
operations (the scalar products of the CSR pair, not the zeros inside a
tile) over the peak for the operand type (tile products: 165 TFLOP/s for
f32, a third of the 495 TFLOP/s TF32 rate, as 3xTF32 reaches f32-level
error on the tensor cores, and 989 TFLOP/s for bf16; the stream kernels'
f32 products 67 TFLOP/s outside the tensor cores), and the bytes it must
move (inputs read once, output written once) over 3.35 TB/s.  It also times one PyTorch call that computes the same
function: ``torch.matmul`` of the dense operands for the tile kernels
(cuBLAS; f32 with TF32 off for nn, bf16 in and f32 out for the probe's
banded pair), ``torch.bmm`` of the W gathered item pairs of the sweep's
f32 tm-64 case for the thin blocks, ``torch.mul`` and
``torch.linalg.vecdot`` for the stream kernels.

Every kernel wrapper counts its launches; the counts are cleared right
before each main-path run and read right after it.  The script prints one
JSON line with each kernel's numbers, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is not 0 and no result line is printed; so does a machine without a
CUDA device, and a run that loaded JAX or any module of ``spada_tpu`` (in
this process or in a rank of phase 9 (c)).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GATE_ROWS = 2048


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def relerr(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


@contextlib.contextmanager
def main_path(totals: dict):
    """Zero every launch count, run the block, add what it launched to
    ``totals``; yields the block's own counts."""
    from spada_tpu_torch import _build

    _build.launches.clear()
    counts: dict = {}
    yield counts
    counts.update(_build.launches)
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v


def time_pair(kernel_fn, plain_fn):
    """Device medians (s) of kernel and plain version, taken in the order
    plain, kernel, kernel, plain."""
    from spada_tpu_torch.utils.timing import cuda_time

    _, ps1 = cuda_time(plain_fn, warmup=1, reps=5)
    _, ks1 = cuda_time(kernel_fn, warmup=1, reps=5)
    _, ks2 = cuda_time(kernel_fn, warmup=0, reps=5)
    _, ps2 = cuda_time(plain_fn, warmup=0, reps=5)
    return float(np.median(ks1 + ks2)), float(np.median(ps1 + ps2))


def dense_of(m, dev, dtype):
    """The host CSR matrix ``m`` (``indptr``/``indices``/``data``) as a
    dense tensor on the device, built there."""
    import torch

    indptr = torch.from_numpy(np.asarray(m.indptr, np.int64)).to(dev)
    rows = torch.repeat_interleave(
        torch.arange(m.shape[0], device=dev), indptr.diff())
    cols = torch.from_numpy(np.asarray(m.indices, np.int64)).to(dev)
    d = torch.zeros(tuple(m.shape), dtype=dtype, device=dev)
    d[rows, cols] = torch.from_numpy(np.asarray(m.data, np.float32)).to(
        dev, dtype)
    return d


def library_time(fn, reps: int = 3) -> float:
    """Median device seconds of one call of ``fn`` after a warm-up, each
    output dropped before the next call (a dense product here takes tens
    of GB)."""
    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        del out
        samples.append(start.elapsed_time(end) * 1e-3)
    return float(np.median(samples))


#: the kernels that must run on tensor cores: the wide path of the four
#: main-path tile kernels and the probe's build of it (csrc/tile_mma.cuh),
#: and the thin path of the four (csrc/tile_mma_thin.cuh)
MMA_KERNELS = ("tile_spgemm_mma", "tile_spgemm_thin", "tile_stream_mma",
               "tile_stream_thin", "tile_panel_mma", "tile_panel_thin",
               "tile_grid_mma", "tile_grid_thin", "tile_probe_mma")


def check_tensor_cores() -> None:
    """Count the HMMA instructions of each tensor-core kernel in the built
    library; fail if one has none (it compiled back to FFMA) or if the
    toolkit has no cuobjdump to tell."""
    from spada_tpu_torch import _build

    counts = _build.sass_counts("HMMA")
    for kernel in MMA_KERNELS:
        found = {n: c for n, c in counts.items() if kernel in n}
        require(bool(found), f"no {kernel} kernel in the built library")
        for name, c in sorted(found.items()):
            log(f"  {c:5d} HMMA in {name}")
            require(c > 0, f"{name} has no HMMA instruction: it does not "
                    f"run on tensor cores")


# --------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# --------------------------------------------------------------------------

def check_kernels(dev, errs: dict) -> None:
    import torch

    from spada_tpu_torch.convert import tile_ptr_of
    from spada_tpu_torch.ops.element_stream import (esc_stream_mul,
                                                    esc_stream_mul_reference,
                                                    esc_stream_red,
                                                    esc_stream_red_reference)
    from spada_tpu_torch.ops.engine import (run_worklist_reference,
                                            tile_block, tile_spgemm)

    rng = np.random.default_rng(0)
    runs = np.array([3, 0, 1, 4, 2, 0])     # items per C tile; 0 = empty run
    n_c, w = len(runs), int(runs.sum())
    o_ids = np.repeat(np.arange(n_c), runs).astype(np.int32)
    empty = torch.from_numpy(runs == 0)
    for tk in (128, 512):
        for tm in (8, 16, 32, 64, 128, 512):
            for dtype in (torch.float32, torch.bfloat16):
                a = torch.from_numpy(rng.standard_normal(
                    (5, tm, tk), np.float32)).to(dev, dtype)
                b = torch.from_numpy(rng.standard_normal(
                    (4, tk, tk), np.float32)).to(dev, dtype)
                ai = torch.from_numpy(
                    rng.integers(0, 5, w).astype(np.int32)).to(dev)
                bi = torch.from_numpy(
                    rng.integers(0, 4, w).astype(np.int32)).to(dev)
                tp = torch.from_numpy(tile_ptr_of(o_ids, n_c)).to(dev)
                got = tile_spgemm(a, b, ai, bi, tp)
                ref = run_worklist_reference(
                    a, b, ai, bi, torch.from_numpy(o_ids).to(dev), n_c)
                torch.cuda.synchronize()
                g, r = got.cpu().numpy(), ref.cpu().numpy()
                err = relerr(g, r)
                block = tile_block(tm, tk, tk, dtype)
                log(f"  tile_spgemm tm={tm:3d} tk=tn={tk} "
                    f"{str(dtype)[6:]:8s} on {block:8s} "
                    f"max|d|/max|ref|={err:.2e}")
                require(err <= 1e-5, f"tile_spgemm tm={tm} tk={tk} {dtype}: "
                        f"relerr {err:.3e} > 1e-5")
                require(bool((got[empty.to(dev)] == 0).all()),
                        "tile_spgemm: an empty run gave a nonzero tile")
                key = ("tile_spgemm_thin" if block == "mma_thin"
                       else "tile_spgemm")
                errs[key] = max(errs[key], float(np.abs(g - r).max()))

    check_engine_kernels(dev, errs, rng)

    a = torch.from_numpy(rng.standard_normal((64, 1024), np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((64, 1024), np.float32)).to(dev)
    got, ref = esc_stream_mul(a, b), esc_stream_mul_reference(a, b)
    torch.cuda.synchronize()
    require(torch.equal(got, ref), "esc_stream_mul is not bitwise equal")
    errs["esc_stream_mul"] = float((got - ref).abs().max())
    log("  esc_stream_mul [64, 1024]: bitwise equal")
    for L in (2, 4, 8, 16, 32, 64, 128, 256, 512):
        a = torch.from_numpy(rng.standard_normal((L, 4096), np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal((L, 4096), np.float32)).to(dev)
        got, ref = esc_stream_red(a, b), esc_stream_red_reference(a, b)
        torch.cuda.synchronize()
        err = relerr(got.cpu().numpy(), ref.cpu().numpy())
        log(f"  esc_stream_red L={L:3d} [L, 4096]: max|d|/max|ref|={err:.2e}")
        require(err <= 1e-6, f"esc_stream_red L={L}: relerr {err:.3e} > 1e-6")
        errs["esc_stream_red"] = max(errs["esc_stream_red"],
                                     float((got - ref).abs().max()))
    check_grouped_launch(dev, errs, rng)


def check_grouped_launch(dev, errs: dict, rng) -> None:
    """esc_stream_group on plans of 1 to 10 classes (L = 1 and powers of two
    up to 512, class sizes from one float4 up): every class bitwise what its
    per-class kernel gives, within 1e-6 of max|out| of the plain version
    (L = 1 bitwise), and the same bits when run twice."""
    import torch

    from spada_tpu_torch.ops.element_stream import (esc_stream_group,
                                                    esc_stream_mul,
                                                    esc_stream_mul_reference,
                                                    esc_stream_red,
                                                    esc_stream_red_reference)

    all_Ls = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512]
    worst = 0.0
    for n_classes in (1, 2, 3, 5, 10):
        Ls = sorted(rng.choice(all_Ls, n_classes, replace=False).tolist())
        pairs = []
        for L in Ls:
            n = int(rng.choice([4, 132, 4096, 40000]))
            shape = (max(n // 1024, 1), 1024) if L == 1 else (L, n)
            pairs.append(tuple(torch.from_numpy(rng.standard_normal(
                shape, np.float32)).to(dev) for _ in "ab"))
        got, again = esc_stream_group(pairs, Ls), esc_stream_group(pairs, Ls)
        torch.cuda.synchronize()
        for L, (x, y), g, g2 in zip(Ls, pairs, got, again):
            one, plain = ((esc_stream_mul(x, y),
                           esc_stream_mul_reference(x, y)) if L == 1 else
                          (esc_stream_red(x, y),
                           esc_stream_red_reference(x, y)))
            require(torch.equal(g, one), f"esc_stream_group L={L}: not "
                    f"bitwise the per-class kernel's values")
            require(torch.equal(g, g2), f"esc_stream_group L={L}: two runs "
                    f"differ")
            e = float((g - plain).abs().max())
            rel = e / max(float(plain.abs().max()), 1e-30)
            require(rel <= (0.0 if L == 1 else 1e-6),
                    f"esc_stream_group L={L} {tuple(x.shape)}: {rel:.3e}")
            errs["esc_stream_group"] = max(errs["esc_stream_group"], e)
            worst = max(worst, rel)
    require(esc_stream_group([], []) == (), "esc_stream_group: no classes")
    log(f"  esc_stream_group, plans of 1-10 classes: bitwise the per-class "
        f"kernels, two runs equal, max|d|/max|plain| {worst:.2e}")


def bf16_ulp(x):
    """The spacing of bf16 numbers at each value of ``x`` (bf16 values in a
    float32 tensor); 0 where ``x`` is 0."""
    import torch

    e = torch.floor(torch.log2(x.abs().clamp_min(1e-38)))
    return torch.where(x == 0, torch.zeros_like(x), torch.exp2(e - 7))


def check_engine_kernels(dev, errs: dict, rng) -> None:
    """tile_stream, tile_panel and tile_grid against their plain versions
    on random worklists with empty runs, and for ogroup 8 a whole group
    with no items (C tiles 8-15) and a last group of two C tiles.  On the
    tensor-core blocks (tn = tk), tile_stream at ogroup 1 and tile_panel's
    f32 output bit for bit tile_spgemm's C, the thin shapes of all four
    kernels (tile_grid's among them) launched on the thin block; at tn = 64
    tile_spgemm, tile_stream, tile_panel and tile_grid on their narrow SIMT
    blocks (tm 8, 16 and 64), tile_spgemm against the plain version.  The
    kernels report their block, and the wrappers raise where it is not
    tile_block's."""
    import torch

    from spada_tpu_torch import _build
    from spada_tpu_torch.convert import item_ptr_of, tile_ptr_of
    from spada_tpu_torch.ops import engine as E

    runs = np.array([3, 0, 1, 4, 2, 0, 0, 0] + [0] * 8 + [2, 1])
    n_c, w = len(runs), int(runs.sum())
    o_np = np.repeat(np.arange(n_c), runs).astype(np.int32)
    empty = torch.from_numpy(runs == 0).to(dev)

    def ids(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

    o, tp = ids(o_np), ids(tile_ptr_of(o_np, n_c))
    shapes = [(tm, tk, tk) for tk in (128, 512)
              for tm in (8, 32, 64, 128, 512)]
    shapes += [(tm, 128, 64) for tm in (8, 16, 64)]
    for tm, tk, tn in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            a = torch.from_numpy(rng.standard_normal(
                (5, tm, tk), np.float32)).to(dev, dtype)
            b = torch.from_numpy(rng.standard_normal(
                (4, tk, tn), np.float32)).to(dev, dtype)
            ai, bi = ids(rng.integers(0, 5, w)), ids(rng.integers(0, 4, w))
            a_t = a.transpose(1, 2).contiguous()
            before = _build.launches.copy()
            cases = []
            for og in (1, 8):
                args = (a, b, ai, bi, o, ids(item_ptr_of(o_np, n_c, og)),
                        n_c, og)
                cases.append((f"tile_stream og={og}", "tile_stream",
                              E.tile_stream(*args),
                              E.tile_stream_reference(*args)))
            args = (a_t, b, ai, bi, tp, torch.float32)
            cases.append(("tile_panel", "tile_panel", E.tile_panel(*args),
                          E.tile_panel_reference(*args)))
            args = (a, b, ai, bi, o, n_c)
            cases.append(("tile_grid", "tile_grid", E.tile_grid(*args),
                          E.tile_grid_reference(*args)))
            args = (a_t, b, ai, bi, tp, torch.bfloat16)
            p16 = E.tile_panel(*args)
            r16 = E.tile_panel_reference(*args).float()
            torch.cuda.synchronize()
            require(torch.equal(p16, cases[-2][2].to(torch.bfloat16)),
                    "tile_panel: the bf16 output is not its f32 output "
                    "rounded once")
            spg = E.tile_spgemm(a, b, ai, bi, tp)
            block = E.tile_block(tm, tk, tn, dtype, "tile_stream")
            require(all(E.tile_block(tm, tk, tn, dtype, k) == block
                        for k in ("tile_spgemm", "tile_panel", "tile_grid")),
                    f"tm={tm} tk={tk} tn={tn}: tile_spgemm, tile_stream, "
                    f"tile_panel and tile_grid on different blocks")
            if block == "narrow_simt":
                # tile_stream og=1's plain version is tile_spgemm's
                cases.append(("tile_spgemm", "tile_spgemm", spg,
                              cases[0][3]))
            else:
                for k in (0, 2):  # tile_stream og=1, tile_panel f32
                    require(torch.equal(cases[k][2], spg),
                            f"{cases[k][0]} tm={tm} tk={tk} {dtype}: "
                            f"not tile_spgemm's C bit for bit")
            ran = _build.launches - before
            for name, n in (("tile_stream", 2), ("tile_panel", 2),
                            ("tile_spgemm", 1), ("tile_grid", 1)):
                want = n if block == "mma_thin" else 0
                require(ran[name] == n and ran[name + "_thin"] == want,
                        f"{name} tm={tm} tk={tk} tn={tn} {dtype}: "
                        f"launches {dict(ran)}, {want} on the thin "
                        f"block expected")
            p16 = p16.float()
            line = []
            for label, name, got, ref in cases:
                err = relerr(got.cpu().numpy(), ref.cpu().numpy())
                line.append(f"{label} {err:.1e}")
                require(err <= 1e-5, f"{label} tm={tm} tk={tk} tn={tn} "
                        f"{dtype}: relerr {err:.3e} > 1e-5")
                require(bool((got[empty] == 0).all()),
                        f"{label}: an empty run gave a nonzero tile")
                errs[name] = max(errs[name],
                                 float((got - ref).abs().max()))
            # one bf16 ulp, plus the f32 bar: the two f32 sums differ
            # in order, and near a cancellation a bf16 ulp is smaller
            # than their gap
            gap = (p16 - r16).abs()
            bar = bf16_ulp(r16) + 1e-5 * float(r16.abs().max())
            ulps = float((gap / bf16_ulp(r16).clamp_min(1e-38)).max())
            require(bool((gap <= bar).all()),
                    f"tile_panel bf16 out tm={tm} tk={tk} tn={tn} "
                    f"{dtype}: "
                    f"{float((gap / bar).max()):.2f} x the bar")
            require(bool((p16[empty] == 0).all()),
                    "tile_panel bf16 out: an empty run gave a nonzero "
                    "tile")
            bits = ("" if block == "narrow_simt" else
                    "tile_stream og=1 and tile_panel f32 tile_spgemm's "
                    "bits; ")
            log(f"  tm={tm:3d} tk={tk} tn={tn} {str(dtype)[6:]:8s} on "
                f"{block}: max|d|/max|ref|: {', '.join(line)}; {bits}"
                f"tile_panel bf16 "
                f"out: max {ulps:.2f} ulp of the plain value, "
                f"{int((gap > bf16_ulp(r16)).sum())} values over 1 ulp")


# --------------------------------------------------------------------------
# phase 3: cari through the CLI
# --------------------------------------------------------------------------

#: the kernel each --engine override runs
ENGINE_KERNEL = {"streaming": "tile_stream", "panel": "tile_panel",
                 "pallas_grid": "tile_grid"}


def run_cari(dev, totals: dict, engine=None,
             scheme: str = "analytic") -> None:
    import scipy.io

    from spada_tpu_torch import cli

    argv = ["run", "spada", "SS", "cari", "config/default.json",
            "--device", str(dev), "--no-result", "--plan-scheme", scheme]
    if engine:
        argv += ["--engine", engine]
    kernel = ENGINE_KERNEL.get(engine, "tile_spgemm")
    out = io.StringIO()
    with main_path(totals) as counts, contextlib.redirect_stdout(out):
        c = cli.execute(argv)
    sys.stdout.write(out.getvalue())
    check_device_perf_line(out.getvalue(), f"cari, engine {engine or 'auto'}"
                           f", plan {scheme}")
    a = scipy.io.mmread(os.path.join(ROOT, "matrices", "cari.mtx")).tocsr()
    b = a if a.shape[0] == a.shape[1] else a.T.tocsr()
    ref = (a @ b).toarray()
    ok = np.allclose(c.todense(), ref, rtol=1e-4, atol=1e-3)
    log(f"  engine {engine or 'auto'}, plan {scheme}: launches {counts}; C "
        f"vs scipy: allclose(rtol=1e-4, atol=1e-3) = {ok}, max|d|/max|ref| "
        f"= {relerr(c.todense(), ref):.2e}")
    require(ok, f"cari under engine {engine} differs from scipy")
    require(counts.get(kernel, 0) > 0, f"cari did not launch {kernel}")
    require(engine is None or counts.get("tile_spgemm", 0) == 0,
            f"cari under --engine {engine} launched tile_spgemm")
    require(engine is None or counts.get(f"{kernel}_thin", 0) > 0,
            f"cari under --engine {engine} did not launch the thin block")
    if engine == "pallas_grid":
        log("  " + grid_chunk_line(out.getvalue(), dev))


def grid_chunk_line(text: str, dev) -> str:
    """cari's pallas_grid engine time beside the G that ops.engine's rule
    gives tile_grid's thin path for the run's worklist (its items, tile
    edge and panel height, as the CLI printed them)."""
    from spada_tpu_torch.ops import engine as E

    ms = re.search(r"device perf: engine ([0-9.]+) ms", text).group(1)
    items = int(re.search(r"work items: (\d+)", text).group(1))
    t = int(re.search(r"tile size: (\d+)", text).group(1))
    tms = [int(x) for x in re.findall(
        r"(\d+):", re.search(r"tm histogram \{([^}]*)\}", text).group(1))]
    require(len(tms) == 1, f"cari's plan has panels of tm {tms}, not one")
    g = E.grid_chunk(items, E.thin_pieces(tms[0], t), E.sm_count(dev))
    return (f"pallas_grid on cari: engine {ms} ms, {items} items of tm "
            f"{tms[0]} at T = {t}, {E.sm_count(dev)} SMs: G = {g} item(s) "
            f"per block of tile_grid's thin path")


def check_device_perf_line(text: str, label: str) -> None:
    """The CLI printed one device report, its shares of a peak <= 100%."""
    lines = [ln for ln in text.splitlines()
             if ln.startswith("device perf: engine ")]
    require(len(lines) == 1, f"{label}: no 'device perf: engine' line")
    shares = [float(x) for x in re.findall(
        r"([0-9.]+)% (?:tensor-core peak|of HBM SoL)", lines[0])]
    require(len(shares) == 2 and all(0 <= x <= 100 for x in shares),
            f"{label}: shares {shares} in {lines[0]!r}")


def run_cari_plans(dev, totals: dict) -> None:
    """The CLI's plan mode on cari under both schemes; the profiled one
    times tile_spgemm on the card."""
    from spada_tpu_torch import cli

    for scheme in ("analytic", "profiled"):
        with main_path(totals) as counts:
            rc = cli.main(["plan", "spada", "SS", "cari",
                           "config/default.json", "--device", str(dev),
                           "--plan-scheme", scheme])
        log(f"  plan {scheme}: exit {rc}, launches {counts}")
        require(rc == 0, f"plan --plan-scheme {scheme} exited {rc}")
        require(scheme == "analytic" or counts.get("tile_spgemm", 0) > 0,
                "the profiled plan did not launch tile_spgemm")


# --------------------------------------------------------------------------
# phase 4: the tile side at the bench's size
# --------------------------------------------------------------------------

#: phase 4's two plans of the nn pair: under the card's fit (``h100_config``,
#: the main path's config) and under the reference's per-item terms, whose T =
#: 512 plan holds the tensor-core block at full width whatever the fit picks
NN_PLANS = ("fit", "v5e terms")


def plan_blocks(run) -> str:
    """The block tile_spgemm runs each tm of ``run``'s plan on."""
    from spada_tpu_torch.ops.engine import tile_block

    tk, tn = run.result.host_state["tk"], run.result.host_state["tn"]
    return ", ".join(sorted({
        f"tm {tm}: {tile_block(tm, tk, tn, a_np.dtype)}"
        for _, a_np, _, tm in run.result.host_state["segments"]}))


def nn_segments(dev, run, kind, errs: dict, label: str) -> tuple:
    """Phase 4's tile_spgemm against its plain version on every segment of
    ``run``'s plan, each timed beside it.  Returns (kernel s, plain s,
    [(bound s, by)])."""
    import torch

    from spada_tpu_torch.config import roofline_bound, tile_work
    from spada_tpu_torch.convert import worklist_to_torch
    from spada_tpu_torch.ops.engine import (run_worklist_reference,
                                            tile_block, tile_spgemm)

    t_kernel = t_plain = 0.0
    bounds = []
    a_sp, b_sp = run.a.to_scipy(), run.b.to_scipy()
    tk, tn = run.result.host_state["tk"], run.result.host_state["tn"]
    for wl, a_np, b_np, tm in run.result.host_state["segments"]:
        a_t = torch.from_numpy(a_np).to(dev)
        b_t = torch.from_numpy(b_np).to(dev)
        dwl = worklist_to_torch(wl, dev)

        def kernel():
            return tile_spgemm(a_t, b_t, dwl.a_tid, dwl.b_tid, dwl.tile_ptr)

        def plain():
            return run_worklist_reference(a_t, b_t, dwl.a_tid, dwl.b_tid,
                                          dwl.o_tid, dwl.n_c_tiles)

        g, r = kernel(), plain()
        e = relerr(g.cpu().numpy(), r.cpu().numpy())
        require(e <= 1e-5, f"nn [{label}] segment tm={tm}: kernel vs plain "
                f"{e:.3e}")
        errs["tile_spgemm"] = max(errs["tile_spgemm"],
                                  float((g - r).abs().max()))
        del g, r
        tk_s, tp_s = time_pair(kernel, plain)
        tile_flops = 2 * wl.n_items * tm * tk * tn
        seg_rows = np.concatenate([np.arange(p.row_start, p.row_end)
                                   for p in run.plan.panels if p.tm == tm])
        flops, nbytes = tile_work(a_np, b_np, wl.n_items, wl.n_c_tiles,
                                  a_sp[seg_rows], b_sp)
        b_s, by = roofline_bound(flops, nbytes, kind, a_np.dtype,
                                 matmul=True)
        bounds.append((b_s, by))
        log(f"  [{label}] segment tm={tm} tk=tn={tk} on the "
            f"{tile_block(tm, tk, tn, a_np.dtype)} block: W={wl.n_items} "
            f"nC={wl.n_c_tiles}, {flops / 1e9:.1f} GFLOP of products in "
            f"{tile_flops / 1e9:.1f} of whole tiles, {nbytes / 1e9:.3f} GB"
            f"  kernel {tk_s * 1e3:.3f} ms ({tile_flops / tk_s / 1e12:.2f} "
            f"tile TFLOP/s)  plain {tp_s * 1e3:.3f} ms "
            f"({tile_flops / tp_s / 1e12:.2f})  bound {b_s * 1e3:.3f} ms "
            f"({by})  kernel vs plain max|d|/max|ref| {e:.2e}")
        t_kernel += tk_s
        t_plain += tp_s
        del a_t, b_t, dwl
    return t_kernel, t_plain, bounds


def run_nn(dev, kind: str, totals: dict, errs: dict, times: dict,
           extra: dict, m: int = 16384, n: int = 4096):
    """Phase 4: the nn pair through run_spada under each of NN_PLANS' terms,
    each gated against scipy, every segment's tile_spgemm held to its plain
    version and timed, measure_device_perf against those times.  The fit's
    run is the main path (``times`` and ``extra["nn"]``); the other plan's
    times go to ``extra["nn_plans"]``.  Returns ({label: run}, the fit run's
    dense C, the f64 reference of C's first rows), for phases 6, 9 and 10."""
    import torch

    from spada_tpu_torch.cli import run_spada
    from spada_tpu_torch.config import h100_config
    from spada_tpu_torch.io.workloads import (block_sparse_csr,
                                              relu_activation_csr)
    from spada_tpu_torch.ops.spgemm import measure_device_perf
    from spada_tpu_torch.tools.harness import reference_item_terms

    t0 = time.perf_counter()
    a = block_sparse_csr(m, m, 384, 0.2, seed=5, dtype=np.float32)
    b = relu_activation_csr(m, n, 0.35, seed=6, dtype=np.float32)
    log(f"  A {a.shape} nnz {a.nnz}, B {b.shape} nnz {b.nnz} "
        f"(generated in {time.perf_counter() - t0:.1f} s)")
    rows = min(GATE_ROWS, m)
    ref = (a.to_scipy()[:rows].toarray().astype(np.float64)
           @ b.to_scipy().toarray().astype(np.float64))
    cfgs = {"fit": h100_config(kind),
            "v5e terms": h100_config(kind, **reference_item_terms())}
    runs = {}
    extra["nn_plans"] = {}
    for label in NN_PLANS:
        t0 = time.perf_counter()
        with main_path(totals) as counts:
            run = run_spada(a, b, cfgs[label], dev,
                            log=lambda s: log("  " + s))
        runs[label] = run
        log(f"  [{label}] run_spada: {time.perf_counter() - t0:.1f} s "
            f"host+device, engine {run.choice}, launches {counts}")
        require(run.choice == "tile",
                f"nn [{label}] dispatched to {run.choice}, not tile")
        require(counts.get("tile_spgemm", 0) > 0,
                f"nn [{label}] did not launch tile_spgemm")
        log(f"  [{label}] plan: T={run.config.tile_k}, tm histogram "
            f"{run.plan.tm_histogram()}, W={run.result.n_work_items}; "
            f"blocks: {plan_blocks(run)}")
        err = relerr(run.result.todense()[:rows], ref)
        log(f"  [{label}] gate vs scipy/numpy f64, rows [0, {rows}): "
            f"max|d|/max|ref| = {err:.2e} (limit 1e-4)")
        require(err < 1e-4, f"nn [{label}] gate failed: relerr {err:.3e}")
        t_kernel, t_plain, bounds = nn_segments(dev, run, kind, errs, label)
        perf = measure_device_perf(run.a, run.b, run.config, "spada",
                                   plan=run.plan,
                                   host_state=run.result.host_state,
                                   device=dev)
        gap = abs(perf["engine_s"] - t_kernel) / t_kernel
        log(f"  [{label}] measure_device_perf: engine "
            f"{perf['engine_s'] * 1e3:.3f} ms (the segments' tile_spgemm "
            f"times sum to {t_kernel * 1e3:.3f} ms, {gap:.1%} apart), "
            f"{perf['flops_per_s'] / 1e12:.2f} TFLOP/s of whole tiles, "
            f"{perf['mxu_util_pct']:.1f}% of the tensor-core peak, "
            f"{perf['pct_hbm_sol']:.1f}% of HBM SoL ({perf['hbm_gbps']:.0f} "
            f"GB/s modelled), on {smi_name_power()}")
        require(gap <= 0.10, f"nn [{label}]: measure_device_perf {gap:.1%} "
                f"from the kernel times")
        require(perf["mxu_util_pct"] <= 100 and perf["pct_hbm_sol"] <= 100,
                f"nn [{label}]: a share over 100%: {perf}")
        # the bound is the sum of the segments', bound by what bounds the
        # larger
        bound = (sum(s for s, _ in bounds), max(bounds)[1])
        extra["nn_plans"][label] = {
            "perf_ms": perf["engine_s"] * 1e3, "bound": bound,
            "blocks": plan_blocks(run),
            "times": {"tile_spgemm": (t_kernel, t_plain)}}
        if label == NN_PLANS[0]:
            times["tile_spgemm"] = (t_kernel, t_plain)
            extra["nn"] = {"bound": bound}
    blocks = " ".join(p["blocks"] for p in extra["nn_plans"].values())
    require("mma" in blocks, f"no nn plan ran the tensor-core block: {blocks}")
    c = runs[NN_PLANS[0]].result.todense()
    # one dense product computes the same C: cuBLAS SGEMM (TF32 off)
    da, db = dense_of(a, dev, torch.float32), dense_of(b, dev, torch.float32)
    t_lib = library_time(lambda: torch.matmul(da, db))
    e_lib = relerr(torch.matmul(da, db).cpu().numpy(), c)
    log(f"  library call torch.matmul on the dense f32 pair (cuBLAS, TF32 "
        f"off): {t_lib * 1e3:.3f} ms; its C vs the run's max|d|/max|ref| "
        f"{e_lib:.2e}")
    require(e_lib < 1e-4, f"nn: the dense product differs from the run's C "
            f"by {e_lib:.3e}")
    del da, db
    # the four tile kernels compute this same C from these same inputs
    extra["nn"]["library"] = (t_lib, "torch.matmul, dense f32")
    torch.cuda.empty_cache()
    return runs, c, ref


def run_spgemm_csr(dev, run, ref_rows, totals: dict,
                   budget: int = 64 << 20) -> None:
    """spgemm_csr on the nn pair in output slabs of ``budget`` bytes of C
    tiles, each slab a tile_spgemm launch, gated against scipy/numpy f64;
    its peak device memory beside a one-shot spgemm of the same worklist."""
    import torch

    from spada_tpu_torch.ops.spgemm import spgemm, spgemm_csr

    cfg = dataclasses.replace(run.config, dense_c_budget=budget)
    tm = cfg.default_tm
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    one = spgemm(run.a, run.b, cfg, dataflow="rowwise", tm=tm, device=dev)
    torch.cuda.synchronize(dev)
    peak_one = torch.cuda.max_memory_allocated(dev) - base
    n_c = int(one.c_tiles.shape[0])
    del one
    torch.cuda.empty_cache()
    slab_tiles = budget // (tm * cfg.tile_n * 4)
    n_slabs = -(-n_c // slab_tiles)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with main_path(totals) as counts:
        csr = spgemm_csr(run.a, run.b, cfg, dataflow="rowwise", tm=tm,
                         device=dev)
    dt = time.perf_counter() - t0
    peak_slab = torch.cuda.max_memory_allocated(dev) - base
    rows = ref_rows.shape[0]
    err = relerr(csr.to_scipy()[:rows].toarray(), ref_rows)
    log(f"  spgemm_csr, tm={tm}, budget {budget >> 20} MB: {n_c} C tiles in "
        f"{n_slabs} slabs of {slab_tiles}, nnz(C) {csr.nnz}, {dt:.1f} s "
        f"host+device, launches {counts}; peak device memory "
        f"{peak_slab / 2**20:.0f} MiB against {peak_one / 2**20:.0f} MiB one "
        f"shot; gate vs scipy/numpy f64, rows [0, {rows}): max|d|/max|ref| = "
        f"{err:.2e} (limit 1e-4)")
    require(n_slabs >= 4, f"spgemm_csr ran {n_slabs} slabs, not 4 or more")
    require(counts == {"tile_spgemm": n_slabs},
            f"spgemm_csr: {n_slabs} slabs, launches {counts}")
    require(err < 1e-4, f"spgemm_csr gate failed: relerr {err:.3e}")
    del csr
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 4c: the thin-panel sweep
# --------------------------------------------------------------------------

#: the phase 4c case whose numbers the kernels line gives for the thin
#: blocks: cari's panel height (T = 128, tm 64) and the main path's tile
#: dtype
THIN_LINE_CASE = ("float32", 64)
#: the kernels line's thin rows: kernel -> the sweep case it reads
THIN_LINE_ROWS = {"tile_spgemm_thin": "tile_spgemm",
                  "tile_stream_thin": "tile_stream og=1",
                  "tile_panel_thin": "tile_panel",
                  "tile_grid_thin": "tile_grid"}


def run_thin_sweep(dev, totals: dict, errs: dict, times: dict,
                   extra: dict) -> None:
    """tools/sweep_thin on the banded 32768^2 pair at T = 128, every tile
    kernel on each (dtype, tm)'s operands: one launch per case, each gated
    and timed; every tm below 128 on the thin block, tm 128 on the wide
    one."""
    from spada_tpu_torch.tools import sweep_thin

    def say(text):
        for line in text.splitlines():
            log("  " + line)

    t0 = time.perf_counter()
    ab = sweep_thin.banded_pair(32768)
    with main_path(totals) as counts:
        rows = sweep_thin.run(n=32768, device=dev, gate_rows=GATE_ROWS,
                              lib_whole=(THIN_LINE_CASE,),
                              engines=sweep_thin.ENGINES, ab=ab, log=say)
    # phase 10 (f) reads the tile_spgemm cases' item overheads
    extra["thin_sweep"] = (rows, ab)
    require(all(r["block"] == ("mma_thin" if r["tm"] < 128 else "mma")
                for r in rows),
            f"phase 4c: blocks "
            f"{[(r['engine'], r['tm'], r['block']) for r in rows]}")
    want = {}
    for r in rows:
        want[r["kernel"]] = want.get(r["kernel"], 0) + 1
        if r["block"] == "mma_thin":
            key = r["kernel"] + "_thin"
            want[key] = want.get(key, 0) + 1
    require(counts == want, f"phase 4c: launches {counts}, one per case "
            f"expected: {want}")
    require(all(r["same_bits"] for r in rows
                if r["engine"] in sweep_thin.BITWISE),
            "phase 4c: a case is not tile_spgemm's C bit for bit")
    for name, engine in THIN_LINE_ROWS.items():
        thin = [r for r in rows
                if r["engine"] == engine and r["block"] == "mma_thin"]
        errs[name] = max(errs[name], max(r["plain_abs_err"] for r in thin))
        r = next(r for r in thin if (r["dtype"], r["tm"]) == THIN_LINE_CASE)
        times[name] = (r["ms"] * 1e-3, r["plain_ms"] * 1e-3)
        extra[name] = {"bound": (r["bound_ms"] * 1e-3, r["bound_by"]),
                       "library": (r["lib_ms"] * 1e-3, "torch.bmm of the W "
                                   "gathered item pairs")}
    log(f"  phase 4c: launches {counts}, {time.perf_counter() - t0:.1f} s, "
        f"on {smi_name_power()}")


# --------------------------------------------------------------------------
# phase 5: the element side at the bench's size
# --------------------------------------------------------------------------

def run_locpl(dev, cfg, totals: dict, errs: dict, times: dict, extra: dict,
              m: int = 65536, deg: float = 32.0) -> None:
    import torch

    from spada_tpu_torch.cli import run_spada
    from spada_tpu_torch.config import roofline_bound, stream_work
    from spada_tpu_torch.convert import stream_operands_to_torch
    from spada_tpu_torch.ops.element_stream import (esc_stream_group,
                                                    esc_stream_mul,
                                                    esc_stream_mul_reference,
                                                    esc_stream_red,
                                                    esc_stream_red_reference,
                                                    stream_execute_reference,
                                                    stream_operands)
    from spada_tpu_torch.io.workloads import localized_powerlaw_csr
    from spada_tpu_torch.ops.spgemm import measure_device_perf
    from spada_tpu_torch.tools.harness import enqueue_s
    from spada_tpu_torch.tools.probe_pallas_stream import block_shape_sweep
    from spada_tpu_torch.utils.timing import cuda_time

    t0 = time.perf_counter()
    a = localized_powerlaw_csr(m, m, deg, seed=1, dtype=np.float32)
    b = localized_powerlaw_csr(m, m, deg, seed=2, dtype=np.float32)
    log(f"  A {a.shape} nnz {a.nnz}, B nnz {b.nnz} "
        f"(generated in {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    with main_path(totals) as counts:
        run = run_spada(a, b, cfg, dev, log=lambda s: log("  " + s))
    log(f"  run_spada: {time.perf_counter() - t0:.1f} s host+device, "
        f"engine {run.choice}, launches {counts}")
    require(run.choice == "element",
            f"locpl dispatched to {run.choice}, not element")
    # spgemm_element runs the multiply twice (warm, then timed)
    require(counts.get("esc_stream_group", 0) == 2,
            f"locpl did not make one grouped launch per multiply: {counts}")
    require(not counts.get("esc_stream_mul") and not
            counts.get("esc_stream_red"),
            f"locpl launched a per-class stream kernel: {counts}")

    er = run.result.element
    rows = min(GATE_ROWS, m)
    got = er.to_csr().to_scipy()[:rows]
    ref = (a.to_scipy()[:rows] @ b.to_scipy()).tocsr()
    err = float(abs(got - ref).max() / max(abs(ref).max(), 1e-30))
    log(f"  plan: E={er.plan.n_products} products, {len(er.layout.classes)} "
        f"classes, {er.layout.operand_bytes() / 1e9:.3f} GB streamed; gate "
        f"vs scipy rows [0, {rows}): max|d|/max|ref| = {err:.2e} "
        f"(limit 1e-3)")
    require(err < 1e-3, f"locpl gate failed: relerr {err:.3e}")

    layout = er.layout
    kind = torch.cuda.get_device_name(dev)
    ops = stream_operands_to_torch(stream_operands(layout, er.plan, a, b), dev)
    Ls = [c["L"] for c in layout.classes]
    ones = [i for i, L in enumerate(Ls) if L == 1]
    reds = [i for i, L in enumerate(Ls) if L > 1]
    grouped = esc_stream_group(ops, Ls)
    for name, idx, kern, plain_fn, library, lib_name in (
            ("esc_stream_mul", ones, esc_stream_mul, esc_stream_mul_reference,
             torch.mul, "torch.mul"),
            ("esc_stream_red", reds, esc_stream_red, esc_stream_red_reference,
             lambda x, y: torch.linalg.vecdot(x, y, dim=0),
             "torch.linalg.vecdot(dim=0) per class")):
        for i in idx:
            g, r = kern(*ops[i]), plain_fn(*ops[i])
            e = float((g - r).abs().max())
            rel = e / max(float(r.abs().max()), 1e-30)
            require(rel <= (0.0 if name == "esc_stream_mul" else 1e-6),
                    f"{name} class L={Ls[i]}: {rel:.3e}")
            require(torch.equal(grouped[i], g), f"esc_stream_group class "
                    f"L={Ls[i]}: not bitwise {name}'s values")
            errs[name] = max(errs[name], e)
            errs["esc_stream_group"] = max(errs["esc_stream_group"], e)
        work = [stream_work(Ls[i], layout.classes[i]["n_pad"]) for i in idx]
        flops, nbytes = (sum(w[j] for w in work) for j in (0, 1))

        def kernel_all():
            return [kern(*ops[i]) for i in idx]

        def plain_all():
            return [plain_fn(*ops[i]) for i in idx]

        def library_all():
            return [library(*ops[i]) for i in idx]

        t_k, t_p = time_pair(kernel_all, plain_all)
        t_l, _ = cuda_time(library_all, warmup=1, reps=10)
        h_k = enqueue_s(kernel_all, dev) / len(idx)
        h_p = enqueue_s(plain_all, dev) / len(idx)
        b_s, by = roofline_bound(flops, nbytes, kind)
        log(f"  {name}: {len(idx)} classes, {nbytes / 1e9:.3f} GB  kernel "
            f"{t_k * 1e3:.3f} ms ({nbytes / t_k / 1e9:.0f} GB/s)  plain "
            f"{t_p * 1e3:.3f} ms ({nbytes / t_p / 1e9:.0f} GB/s)  library "
            f"{lib_name} {t_l * 1e3:.3f} ms  bound {b_s * 1e3:.3f} ms ({by})"
            f"  host enqueue per class: kernel {h_k * 1e6:.1f} us, plain "
            f"{h_p * 1e6:.1f} us")
        times[name] = (t_k, t_p)
        extra[name] = {"bound": (b_s, by), "library": (t_l, lib_name)}
    log("  every class: per-class wrapper and grouped launch bitwise equal; "
        "against the plain versions mul bitwise, red <= 1e-6")

    # the whole multiply: one grouped launch against the per-class launches,
    # the plain versions and one library call per class
    def group_call():
        return esc_stream_group(ops, Ls)

    def per_class_call():
        return [esc_stream_mul(*ops[i]) if Ls[i] == 1
                else esc_stream_red(*ops[i]) for i in range(len(Ls))]

    def plain_call():
        return stream_execute_reference(layout, ops)

    def library_call():
        return [torch.mul(*ops[i]) if Ls[i] == 1
                else torch.linalg.vecdot(*ops[i], dim=0)
                for i in range(len(Ls))]

    t_g, t_pc = time_pair(group_call, per_class_call)
    t_pl, _ = cuda_time(plain_call, warmup=1, reps=10)
    t_lib, _ = cuda_time(library_call, warmup=1, reps=10)
    work = [stream_work(L, c["n_pad"]) for L, c in zip(Ls, layout.classes)]
    flops, nbytes = (sum(w[j] for w in work) for j in (0, 1))
    b_s, by = roofline_bound(flops, nbytes, kind)
    host = {k: enqueue_s(f, dev) for k, f in (
        ("grouped", group_call), ("per class", per_class_call),
        ("plain", plain_call))}
    log(f"  one multiply, {len(Ls)} classes, {nbytes / 1e9:.3f} GB: grouped "
        f"launch {t_g * 1e3:.3f} ms ({nbytes / t_g / 1e9:.0f} GB/s, "
        f"{b_s / t_g:.1%} of the bound), per-class launches "
        f"{t_pc * 1e3:.3f} ms, plain {t_pl * 1e3:.3f} ms, library torch.mul +"
        f" vecdot per class {t_lib * 1e3:.3f} ms, bound {b_s * 1e3:.3f} ms "
        f"({by}); host enqueue per multiply: "
        + ", ".join(f"{k} {v * 1e6:.0f} us" for k, v in host.items()))
    times["esc_stream_group"] = (t_g, t_pl)
    perf = measure_device_perf(run.a, run.b, run.config, "element",
                               device=dev)
    gap = abs(perf["engine_s"] - t_g) / t_g
    log(f"  measure_device_perf: engine {perf['engine_s'] * 1e3:.3f} ms "
        f"(the grouped launch {t_g * 1e3:.3f} ms, {gap:.1%} apart), "
        f"{perf['pct_hbm_sol']:.1f}% of HBM SoL ({perf['hbm_gbps']:.0f} GB/s"
        f" modelled), on {smi_name_power()}")
    require(gap <= 0.10, f"locpl: measure_device_perf {gap:.1%} from the "
            f"grouped launch")
    require(perf["mxu_util_pct"] is None and perf["pct_hbm_sol"] <= 100,
            f"locpl: {perf}")
    extra["esc_stream_group"] = {
        "bound": (b_s, by),
        "library": (t_lib, "torch.mul + torch.linalg.vecdot per class")}
    log("  block shapes of esc_stream_red and class orders of the grouped "
        "launch (device ms):")
    block_shape_sweep(ops, Ls, log=lambda s: log("  " + s))
    del ops, grouped
    torch.cuda.empty_cache()
    run_element_backends(dev, totals, deg)


def run_element_backends(dev, totals: dict, deg: float,
                         m: int = 8192) -> None:
    """``spgemm_element`` on a cut of the locpl pair: the fused elementwise
    backend, and row slabs under both backends, against scipy (f32 sums in
    another order: 1e-5 of max|C|)."""
    from spada_tpu_torch.io.workloads import localized_powerlaw_csr
    from spada_tpu_torch.ops.element import (EscResult, EscSlabbedResult,
                                             expansion_products,
                                             spgemm_element)
    from spada_tpu_torch.ops.element_stream import StreamResult

    a = localized_powerlaw_csr(m, m, deg, seed=1, dtype=np.float32)
    b = localized_powerlaw_csr(m, m, deg, seed=2, dtype=np.float32)
    ref = (a.to_scipy() @ b.to_scipy()).tocsr()
    budget = expansion_products(a, b) // 4

    def gate(label, res):
        err = float(abs(res.to_csr().to_scipy() - ref).max()
                    / max(abs(ref).max(), 1e-30))
        require(err <= 1e-5, f"spgemm_element {label}: {err:.3e} vs scipy")
        return err

    with main_path(totals) as counts:
        res = spgemm_element(a, b, dev, backend="xla")
        require(isinstance(res, EscResult), "backend='xla' did not return "
                "an EscResult")
        e_x = gate("backend='xla'", res)
        require(not _launches_now(),
                f"backend='xla' launched a hand kernel: {_launches_now()}")
        parts = {}
        for backend, kind in (("xla", EscResult), ("auto", StreamResult)):
            res = spgemm_element(a, b, dev, max_slab_products=budget,
                                 backend=backend)
            require(isinstance(res, EscSlabbedResult) and len(res.parts) >= 4
                    and all(isinstance(p, kind) for p in res.parts),
                    f"row slabs under backend {backend!r}: {type(res)}")
            parts[backend] = (len(res.parts), gate(f"slabs, {backend}", res))
    require(counts.get("esc_stream_group", 0) == 2 * parts["auto"][0]
            and set(counts) == {"esc_stream_group"},
            f"row slabs under 'auto': launches {counts}")
    log(f"  spgemm_element on a {m}^2 cut: backend='xla' {e_x:.2e} of "
        f"max|C| from scipy; over a budget of {budget} products "
        + ", ".join(f"{k}: {n} slabs, {e:.2e}" for k, (n, e) in parts.items())
        + f"; launches {counts}")


def _launches_now() -> dict:
    from spada_tpu_torch import _build

    return dict(_build.launches)


# --------------------------------------------------------------------------
# phase 6: the engine override at full width
# --------------------------------------------------------------------------

def engine_pair(engine: str, a_t, b_t, wl, dev, ogroup=None):
    """(kernel, plain) calls for one segment, with the arguments the
    engine's run_worklist_* passes its wrapper (its default ogroup, nbuf
    8; the streaming engine at another ``ogroup`` on request)."""
    import torch

    from spada_tpu_torch.convert import item_ptr_of, tile_ptr_of
    from spada_tpu_torch.ops import engine as E

    def ids(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

    ai, bi, oi, n_c = ids(wl.a_tid), ids(wl.b_tid), ids(wl.o_tid), wl.n_c_tiles
    if engine == "streaming":
        if ogroup is None:
            ogroup = inspect.signature(E.run_worklist_streaming).parameters[
                "ogroup"].default
        args = (a_t, b_t, ai, bi, oi,
                ids(item_ptr_of(wl.o_tid, n_c, ogroup)), n_c, ogroup, 8)
        kernel, plain = E.tile_stream, E.tile_stream_reference
    elif engine == "panel":
        args = (a_t.transpose(1, 2).contiguous(), b_t, ai, bi,
                ids(tile_ptr_of(wl.o_tid, n_c)))
        kernel, plain = E.tile_panel, E.tile_panel_reference
    else:
        args = (a_t, b_t, ai, bi, oi, n_c)
        kernel, plain = E.tile_grid, E.tile_grid_reference
    return (lambda: kernel(*args)), (lambda: plain(*args))


def engine_segments(dev, engine: str, kernel: str, host_state: dict,
                    errs: dict, label: str) -> tuple:
    """``kernel`` against its plain version on every segment of a plan's
    ``host_state``, each timed beside it (and the streaming kernel at
    ogroup 1 against 8).  Returns (kernel s, plain s)."""
    import torch

    from spada_tpu_torch.ops.engine import tile_block

    t_kernel = t_plain = 0.0
    t_og = [0.0, 0.0]  # tile_stream at ogroup 1 and 8
    tk, tn = host_state["tk"], host_state["tn"]
    for wl, a_np, b_np, tm in host_state["segments"]:
        a_t = torch.from_numpy(a_np).to(dev)
        b_t = torch.from_numpy(b_np).to(dev)
        kernel_fn, plain_fn = engine_pair(engine, a_t, b_t, wl, dev)
        g, r = kernel_fn(), plain_fn()
        r_np = r.cpu().numpy()
        e = relerr(g.cpu().numpy(), r_np)
        require(e <= 1e-5, f"{kernel} nn [{label}] segment tm={tm}: kernel "
                f"vs plain {e:.3e}")
        errs[kernel] = max(errs[kernel], float((g - r).abs().max()))
        del g, r
        tk_s, tp_s = time_pair(kernel_fn, plain_fn)
        flops = 2 * wl.n_items * tm * tk * tn
        log(f"  [{label}] {kernel} segment tm={tm} tk=tn={tk} on the "
            f"{tile_block(tm, tk, tn, a_np.dtype, kernel)} block: "
            f"W={wl.n_items} nC={wl.n_c_tiles}  kernel {tk_s * 1e3:.3f} ms "
            f"({flops / tk_s / 1e12:.2f} TFLOP/s)  plain "
            f"{tp_s * 1e3:.3f} ms ({flops / tp_s / 1e12:.2f} TFLOP/s)  "
            f"kernel vs plain max|d|/max|ref| {e:.2e}")
        t_kernel += tk_s
        t_plain += tp_s
        if engine == "streaming":
            # ogroup 1 (item_ptr = tile_ptr) against the reference's 8,
            # interleaved in one timing
            og = [engine_pair(engine, a_t, b_t, wl, dev, ogroup=k)[0]
                  for k in (1, 8)]
            for k, fn in zip((1, 8), og):
                e_k = relerr(fn().cpu().numpy(), r_np)
                require(e_k <= 1e-5, f"tile_stream ogroup {k} nn [{label}] "
                        f"segment tm={tm}: kernel vs plain {e_k:.3e}")
            t1, t8 = time_pair(*og)
            t_og[0] += t1
            t_og[1] += t8
            log(f"  [{label}] tile_stream segment tm={tm}: ogroup 1 "
                f"{t1 * 1e3:.3f} ms ({flops / t1 / 1e12:.2f} TFLOP/s), "
                f"ogroup 8 {t8 * 1e3:.3f} ms ({flops / t8 / 1e12:.2f} "
                f"TFLOP/s)")
            del og
        del a_t, b_t, r_np, kernel_fn, plain_fn
    if engine == "streaming":
        log(f"  [{label}] tile_stream on nn, one timing: ogroup 1 "
            f"{t_og[0] * 1e3:.3f} ms, ogroup 8 {t_og[1] * 1e3:.3f} ms")
    torch.cuda.empty_cache()
    return t_kernel, t_plain


def run_engines(dev, runs: dict, c_tile, ref_rows, totals: dict,
                errs: dict, times: dict, extra: dict) -> None:
    """Phase 6: the fit's plan through spgemm(plan=) under each engine
    override (the main path), gated, each kernel held to its plain version
    and timed on every segment; then the same kernels against their plain
    versions on every segment of the other plan of NN_PLANS."""
    from spada_tpu_torch.ops.spgemm import spgemm

    rows = ref_rows.shape[0]
    main_label = NN_PLANS[0]
    run = runs[main_label]
    for engine, kernel in ENGINE_KERNEL.items():
        cfg = dataclasses.replace(run.config, engine=engine)
        t0 = time.perf_counter()
        with main_path(totals) as counts:
            res = spgemm(run.a, run.b, cfg, dataflow="spada", plan=run.plan,
                         device=dev)
        log(f"  engine {engine}: spgemm(plan=) {time.perf_counter() - t0:.1f}"
            f" s host+device, launches {counts}")
        require(counts.get(kernel, 0) > 0, f"nn under engine {engine} did "
                f"not launch {kernel}")
        require(counts.get("tile_spgemm", 0) == 0,
                f"nn under engine {engine} launched tile_spgemm")
        got = res.todense()
        e_ref = relerr(got[:rows], ref_rows)
        e_tile = relerr(got, c_tile)
        log(f"  gate vs scipy/numpy f64, rows [0, {rows}): max|d|/max|ref| = "
            f"{e_ref:.2e} (limit 1e-4); vs tile_spgemm's C: {e_tile:.2e} "
            f"(limit 1e-5)")
        require(e_ref < 1e-4, f"nn under engine {engine}: gate {e_ref:.3e}")
        require(e_tile <= 1e-5,
                f"nn under engine {engine}: vs tile_spgemm {e_tile:.3e}")
        del got
        times[kernel] = engine_segments(dev, engine, kernel, res.host_state,
                                        errs, main_label)
        extra["nn_plans"][main_label]["times"][kernel] = times[kernel]
    for label in NN_PLANS[1:]:
        for engine, kernel in ENGINE_KERNEL.items():
            extra["nn_plans"][label]["times"][kernel] = engine_segments(
                dev, engine, kernel, runs[label].result.host_state, errs,
                label)


# --------------------------------------------------------------------------
# phase 7: the probes
# --------------------------------------------------------------------------

#: each probe mode's bar against its plain version, of max|plain|
PROBE_TILE_TOL = 1e-5
PROBE_STREAM_TOL = 1e-6


def run_probes(dev, totals: dict, errs: dict, times: dict,
               extra: dict) -> None:
    """The four probe tools at their sizes: one workload build for
    ``probe_kernel`` and ``probe_manual`` (the same banded pair), every TPU
    mode name of both, then ``probe_panel3d`` and ``probe_pallas_stream``."""
    import torch

    from spada_tpu_torch.tools import (probe_kernel, probe_manual,
                                       probe_pallas_stream, probe_panel3d)
    from spada_tpu_torch.tools.tile_probe import (F32_MODES, MMA_MODES,
                                                  probe_work, run_modes)

    t0 = time.perf_counter()
    work = probe_work(65536, 384, 256, dev)
    log(f"  banded 65536^2 band 384, T=256 bf16 tiles built in "
        f"{time.perf_counter() - t0:.1f} s")
    sub_log = lambda s: log("  " + s)  # noqa: E731
    tpu_names = probe_kernel.ALL_MODES + probe_manual.ALL_MODES
    both = [m for m in MMA_MODES if m not in F32_MODES]
    with main_path(totals) as counts:
        log(" probe_kernel, all modes, FP32 SIMT block:")
        res_k = run_modes(work, probe_kernel.ALL_MODES, log=sub_log,
                          block="simt")
        log(" probe_manual, all modes, FP32 SIMT block:")
        res_m = run_modes(work, probe_manual.ALL_MODES, log=sub_log,
                          block="simt")
        log(" both probes' modes and the block's own, tensor-core block:")
        res_t = run_modes(work, tpu_names + both, log=sub_log, block="mma")
        t1 = time.perf_counter()
        work32 = probe_work(65536, 384, 256, dev, dtype=torch.float32)
        log(f" the same pair as f32 tiles (built in "
            f"{time.perf_counter() - t1:.1f} s), tensor-core block:")
        res_f = run_modes(work32, ["full", "nodma", "v2nocopy", "v2stat",
                                   *MMA_MODES], log=sub_log, block="mma")
        del work32
        log(" probe_panel3d:")
        res_p = probe_panel3d.run(device=dev, log=sub_log)
        log(" probe_pallas_stream:")
        res_s = probe_pallas_stream.run(device=dev, log=sub_log)
    log(f"  launches {counts}")
    for k in ("tile_probe", "tile_probe_mma", "tile_spgemm", "tile_panel",
              "esc_stream_mul",
              "esc_stream_red", "esc_stream_mul_blocked",
              "esc_stream_red_blocked"):
        require(counts.get(k, 0) > 0, f"the probes did not launch {k}")

    for name, label, modes in (
            ("tile_probe", "SIMT", {**res_k, **res_m}),
            ("tile_probe_mma", "tensor cores, bf16 tiles", res_t),
            ("tile_probe_mma", "tensor cores, f32 tiles", res_f)):
        for mode, rec in modes.items():
            if rec["exact"] is not None:
                require(rec["exact"], f"{name} {mode} ({label}): not "
                        f"bitwise its plain version")
            require(rec["relerr"] <= rec["tol"], f"{name} {mode} ({label}): "
                    f"relerr {rec['relerr']:.3e} > {rec['tol']}")
            errs[name] = max(errs[name], rec["max_abs_err"])
    for label, res in (("bf16", res_t), ("f32", res_f)):
        full = res["full"]["ms"]
        log(f"  tensor-core block, {label} tiles, ms less than full "
            f"({full:.3f} ms): "
            + ", ".join(f"{m} {full - r['ms']:+.3f}" for m, r in res.items()
                        if m != "full"))
    for variant, rec in res_p.items():
        require(rec["relerr"] <= PROBE_TILE_TOL, f"panel3d {variant}: "
                f"relerr {rec['relerr']:.3e} > {PROBE_TILE_TOL}")
    # the library yardstick of panel3d's peritem (tile_spgemm)
    call, label = probe_panel3d.library_case(384, 200, dev)
    lib_p = library_time(call)
    log(f"  panel3d library call, {label}: {lib_p * 1e3:.3f} ms (peritem "
        f"{res_p['peritem']['ms']:.3f} ms)")
    del call
    for label, rec in res_s.items():
        tol = (PROBE_STREAM_TOL if rec["kernel"].startswith("esc_stream_red")
               else 0.0)
        require(rec["relerr"] <= tol, f"stream probe {label}: relerr "
                f"{rec['relerr']:.3e} > {tol}")
        require(rec["exact"] is not False, f"stream probe {label}: not "
                f"bitwise the main path's kernel")
    # the JSON rows of the probe's own launches: each kernel's fastest stage
    # row of the sweep
    for name, lib in (("esc_stream_mul_blocked", "torch.mul"),
                      ("esc_stream_red_blocked",
                       "torch.linalg.vecdot(dim=0)")):
        label = probe_pallas_stream.best_row(res_s, name)
        rec = res_s[label]
        log(f"  {name}: best stage row {label}, {rec['ms']:.3f} ms "
            f"({rec['bound_ms'] / rec['ms']:.0%} of its bound), main path "
            f"{rec['main_ms']:.3f} ms, {lib} {rec['library_ms']:.3f} ms")
        errs[name] = max(r["max_abs_err"] for r in res_s.values()
                         if r["kernel"] == name)
        times[name] = (rec["ms"] * 1e-3, rec["plain_ms"] * 1e-3)
        extra[name] = {"bound": (rec["bound_ms"] * 1e-3, rec["bound_by"]),
                       "library": (rec["library_ms"] * 1e-3, lib)}

    for name, res in (("tile_probe", res_k), ("tile_probe_mma", res_t)):
        full = res["full"]
        times[name] = (full["ms"] * 1e-3, full["plain_ms"] * 1e-3)
    kind = torch.cuda.get_device_name(dev)
    # one dense product computes the same C: bf16 in, f32 out (the probe's
    # C tiles are f32); a torch without out_dtype gives bf16 out
    da = dense_of(work.a_csr, dev, torch.bfloat16)
    db = dense_of(work.b_csr, dev, torch.bfloat16)
    try:
        torch.mm(da[:8, :8], db[:8, :8], out_dtype=torch.float32)
        lib_fn, note = (lambda: torch.mm(da, db, out_dtype=torch.float32),
                        "torch.mm, dense bf16 in, f32 out")
    except (TypeError, RuntimeError) as err:
        log(f"  torch.mm(out_dtype=float32) refused ({err}); bf16 out")
        lib_fn, note = (lambda: torch.mm(da, db),
                        "torch.mm, dense bf16 in, bf16 out")
    lib_s = library_time(lib_fn)
    log(f"  library call on the banded pair, {note} (cuBLAS, "
        f"{work.n} x {work.n}): {lib_s * 1e3:.3f} ms")
    del da, db, lib_fn
    extra["tile_probe"] = {"bound": work.bound(kind),
                           "library": (lib_s, note)}
    del work
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 8: the sparse MLP
# --------------------------------------------------------------------------

#: SGD step size of phase 8's three steps: the loss's curvature at these
#: widths is about 1.5e-3 (2 / (out x batch) times the largest squared
#: singular value of a layer's input, ~(sqrt(128) + sqrt(1024))^2 x its
#: variance), so 10 is far inside the stable range (2 / 1.5e-3)
MLP_LR = 10.0


def tile_index(spec, dev):
    """int64 [n_tiles, tm, tk]: each tile element's offset in the dense
    [n_tile_rows * tm, n_k_tiles * tk] weight."""
    import torch

    rows = torch.from_numpy(spec.tile_row.astype(np.int64)).to(dev)
    cols = torch.from_numpy(spec.tile_col.astype(np.int64)).to(dev)
    i = torch.arange(spec.tm, device=dev)
    j = torch.arange(spec.tk, device=dev)
    width = spec.n_k_tiles * spec.tk
    return ((rows[:, None, None] * spec.tm + i[None, :, None]) * width
            + cols[:, None, None] * spec.tk + j[None, None, :])


def dense_weights(model, dtype):
    """Each layer's dense weight in ``dtype``, the tiles added at their
    places (a tile the connectivity guard moved onto an occupied place
    adds to it, as in the model)."""
    import torch

    out = []
    for spec, tiles in zip(model.specs, model.params):
        w = torch.zeros(spec.n_tile_rows * spec.tm, spec.n_k_tiles * spec.tk,
                        dtype=dtype, device=tiles.device)
        w.view(-1).index_add_(0, tile_index(spec, tiles.device).view(-1),
                              tiles.detach().to(dtype).view(-1))
        out.append(w)
    return out


def dense_forward(model, ws, x):
    """The model's forward on dense weights ``ws``."""
    import torch

    h = x
    for i, w in enumerate(ws):
        h = w @ h
        if i + 1 < len(ws):
            h = torch.relu(h)
            want = model.specs[i + 1].n_k_tiles * model.specs[i + 1].tk
            h = (torch.nn.functional.pad(h, (0, 0, 0, want - h.shape[0]))
                 if h.shape[0] < want else h[:want])
    return h


def run_sparse_mlp(dev, dims=(16384, 16384, 16384), density: float = 0.2,
                   batch: int = 1024) -> None:
    """entry()'s forward against a dense f64 forward of the same tiles;
    then at the width of the bench's NN layer: forward and one step's tile
    gradients against dense f64, three SGD steps with a falling loss, and
    forward and step times beside one dense layer's torch.matmul."""
    import torch

    from spada_tpu_torch.models.sparse_nn import (SparseMLP, entry,
                                                  make_train_step)
    from spada_tpu_torch.utils.timing import cuda_time

    fn, (x,) = entry(dev)
    model = fn.__self__
    with torch.no_grad():
        got = fn(x)
        ref = dense_forward(model, dense_weights(model, torch.float64),
                            x.double())
    err = relerr(got.cpu().numpy(), ref.cpu().numpy())
    log(f"  entry(): {tuple(got.shape)} out, vs dense f64 max|d|/max|ref| = "
        f"{err:.2e} (limit 1e-5)")
    require(err < 1e-5, f"entry() forward: relerr {err:.3e}")

    t0 = time.perf_counter()
    model = SparseMLP.from_density(dims, density, tm=128, tk=128, seed=0,
                                   device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((model.in_pad, batch), generator=gen, device=dev)
    y = torch.randn((model.out_pad, batch), generator=gen, device=dev)
    n_tiles = [int(p.shape[0]) for p in model.params]
    log(f"  SparseMLP{dims}, density {density}, 128^2 tiles {n_tiles}, "
        f"batch {batch}: built in {time.perf_counter() - t0:.1f} s")
    with torch.no_grad():
        got = model(x)
    ws = [w.requires_grad_() for w in dense_weights(model, torch.float64)]
    ref = dense_forward(model, ws, x.double())
    err = relerr(got.cpu().numpy(), ref.detach().cpu().numpy())
    log(f"  forward vs dense f64: max|d|/max|ref| = {err:.2e} (limit 1e-4)")
    require(err < 1e-4, f"sparse MLP forward: relerr {err:.3e}")
    del got
    torch.mean((ref - y.double()) ** 2).backward()
    del ref
    model.zero_grad(set_to_none=True)
    model.loss(x, y).backward()
    for i, (p, w) in enumerate(zip(model.params, ws)):
        g_ref = w.grad.view(-1)[tile_index(model.specs[i], dev)]
        err = relerr(p.grad.cpu().numpy(), g_ref.cpu().numpy())
        log(f"  layer {i}: tile gradients vs dense f64 read at the tiles: "
            f"max|d|/max|ref| = {err:.2e} (limit 1e-4)")
        require(err < 1e-4, f"sparse MLP layer {i} gradient: {err:.3e}")
        del g_ref
    del ws
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    step = make_train_step(model, lr=MLP_LR)
    losses = [float(step(x, y)) for _ in range(3)]
    log(f"  three SGD steps, lr {MLP_LR}: loss {losses}")
    require(losses[0] > losses[1] > losses[2],
            f"sparse MLP loss did not fall: {losses}")

    def forward():
        with torch.no_grad():
            return model(x)

    w32 = dense_weights(model, torch.float32)[0]
    t_fwd, _ = cuda_time(forward, warmup=1, reps=5)
    t_step, _ = cuda_time(lambda: step(x, y), warmup=1, reps=5)
    t_dense, _ = cuda_time(lambda: torch.matmul(w32, x), warmup=1, reps=5)
    flops = sum(2 * n * 128 * 128 * batch for n in n_tiles)
    log(f"  device ms: forward {t_fwd * 1e3:.3f} ({flops / t_fwd / 1e12:.2f} "
        f"TFLOP/s of tile products), SGD step {t_step * 1e3:.3f}; one dense "
        f"layer, torch.matmul {tuple(w32.shape)} x {tuple(x.shape)} f32 (TF32 "
        f"off): {t_dense * 1e3:.3f}; on {smi_name_power()}")
    del model, step, x, y, w32
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 9: the distributed strategies
# --------------------------------------------------------------------------

#: bf16 tiles against f64: both operands rounded to bf16 (8 bits), products
#: exact, f32 sums; the reference's own gate for its bf16 tiles is 2e-2
BF16_GATE = 1e-2


def sharded_shape(world: int) -> tuple:
    """The (dp, tp) mesh of ``world`` ranks that phase 9 runs the
    psum-merge on: tp 2 where the world is even."""
    return (world // 2, 2) if world % 2 == 0 else (world, 1)


def distributed_inputs(nn_ab=None, nn_ref=None, rows: int = GATE_ROWS,
                       m: int = 16384, n: int = 4096) -> dict:
    """The nn and locpl pairs of phases 4-5 with the f64 references of C's
    first ``rows`` rows (phase 4's when given)."""
    from spada_tpu_torch.io.workloads import (block_sparse_csr,
                                              localized_powerlaw_csr,
                                              relu_activation_csr)

    if nn_ab is None:
        nn_ab = (block_sparse_csr(m, m, 384, 0.2, seed=5, dtype=np.float32),
                 relu_activation_csr(m, n, 0.35, seed=6, dtype=np.float32))
    a, b = nn_ab
    if nn_ref is None:
        nn_ref = (a.to_scipy()[:rows].toarray().astype(np.float64)
                  @ b.to_scipy().toarray().astype(np.float64))
    la = localized_powerlaw_csr(65536, 65536, 32.0, seed=1, dtype=np.float32)
    lb = localized_powerlaw_csr(65536, 65536, 32.0, seed=2, dtype=np.float32)
    return {"nn": nn_ab, "nn_ref": nn_ref, "locpl": (la, lb),
            "locpl_ref": (la.to_scipy()[:rows] @ lb.to_scipy()).tocsr()}


def locpl_gate(csr, ref) -> float:
    got = csr.to_scipy()[: ref.shape[0]]
    return float(abs(got - ref).max() / max(abs(ref).max(), 1e-30))


def strategy_checks(dev, cfg, inputs: dict, world: int, log, totals: dict,
                    nn_c=None) -> None:
    """The three strategies and the sharded MLP step through their entry
    points, this process being one rank of the default process group of
    ``world`` ranks, each gated: the nn pair through ``spgemm_sharded``
    (f32 and bf16 tiles) and ``spgemm_halo``, the locpl pair through
    ``spgemm_element_dp`` (the stream kernels), the MLP's parameters after
    one step against ``make_train_step``'s.  ``nn_c``: the single-device
    spgemm's C, which the f32 result must equal to 1e-5 of max|C|."""
    import torch

    from spada_tpu_torch.models.sparse_nn import (SparseMLP,
                                                  make_sharded_train_step,
                                                  make_train_step)
    from spada_tpu_torch.parallel import (partition_element, partition_halo,
                                          partition_spgemm, spgemm_element_dp,
                                          spgemm_halo, spgemm_sharded)
    from spada_tpu_torch.parallel.element_dp import element_rank
    from spada_tpu_torch.parallel.halo import halo_rank, halo_received
    from spada_tpu_torch.parallel.mesh import resolve_mesh
    from spada_tpu_torch.parallel.spgemm import sharded_rank
    from spada_tpu_torch.tools.harness import call_s
    from spada_tpu_torch.utils.timing import cuda_time

    a, b = inputs["nn"]
    ref = inputs["nn_ref"]
    rows = ref.shape[0]
    shape = sharded_shape(world)
    mesh = resolve_mesh(None, shape, ("dp", "tp"), dev)
    d, t = mesh.get_coordinate()
    rank = d * shape[1] + t           # the 1-D mesh's coordinate
    t0 = time.perf_counter()
    prob = partition_spgemm(a, b, *shape, cfg)
    log(f"  nn, partition_spgemm {shape}: {time.perf_counter() - t0:.1f} s "
        f"host; Wmax {prob.Wmax}, nCmax {prob.nCmax}, imbalance "
        f"{prob.imbalance:.3f}")
    c32 = None
    for dt, gate in ((torch.float32, 1e-4), (torch.bfloat16, BF16_GATE)):
        t0 = time.perf_counter()
        with main_path(totals) as counts:
            res = spgemm_sharded(prob, device=dev, engine="cached",
                                 engine_dtype=dt)
        wall = time.perf_counter() - t0
        c = res.todense()
        err = relerr(c[:rows], ref)
        ms = call_s(sharded_rank(prob, d, t, dev, "cached", dt), dev,
                    warmup=1, reps=5) * 1e3
        line = (f"  spgemm_sharded, {str(dt)[6:]} tiles: {wall:.2f} s "
                f"host+device, rank ({d}, {t})'s body {ms:.3f} ms device, "
                f"launches {counts}; rows [0, {rows}) vs scipy/numpy f64 "
                f"{err:.2e} (limit {gate:g})")
        require(counts.get("tile_spgemm", 0) >= 1,
                f"spgemm_sharded did not launch tile_spgemm: {counts}")
        require(err < gate, f"spgemm_sharded {dt}: {err:.3e} vs scipy")
        if dt == torch.float32:
            c32 = c
            if nn_c is not None:
                e1 = relerr(c, nn_c)
                line += f"; vs the single-device spgemm's C {e1:.2e}"
                require(e1 <= 1e-5, f"spgemm_sharded f32 vs spgemm {e1:.3e}")
        else:
            c16 = c
        log(line)
    del c
    t0 = time.perf_counter()
    halo = partition_halo(a, b, world, cfg)
    host = time.perf_counter() - t0
    t0 = time.perf_counter()
    with main_path(totals) as counts:
        res = spgemm_halo(halo, device=dev)
    wall = time.perf_counter() - t0
    c = res.todense()
    err, e16 = relerr(c[:rows], ref), relerr(c, c16)
    got = {k: torch.from_numpy(halo_received(halo, rank, k)).to(
        dev, torch.bfloat16) for k in range(1, world)}
    ms = call_s(halo_rank(halo, rank, dev), dev, got.__getitem__, warmup=1,
                reps=5) * 1e3
    del got
    log(f"  spgemm_halo D={world}, bf16 tiles: partition {host:.1f} s, run "
        f"{wall:.2f} s host+device, rank {rank}'s body {ms:.3f} ms device, "
        f"{halo.halo_tiles_sent} tiles sent, launches {counts}; vs scipy "
        f"{err:.2e} (limit {BF16_GATE:g}), vs spgemm_sharded's bf16 C "
        f"{e16:.2e} (limit 1e-5)")
    require(counts.get("tile_spgemm", 0) >= 1, "spgemm_halo: no tile_spgemm")
    require(err < BF16_GATE and e16 <= 1e-5, f"spgemm_halo: {err}, {e16}")
    del c, c16, c32, res
    torch.cuda.empty_cache()

    la, lb = inputs["locpl"]
    t0 = time.perf_counter()
    eprob = partition_element(la, lb, world)
    host = time.perf_counter() - t0
    t0 = time.perf_counter()
    with main_path(totals) as counts:
        res = spgemm_element_dp(eprob, device=dev, backend="pallas")
    wall = time.perf_counter() - t0
    err = locpl_gate(res.to_csr(), inputs["locpl_ref"])
    ms = call_s(element_rank(eprob, rank, dev, "pallas"), dev, warmup=1,
                reps=5) * 1e3
    log(f"  spgemm_element_dp D={world}: partition {host:.1f} s, run "
        f"{wall:.2f} s host+device, rank {rank}'s body {ms:.3f} ms device, E "
        f"per rank {eprob.e_per_shard.tolist()}, launches {counts}; rows "
        f"[0, {inputs['locpl_ref'].shape[0]}) vs scipy {err:.2e} (limit "
        f"1e-3)")
    require(counts == {"esc_stream_group": 1},
            f"spgemm_element_dp: not one grouped launch: {counts}")
    require(err < 1e-3, f"spgemm_element_dp: {err:.3e} vs scipy")
    del res, eprob
    torch.cuda.empty_cache()

    # the sharded MLP step against the single-device step, same model
    dims, lr, batch = (16384, 16384, 16384), MLP_LR, 1024
    models = [SparseMLP.from_density(dims, 0.2, tm=128, tk=128, seed=0,
                                     device=dev) for _ in range(2)]
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((models[0].in_pad, batch), generator=gen, device=dev)
    y = torch.randn((models[0].out_pad, batch), generator=gen, device=dev)
    sstep, sp = make_sharded_train_step(models[0], mesh, lr=lr)
    new, loss_s = sstep(sp, x, y)
    loss_1 = make_train_step(models[1], lr=lr)(x, y)
    worst = relerr(float(loss_s), float(loss_1))
    for p, q in zip(new, models[1].params):
        ix = torch.arange(t, q.shape[0], shape[1], device=dev)
        worst = max(worst, relerr(p[: len(ix)].detach().cpu().numpy(),
                                  q.detach()[ix].cpu().numpy()))
    t_step, _ = cuda_time(lambda: sstep(sp, x, y), warmup=1, reps=5)
    log(f"  make_sharded_train_step on a {shape} mesh, SparseMLP{dims} "
        f"density 0.2, batch {batch}: params and loss after one step vs "
        f"make_train_step max|d|/max|ref| {worst:.2e} (limit 1e-5); step "
        f"{t_step * 1e3:.3f} ms device")
    require(worst <= 1e-5, f"sharded MLP step vs make_train_step {worst}")
    del models, sp, new, x, y, sstep
    torch.cuda.empty_cache()


def run_panel_orders(dev, run, totals: dict) -> None:
    """run_worklist_panel on phase 4's plan under each run order: every C,
    its permutation undone, equal to the row order's to 1e-5."""
    import torch

    from spada_tpu_torch.ops.engine import run_worklist_panel

    with main_path(totals) as counts:
        for wl, a_np, b_np, tm in run.result.host_state["segments"]:
            a_t = torch.from_numpy(a_np).to(dev)
            b_t = torch.from_numpy(b_np).to(dev)
            ids = (wl.a_tid, wl.b_tid, wl.o_tid, wl.n_c_tiles)
            row = run_worklist_panel(a_t, b_t, *ids)[0].cpu().numpy()
            line = []
            for order in ("col", "diag", "auto"):
                t0 = time.perf_counter()
                c, _, _, perm = run_worklist_panel(
                    a_t, b_t, *ids, run_order=order, c_rows=wl.c_tile_row,
                    c_cols=wl.c_tile_col)
                c = c.cpu().numpy()
                host = time.perf_counter() - t0
                if perm is not None:
                    inv = np.empty_like(perm)
                    inv[perm] = np.arange(len(perm))
                    c = c[inv]
                err = relerr(c, row)
                require(err <= 1e-5, f"run order {order} tm={tm}: {err:.3e}")
                kind = "row order" if perm is None else "permuted"
                line.append(f"{order} {err:.1e} ({kind}, {host:.2f} s)")
            log(f"  segment tm={tm}, {wl.n_c_tiles} C tiles: vs row order "
                + ", ".join(line))
            del a_t, b_t
    log(f"  launches {counts}")
    require(counts.get("tile_panel", 0) == 4 * len(
        run.result.host_state["segments"]), f"run orders: {counts}")


def rank_bodies(dev, cfg, inputs: dict, nn_c, totals: dict, world: int = 4):
    """Every rank's body of a (world, 2) psum-merge partition and a
    ``world``-rank halo partition of the nn pair (f32 tiles), and of a
    ``world``-rank element dp partition of locpl, one after another on this
    card: each panel against scipy on its first rows and against the
    single-device C; the element slabs, put together, against scipy."""
    import torch

    from spada_tpu_torch.parallel import (partition_element, partition_halo,
                                          partition_spgemm)
    from spada_tpu_torch.parallel.element_dp import (ElementDpResult,
                                                     element_rank)
    from spada_tpu_torch.parallel.halo import halo_view
    from spada_tpu_torch.parallel.spgemm import ShardedResult
    from spada_tpu_torch.tools.eval_scaling import halo_bodies, reduce_bodies
    from spada_tpu_torch.tools.harness import call_s

    a, b = inputs["nn"]
    a_sp, b64 = a.to_scipy(), b.to_scipy().toarray().astype(np.float64)
    smi = smi_name_power()

    def check_panels(label, problem, c_tiles, n_panels):
        view = problem if hasattr(problem, "n_dp") else halo_view(problem)
        dense = ShardedResult(view, c_tiles).todense()
        worst = 0.0
        for d in range(n_panels):
            r0 = int(view.row_base[d])
            r1 = min(r0 + 256, int(view.row_base[d + 1]) if d + 1 < n_panels
                     else a.shape[0])
            if r1 <= r0:
                continue
            want = a_sp[r0:r1].toarray().astype(np.float64) @ b64
            worst = max(worst, relerr(dense[r0:r1], want))
        e1 = relerr(dense, nn_c)
        log(f"  {label}: each panel's first rows vs scipy/numpy f64 max "
            f"{worst:.2e} (limit 1e-4); the panels put together vs the "
            f"single-device spgemm's C {e1:.2e} (limit 1e-5)")
        require(worst < 1e-4 and e1 <= 1e-5, f"{label}: {worst}, {e1}")

    f32 = torch.float32
    with main_path(totals) as counts:
        t0 = time.perf_counter()
        prob = partition_spgemm(a, b, world, 2, cfg)
        host = time.perf_counter() - t0
        ms, c = reduce_bodies(prob, dev, f32)
        work = prob.work_per_shard.ravel().tolist()
        log(f"  psum-merge ({world}, 2) bodies, f32 tiles: partition "
            f"{host:.1f} s host, W per rank {work}, device ms per body "
            + ", ".join(f"{x:.3f}" for x in ms)
            + f" (on {smi})")
        check_panels(f"psum-merge ({world}, 2), summed over tp", prob, c,
                     world)
        del prob, c
        t0 = time.perf_counter()
        halo = partition_halo(a, b, world, cfg)
        host = time.perf_counter() - t0
        ms, c = halo_bodies(halo, dev, f32)
        log(f"  halo D={world} bodies, f32 tiles, received tiles read from "
            f"the problem: partition {host:.1f} s host, caps {halo.caps}, "
            f"{halo.halo_tiles_sent} tiles sent ({halo.halo_tiles_padded} "
            f"slots), device ms per body "
            + ", ".join(f"{x:.3f}" for x in ms))
        check_panels(f"halo D={world}", halo, c, world)
        del halo, c
        torch.cuda.empty_cache()
        la, lb = inputs["locpl"]
        t0 = time.perf_counter()
        eprob = partition_element(la, lb, world)
        host = time.perf_counter() - t0
        flat, ms = [], []
        for r in range(world):
            body = element_rank(eprob, r, dev, "pallas")
            flat.append(body().cpu().numpy())
            ms.append(call_s(body, dev, warmup=1, reps=5) * 1e3)
            del body
        cuts = np.cumsum([x.shape[1] for x in eprob.a_stacked])[:-1]
        vals = np.split(np.stack(flat), cuts, axis=1)
        err = locpl_gate(ElementDpResult(eprob, vals).to_csr(),
                         inputs["locpl_ref"])
        log(f"  element dp D={world} bodies: partition {host:.1f} s host, E "
            f"per rank {eprob.e_per_shard.tolist()}, device ms per body "
            + ", ".join(f"{x:.3f}" for x in ms)
            + f"; the slabs put together vs scipy {err:.2e} (limit 1e-3)")
        require(err < 1e-3, f"element dp bodies: {err:.3e}")
    log(f"  launches {counts}")
    for k in ("tile_spgemm", "esc_stream_group"):
        require(counts.get(k, 0) > 0, f"the rank bodies did not launch {k}")


def run_distributed(dev, kind: str, nn_run, nn_c, nn_ref,
                    totals: dict) -> None:
    """Phase 9: (a) the entry points on a one-rank NCCL group in this
    process, and the panel run orders; (b) every rank's body of 4-way
    partitions on this card; (c) the entry points across cards, where there
    are two or more."""
    import torch
    import torch.distributed as dist

    from spada_tpu_torch.config import h100_config

    cfg = h100_config(kind)
    t0 = time.perf_counter()
    inputs = distributed_inputs((nn_run.a, nn_run.b), nn_ref)
    log(f"  the locpl pair and its scipy rows in "
        f"{time.perf_counter() - t0:.1f} s; tiles {cfg.default_tm} x "
        f"{cfg.tile_k} x {cfg.tile_n}")
    log(" (a) a one-rank NCCL group in this process, on cuda:0:")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        strategy_checks(dev, cfg, inputs, 1, log, totals, nn_c)
    finally:
        dist.destroy_process_group()
    log(" run_worklist_panel's run orders on phase 4's plan:")
    run_panel_orders(dev, nn_run, totals)
    log(" (b) every rank's body of 4-way partitions, on this card:")
    rank_bodies(dev, cfg, inputs, nn_c, totals)
    count = torch.cuda.device_count()
    if count < 2:
        log(f" (c) not run: this machine has {count} CUDA device; the "
            f"entry points across cards need two or more")
        return
    world = min(count, 8)
    log(f" (c) the entry points across {world} cards (NCCL, one process "
        f"per card):")
    run_across_cards(world)


def run_across_cards(world: int) -> None:
    import tempfile

    import torch.multiprocessing as mp

    workdir = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    mp.start_processes(_card_rank, args=(world, workdir), nprocs=world,
                       join=True, start_method="spawn")


def _card_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of phase 9 (c): its card, an NCCL group over ``world``
    cards, strategy_checks on it; rank 0 logs."""
    import torch
    import torch.distributed as dist

    from spada_tpu_torch.config import h100_config

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world)
    say = log if rank == 0 else (lambda s: None)
    try:
        inputs = distributed_inputs(rows=256)
        strategy_checks(dev, h100_config(torch.cuda.get_device_name(rank)),
                        inputs, world, say, {})
        check_no_reference(f"rank {rank}")
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# phase 10: the planner's calibration and evaluation
# --------------------------------------------------------------------------

#: the eval's row sets that phase 10 (c) runs at n = 8192, with the graded
#: FEM: between them every row type (tm32, tm<T>, panel, spada, spada+densify
#: under both scorers' picks, the dispatched element side)
EVAL_SUBSET = ("banded", "loc-powerlaw", "nn-bert-ffn1-blk32")


def crossover_tile_only(fill: int, dev, say, n: int = 32768) -> None:
    """Phase 10 (b) at a fill whose element side the smoke leaves to the
    tool (fill 192: 9.4e8 products, two minutes of host planning): the
    dispatch under both sets of terms and the tile side each T runs,
    gated and timed; no verdict, since one side is not measured."""
    from spada_tpu_torch.ops.spgemm import dispatch_dataflow
    from spada_tpu_torch.tools import probe_dispatch_crossover as X
    from spada_tpu_torch.tools.harness import (card_name, first_rows_ref,
                                               fmt_ms)

    band = 384
    a = X.banded_fill_csr(n, band, fill, seed=fill)
    b = X.banded_fill_csr(n, band, fill, seed=fill + 1)
    ref = first_rows_ref(a, b, GATE_ROWS)
    tile = {}
    for k, cfg in X.configs(card_name(dev)).items():
        choice, det = dispatch_dataflow(a, b, cfg)
        T, t_model = X.tile_model(a, b, cfg)
        if T not in tile:
            tile[T] = X.tile_side(a, b, T, dev, ref, GATE_ROWS)
        t_s, w, err = tile[T]
        say(f"fill={fill} [{k}]: dispatch={choice} T={T} modeled tile "
            f"{t_model * 1e3:.3f} elem "
            f"{det['element']['t_est'] * 1e3:.3f} ms; measured tile "
            f"{fmt_ms(t_s)} ms W={w} gate {err:.1e}; element side not "
            f"measured here (E={det['element']['e_products']}), verdict -")


def run_calibration(dev, runs: dict, nn_ref, extra: dict,
                    totals: dict) -> None:
    """Phase 10: the four tools of spada_tpu_torch.tools at reduced depth,
    then (e) phase 4's two plans of the nn pair side by side."""
    from spada_tpu_torch.tools import (bench_value_refresh,
                                       eval_adaptive,
                                       probe_dispatch_crossover,
                                       probe_item_overhead)
    from spada_tpu_torch.tools.harness import card_name, fmt_ms

    def say(s):
        for line in s.splitlines() or [""]:
            log("    " + line)

    evaluated = []

    def quick_eval():
        sets = eval_adaptive.workloads(8192)
        results = evaluated
        for name, (a, b) in sets.items():
            if name in EVAL_SUBSET or name.startswith("fem-graded-"):
                results.append((name, *eval_adaptive.eval_workload(
                    name, a, b, dev, GATE_ROWS, say, element="dispatched")))
        say(eval_adaptive.report(results, 8192, card_name(dev)))
        for name, _, rows, verdict in results:
            (card, card_s), (parent, parent_s) = (
                verdict["densify"][k] for k in ("card", "parent"))
            say(f"{name}: densify's pick under the card's scorer {card} "
                f"({card_s:.3f} s host), under the parent's {parent} "
                f"({parent_s:.3f} s host); spada+densify rows: " + (", ".join(
                    f"{label} {fmt_ms(v[0])} ms"
                    for label, v in rows.items()
                    if label.startswith("spada+densify")) or "none"))
        blk = next(r for r in results if r[0] == "nn-bert-ffn1-blk32")
        require(any(label.startswith("spada+densify")
                    and isinstance(v[0], float) for label, v in
                    blk[2].items()), f"(c) nn-bert-ffn1-blk32: no "
                f"spada+densify row timed ({list(blk[2])})")
        fem = results[-1]
        require(fem[0].startswith("fem-graded-") and fem[3]["choice"]
                == "element", f"(c) {fem[0]}: dispatched to "
                f"{fem[3]['choice']}, not the element side")

    steps = (
        ("(a) probe_item_overhead, banded 32768^2", "tile_spgemm",
         lambda: probe_item_overhead.run(n=32768, device=dev, log=say)),
        ("(b) probe_dispatch_crossover, fills 48, 12; fill 192's tile side",
         "esc_stream_group",
         lambda: (probe_dispatch_crossover.run((48, 12), device=dev,
                                               log=say),
                  crossover_tile_only(192, dev, say))),
        (f"(c) eval_adaptive at n = 8192 (--quick), row sets "
         f"{', '.join(EVAL_SUBSET)} and the graded FEM", "tile_panel",
         quick_eval),
        ("(d) bench_value_refresh, 2 batches", "esc_stream_group",
         lambda: bench_value_refresh.run(dev, n_batches=2, log=say)),
    )
    for label, kernel, step in steps:
        t0 = time.perf_counter()
        log(f"  {label}:")
        with main_path(totals) as counts:
            step()
        log(f"  {label.split(',')[0]}: launches {counts}, "
            f"{time.perf_counter() - t0:.1f} s")
        require(counts.get("tile_spgemm", 0) > 0 and counts.get(kernel, 0)
                > 0, f"{label}: launches {counts}")
    log("  (e) phase 4's plans of the nn pair, under the card's fit and "
        "under the reference's per-item terms:")
    nn_plans_side_by_side(runs, nn_ref, extra)
    t0 = time.perf_counter()
    log("  (f) the card's terms, and the graded FEM's dispatch under them:")
    with main_path(totals) as counts:
        card_terms(dev, extra["thin_sweep"], say)
    log(f"  (f): launches {counts}, {time.perf_counter() - t0:.1f} s, on "
        f"{smi_name_power()}")
    require(counts.get("tile_spgemm", 0) > 0
            and counts.get("esc_stream_group", 0) > 0,
            f"(f): launches {counts}")
    t0 = time.perf_counter()
    log("  (g) the card's tile model against the measured times, and (h) "
        "the CLI's run against plan --card on cari:")
    with main_path(totals) as counts:
        cari_point = cari_run_is_plan_card(dev, say)
    model_residuals(runs, extra, evaluated, cari_point, say)
    log(f"  (g)-(h): launches {counts}, {time.perf_counter() - t0:.1f} s, "
        f"on {smi_name_power()}")
    require(counts.get("tile_spgemm", 0) > 0, f"(h): launches {counts}")


def cari_run_is_plan_card(dev, say) -> tuple:
    """Phase 10 (h): cari through the CLI's ``run`` and ``plan --card``
    under the card's profile: the tile edge and plan lines ``run`` prints
    (T, panels, tm histogram, the model's ms) must be the ones ``plan
    --card`` prints, and ``plan --card``'s panels the plan
    ``cli.plan_spada`` makes under the CLI's config.  Returns ("cari
    (CLI)", measured s, (the card model's s, the parent model's s)) for
    (g)."""
    import torch

    from spada_tpu_torch import cli
    from spada_tpu_torch.config import SpadaConfig, card_config
    from spada_tpu_torch.io.workloads import GemmWorkload
    from spada_tpu_torch.tools.eval_adaptive import models

    outs = {}
    for mode, extra_args in (("run", ["--no-result"]), ("plan", ["--card"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main([mode, "spada", "SS", "cari", "config/default.json",
                           "--device", str(dev), *extra_args])
        require(rc == 0, f"(h) cari {mode} exited {rc}")
        outs[mode] = out.getvalue().splitlines()

    def decisions(lines):
        return [ln for ln in lines if ln.startswith(("tile size:",
                                                     "plan[", "densify:"))]

    require(decisions(outs["run"]) == decisions(outs["plan"]),
            f"(h) run printed {decisions(outs['run'])}, plan --card "
            f"{decisions(outs['plan'])}")
    printed = [tuple(int(x) for x in re.match(
        r"\s+rows \[(\d+), (\d+)\)\s+tm=(\d+)", ln).groups())
        for ln in outs["plan"] if ln.strip().startswith("rows [")]
    config = card_config(SpadaConfig.from_json("config/default.json"),
                         torch.cuda.get_device_name(dev))
    w = GemmWorkload.from_suitesparse(config.ss_filepath, "cari")
    run = cli.plan_spada(w.a, w.b, config, dev, densify=True,
                         log=lambda s: None)
    want = [(p.row_start, p.row_end, p.tm) for p in run.plan.panels]
    require(printed == want[:20], f"(h) plan --card printed {printed}, "
            f"plan_spada planned {want}")
    ms = float(re.search(r"device perf: engine ([0-9.]+) ms",
                         "\n".join(outs["run"])).group(1))
    say(f"cari: run and plan --card print the same decisions "
        f"{decisions(outs['plan'])}; panels {want}; engine {ms:.4f} ms")
    return ("cari (CLI)", ms * 1e-3, models(run.a, run.b, run.plan,
                                            run.config))


def model_residuals(runs: dict, extra: dict, evaluated: list, cari_point,
                    say) -> None:
    """Phase 10 (g): the card model's t_est and the parent model's beside
    the measured ms on cari (the CLI), phase 4's two nn plans and every
    tile row of (c)'s eval, in one table with each model's median and
    largest |residual|."""
    from spada_tpu_torch.tools import eval_adaptive

    points = [cari_point]
    for label, run in runs.items():
        points.append((f"nn [{label}] T={run.config.tile_k} "
                       f"{run.plan.tm_histogram()}",
                       extra["nn_plans"][label]["perf_ms"] * 1e-3,
                       eval_adaptive.models(run.a, run.b, run.plan,
                                            run.config)))
    points += [(f"{name} (n = 8192) {label}", s, model)
               for name, _, rows, _ in evaluated
               for label, (s, _, model) in rows.items() if model is not None]
    points += sweep_points(extra["thin_sweep"])
    say(eval_adaptive.residual_table(points))


def sweep_points(thin_sweep) -> list:
    """Phase 4c's tile_spgemm cases as (g)'s points: each case's uniform
    plan under both models, the pair's counts taken once per panel
    height."""
    from spada_tpu_torch.config import h100_config
    from spada_tpu_torch.plan.card_model import (card_plan_cost, price_span,
                                                 span_counts)
    from spada_tpu_torch.plan.estimator import BTileStructure
    from spada_tpu_torch.tools.eval_adaptive import parent_config

    rows, (a, b) = thin_sweep
    bt = BTileStructure(b, 128, 128)      # phase 4c's T
    counts, points = {}, []
    for r in rows:
        if r["engine"] != "tile_spgemm":
            continue
        tm, dt = r["tm"], r["dtype"]
        if tm not in counts:
            counts[tm] = span_counts(a, 0, a.shape[0], tm, bt)
        cfg = h100_config(engine_dtype=dt)
        isz = 2 if dt == "bfloat16" else 4
        model = tuple(card_plan_cost([price_span(counts[tm], tm, bt, isz,
                                                 c)], c)[0]
                      for c in (cfg, parent_config(cfg)))
        points.append((f"sweep {dt} tm {tm}", r["ms"] * 1e-3, model))
    return points


def card_terms(dev, thin_sweep, say) -> None:
    """Phase 10 (f): the resident blocks the card reports for every item
    shape, beside ``config._TILE_RESIDENT`` and ``_TILE_SMS`` (a record no
    config carries); the planner's terms ``h100_config`` carries (the
    per-T overheads, acc and fixed per tile dtype, the element path's
    fixed term), the thin points of phase 4c's tile_spgemm cases beside
    the recorded ones, and the graded FEM at 129 edges (the full eval's size)
    through ``eval_adaptive`` with both sides timed and its dispatch
    verdict."""
    from spada_tpu_torch.config import (_THIN_FIT, _TILE_RESIDENT,
                                        _TILE_SMS, h100_config)
    from spada_tpu_torch.io.workloads import fem_q1_graded_csr
    from spada_tpu_torch.tools import eval_adaptive, probe_item_overhead
    from spada_tpu_torch.tools.harness import card_name

    name = card_name(dev)
    # the resident blocks the card reports, beside the record (which no
    # config carries: it is printed, not required)
    now = probe_item_overhead.run_resident(device=dev, log=say)
    differ = {dt: {k: (v, _TILE_RESIDENT[dt].get(k))
                   for k, v in now[dt].items()
                   if _TILE_RESIDENT[dt].get(k) != v}
              for dt in ("float32", "bfloat16")}
    say(f"resident blocks on {now['sms']} SMs "
        + ("as config._TILE_RESIDENT / _TILE_SMS record them"
           if now["sms"] == _TILE_SMS and not any(differ.values()) else
           f"differ from the record ({_TILE_SMS} SMs; (card's, recorded): "
           f"{differ})"))
    rows, (a, b) = thin_sweep
    now = probe_item_overhead.thin_points(rows, a, b, name)
    for dt in ("float32", "bfloat16"):
        cfg = h100_config(name, engine_dtype=dt)
        say(f"{dt}: per-T overhead {cfg.engine_item_overhead_s}; acc "
            f"{cfg.engine_acc_s_per_elem:.4e} s per element, fixed "
            f"{cfg.engine_item_fixed_s * 1e9:.2f} ns; element_fixed_s "
            f"{cfg.element_fixed_s * 1e6:.3f} us; the tile model's launch "
            f"{cfg.tile_launch_s * 1e6:.3f} us, L2 "
            f"{cfg.tile_l2_bytes_per_s / 1e12:.2f} TB/s over "
            f"{cfg.tile_l2_bytes >> 20} MiB, {len(cfg.tile_item_s)} item "
            f"and {len(cfg.tile_item_latency_s)} latency points")
        say("thin overheads ns, recorded / phase 4c's run: " + ", ".join(
            f"tm {tm} {o * 1e9:.2f} / {now[dt][(tm, tn)][0] * 1e9:.2f}"
            for (tm, tn), (o, _) in _THIN_FIT[dt].items()))
    edges = eval_adaptive.fem_edges(16384)
    fem = fem_q1_graded_csr(edges, edges, dtype=np.float32)
    _, _, verdict = eval_adaptive.eval_workload(
        f"fem-graded-{edges}", fem, fem, dev, GATE_ROWS, say)
    require(verdict["choice"] == "element",
            f"(f) the graded FEM dispatched to {verdict['choice']}")


def nn_plans_side_by_side(runs: dict, nn_ref, extra: dict) -> None:
    """Phase 10 (e): phase 4's two plans of the nn pair, and each densify
    scorer's pick and host seconds on it."""
    rows = nn_ref.shape[0]
    for label, run in runs.items():
        p = extra["nn_plans"][label]
        log(f"    {label:9s}: T={run.config.tile_k}, tm histogram "
            f"{run.plan.tm_histogram()}, W={run.result.n_work_items}, "
            f"blocks {p['blocks']}, measure_device_perf {p['perf_ms']:.3f} "
            f"ms, gate {relerr(run.result.todense()[:rows], nn_ref):.1e}")
    fit, v5e = (extra["nn_plans"][k]["perf_ms"] for k in NN_PLANS)
    log(f"    the fitted plan takes {fit / v5e:.3f}x the v5e-terms plan's "
        f"time, on {smi_name_power()}")
    # each densify scorer on the pair at the fit's T: the layout and the
    # host seconds (the card's scorer is what the uniform path and ``run``
    # take under h100_config)
    from spada_tpu_torch.plan.card_densify import densify_for
    from spada_tpu_torch.tools.eval_adaptive import parent_config

    run = runs[NN_PLANS[0]]
    cfg, T = run.config, run.config.tile_k
    for who, c in (("card", cfg), ("reference", parent_config(cfg))):
        t0 = time.perf_counter()
        pick = densify_for(c)(run.a, run.b, T, c)
        log(f"    densify at T={T} under the {who}'s scorer: "
            f"{'identity' if pick.is_identity else pick.candidate} in "
            f"{time.perf_counter() - t0:.3f} s host")


# --------------------------------------------------------------------------
# phase 11: the last two reference tools
# --------------------------------------------------------------------------

#: the rank counts of phase 11 (b)'s rank bodies at the tool's full size,
#: cut to D <= 4: with D = 8 the phase took 63.2 s on an NVIDIA H100 80GB
#: HBM3 at 700 W (the rank-body part 25.9 s, against 12.0 s at D <= 4),
#: over its 60 s budget, so D = 8's row comes from a run of the tool
SCALING_CARD_DEVICES = (1, 2, 4)


def run_reference_tools(dev, totals: dict) -> None:
    """Phase 11: (a) ``probe_op`` at the tool's size, both tile dtypes;
    (b) ``eval_scaling``: the functional gloo groups at ``--quick`` size,
    then every rank body at full size on this card, and the table."""
    from spada_tpu_torch.config import h100_config
    from spada_tpu_torch.tools import eval_scaling, probe_op
    from spada_tpu_torch.tools.harness import card_name

    def say(s):
        for line in s.splitlines() or [""]:
            log("    " + line)

    t0 = time.perf_counter()
    log("  (a) probe_op, banded 16384^2, band 384, T = 384, bf16 and f32 "
        "tiles:")
    with main_path(totals) as counts:
        res = probe_op.run(device=dev, log=say)
    for dt, r in res.items():
        require(r["op_device"].startswith("cuda"),
                f"probe_op {dt}: the op path ran on {r['op_device']}")
    require(counts.get("tile_spgemm", 0) > 0,
            f"probe_op: the row schedule launched {counts}")
    log(f"  (a) probe_op: launches {counts}, "
        f"{time.perf_counter() - t0:.1f} s")
    name = card_name(dev)
    config = h100_config(name)
    t0 = time.perf_counter()
    log(f"  (b) eval_scaling, functional at --quick size, D = "
        f"{list(eval_scaling.DEVICES)}:")
    eval_scaling.functional([eval_scaling.point(D, eval_scaling.QUICK,
                                                config)
                             for D in eval_scaling.DEVICES], log=say)
    log(f"  (b) functional: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    log(f"  (b) eval_scaling, rank bodies at full size on the card, D = "
        f"{list(SCALING_CARD_DEVICES)} (cut from the tool's D = "
        f"{list(eval_scaling.DEVICES)}: with D = 8 the phase takes about "
        f"63 s, over its 60 s budget; the full table is the tool's own "
        f"run):")
    with main_path(totals) as counts:
        rows = eval_scaling.card(
            (eval_scaling.point(D, eval_scaling.FULL, config)
             for D in SCALING_CARD_DEVICES), dev, config, say)
    require(counts.get("tile_spgemm", 0) > 0,
            f"eval_scaling: the rank bodies launched {counts}")
    say(eval_scaling.table(rows, eval_scaling.FULL, config, name))
    log(f"  (b) rank bodies: launches {counts}, "
        f"{time.perf_counter() - t0:.1f} s, on {smi_name_power()}")


def check_no_reference(where: str) -> None:
    require("jax" not in sys.modules and "jaxlib" not in sys.modules,
            f"{where}: JAX was imported")
    ref_mods = sorted(m for m in sys.modules
                      if m == "spada_tpu" or m.startswith("spada_tpu."))
    require(not ref_mods, f"{where}: modules of the JAX package were "
            f"loaded: {ref_mods}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs a CUDA device")
    t_start = time.perf_counter()
    os.chdir(ROOT)
    from spada_tpu_torch import _build
    from spada_tpu_torch.config import h100_config

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_name_power()

    log("== phase 1: environment")
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {kind}  "
        f"count {torch.cuda.device_count()}")
    log(f"  nvidia-smi: {smi}")
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    log("  nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    _build.load()
    log(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    for line in (_build.build_log or "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("    " + line.strip())
    check_tensor_cores()

    errs = dict.fromkeys(("tile_spgemm", "tile_spgemm_thin", "tile_stream",
                          "tile_stream_thin", "tile_panel", "tile_panel_thin",
                          "tile_grid", "tile_grid_thin", "esc_stream_mul",
                          "esc_stream_red",
                          "esc_stream_group", "tile_probe", "tile_probe_mma",
                          "esc_stream_mul_blocked",
                          "esc_stream_red_blocked"), 0.0)
    totals: dict = {}
    times: dict = {}
    extra: dict = {}
    log("== phase 2: kernels vs plain PyTorch versions (TF32 off)")
    check_kernels(dev, errs)
    log("== phase 3: cari through the port's CLI")
    for engine in (None, *ENGINE_KERNEL):
        run_cari(dev, totals, engine)
    run_cari(dev, totals, scheme="profiled")
    run_cari_plans(dev, totals)
    cfg = h100_config(kind)
    log(f"== phase 4: nn pair, tile side (roofline profile: "
        f"{cfg.hbm_bytes_per_s / 1e12:.2f} TB/s, "
        f"{cfg.peak_flops_f32 / 1e12:.0f} TFLOP/s f32, datasheet)")
    nn_runs, nn_c, nn_ref = run_nn(dev, kind, totals, errs, times, extra)
    nn_run = nn_runs[NN_PLANS[0]]
    log("== phase 4b: spgemm_csr on the nn pair, in output slabs")
    run_spgemm_csr(dev, nn_run, nn_ref, totals)
    log("== phase 4c: the thin-panel sweep (the four tile kernels, T = 128, "
        "tm 8-128)")
    run_thin_sweep(dev, totals, errs, times, extra)
    log("== phase 5: locpl pair, element side")
    run_locpl(dev, cfg, totals, errs, times, extra)
    log("== phase 6: nn pair under each engine override, phase 4's plans")
    run_engines(dev, nn_runs, nn_c, nn_ref, totals, errs, times, extra)
    log("== phase 7: the probes (spada_tpu_torch.tools)")
    t0 = time.perf_counter()
    run_probes(dev, totals, errs, times, extra)
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s")
    log("== phase 8: the sparse MLP (spada_tpu_torch.models.sparse_nn)")
    t0 = time.perf_counter()
    run_sparse_mlp(dev)
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s")
    log("== phase 9: the distributed strategies (spada_tpu_torch.parallel)")
    t0 = time.perf_counter()
    run_distributed(dev, kind, nn_run, nn_c, nn_ref, totals)
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    log("== phase 10: the planner's calibration and evaluation "
        "(spada_tpu_torch.tools)")
    t0 = time.perf_counter()
    run_calibration(dev, nn_runs, nn_ref, extra, totals)
    del nn_runs, nn_run, nn_c, nn_ref
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s")
    log("== phase 11: the last two reference tools (probe_op, "
        "eval_scaling)")
    t0 = time.perf_counter()
    run_reference_tools(dev, totals)
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s")

    check_no_reference("chip_smoke")
    # kernel -> (source, the TPU kernels it carries, bound/library key)
    sources = {"tile_spgemm": ("spada_tpu_torch/csrc/tile_spgemm.cu",
                               "spada_tpu/ops/engine.py:726, "
                               "tools/probe_panel3d.py:101", "nn"),
               "tile_spgemm_thin": ("spada_tpu_torch/csrc/tile_spgemm.cu",
                                    "spada_tpu/ops/engine.py:726",
                                    "tile_spgemm_thin"),
               "tile_stream": ("spada_tpu_torch/csrc/tile_stream.cu",
                               "spada_tpu/ops/engine.py:363", "nn"),
               "tile_stream_thin": ("spada_tpu_torch/csrc/tile_stream.cu",
                                    "spada_tpu/ops/engine.py:363",
                                    "tile_stream_thin"),
               "tile_panel": ("spada_tpu_torch/csrc/tile_panel.cu",
                              "spada_tpu/ops/engine.py:1275, "
                              "tools/probe_panel3d.py:101", "nn"),
               "tile_panel_thin": ("spada_tpu_torch/csrc/tile_panel.cu",
                                   "spada_tpu/ops/engine.py:1275",
                                   "tile_panel_thin"),
               "tile_grid": ("spada_tpu_torch/csrc/tile_grid.cu",
                             "spada_tpu/ops/engine.py:199", "nn"),
               "tile_grid_thin": ("spada_tpu_torch/csrc/tile_grid.cu",
                                  "spada_tpu/ops/engine.py:199",
                                  "tile_grid_thin"),
               "esc_stream_mul": ("spada_tpu_torch/csrc/esc_stream.cu",
                                  "spada_tpu/ops/element_stream.py:168",
                                  "esc_stream_mul"),
               "esc_stream_red": ("spada_tpu_torch/csrc/esc_stream.cu",
                                  "spada_tpu/ops/element_stream.py:184",
                                  "esc_stream_red"),
               "esc_stream_group": ("spada_tpu_torch/csrc/esc_stream.cu",
                                    "spada_tpu/ops/element_stream.py:168, "
                                    "spada_tpu/ops/element_stream.py:184",
                                    "esc_stream_group"),
               "esc_stream_mul_blocked": (
                   "spada_tpu_torch/csrc/esc_stream.cu",
                   "tools/probe_pallas_stream.py:65",
                   "esc_stream_mul_blocked"),
               "esc_stream_red_blocked": (
                   "spada_tpu_torch/csrc/esc_stream.cu",
                   "tools/probe_pallas_stream.py:111",
                   "esc_stream_red_blocked"),
               "tile_probe": ("spada_tpu_torch/csrc/tile_probe.cu",
                              "tools/probe_kernel.py:153, "
                              "tools/probe_manual.py:375", "tile_probe"),
               "tile_probe_mma": (
                   "spada_tpu_torch/csrc/tile_probe_mma.cuh",
                   "tools/probe_kernel.py:153, tools/probe_manual.py:375",
                   "tile_probe")}
    kernels = []
    for name, (src, replaces, key) in sources.items():
        require(totals.get(name, 0) > 0, f"{name} never ran on the main path")
        (b_s, by), (lib_s, _) = extra[key]["bound"], extra[key]["library"]
        require(lib_s is not None, f"{name}: no library time")
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": totals[name],
                        "max_abs_err": errs[name],
                        "ms": times[name][0] * 1e3,
                        "plain_ms": times[name][1] * 1e3,
                        "bound_ms": b_s * 1e3, "bound_by": by,
                        "library_ms": lib_s * 1e3})
    lib_nn, lib_name = extra["nn"]["library"]
    log(f"== the four tile kernels on nn, phase 4's plans (the kernels "
        f"line holds the {NN_PLANS[0]} plan's); library {lib_name} "
        f"{lib_nn * 1e3:.3f} ms")
    for label, p in extra["nn_plans"].items():
        b_s, by = p["bound"]
        log(f"  [{label}] blocks {p['blocks']}; bound {b_s * 1e3:.3f} ms "
            f"({by})")
        for name in ("tile_spgemm", *ENGINE_KERNEL.values()):
            k_s, p_s = p["times"][name]
            log(f"    {name}: {k_s * 1e3:.3f} ms ({b_s / k_s:.1%} of the "
                f"bound), plain {p_s * 1e3:.3f} ms")
    log(f"== chip_smoke took {time.perf_counter() - t_start:.1f} s, the "
        f"kernels' build included")
    log(json.dumps({"kernels": kernels}))
    log(smi_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
