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
   (``cuobjdump -sass``): a kernel with none, or a toolkit without
   cuobjdump, fails the run;
2. each kernel against its plain PyTorch version on the card
   (``tile_spgemm``, both block shapes, and ``tile_stream`` with ogroup 1
   and 8, ``tile_panel`` with f32 and bf16 output, ``tile_grid``:
   max|d|/max|ref| <= 1e-5, the bf16 output its own f32 output rounded
   once and within one bf16 ulp plus 1e-5 of max|ref| of the plain value,
   empty runs exact zeros; ``esc_stream_mul`` bitwise; ``esc_stream_red``: <= 1e-6);
3. ``cari`` through the port's CLI, equal to scipy (rtol 1e-4, atol 1e-3),
   once on the auto engine (``tile_spgemm``) and once under each
   ``--engine streaming | panel | pallas_grid``, each launching its kernel
   and not ``tile_spgemm``;
4. the NN pair (16384^2 block-sparse weight x 16384x4096 ReLU activations,
   f32): dispatched to the tile kernel, gated against scipy/numpy on its
   first 2048 rows (max|d|/max|ref| < 1e-4), kernel and plain version timed
   on the launches the run made;
5. the localized power-law pair (65536^2, degree 32): dispatched to the
   element kernels, gated against scipy on 2048 rows (< 1e-3), timed;
6. the engine override at full width: phase 4's plan of the NN pair run
   again through ``spgemm(..., plan=)`` under each ``engine`` streaming,
   panel and pallas_grid, gated against scipy/numpy (< 1e-4) and against
   phase 4's ``tile_spgemm`` result (<= 1e-5), each kernel timed beside its
   plain version on the launches the run made (``tile_stream`` also at
   ogroup 1 against 8, in one timing);
7. the probes (``spada_tpu_torch.tools``) at their tools' sizes: every mode
   of ``tile_probe`` on the banded 65536^2 / T=256 / bf16 workload of
   ``probe_kernel`` and ``probe_manual`` (modes that write zeros or nothing
   bitwise equal to their plain versions, the rest, full and flat among
   them, within 1e-5 of max|C|), ``probe_panel3d`` (``tile_spgemm`` and
   ``tile_panel`` on runs of two slot tiles, 1e-5; its library call one
   ``torch.bmm`` of the gathered run pairs) and
   ``probe_pallas_stream`` (the stream kernels as the main path launches
   them and, through their probe-only entry points, at the TPU's block
   sizes: mul bitwise, red 1e-6), each mode timed beside its bound.

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
banded pair), ``torch.mul`` and ``torch.linalg.vecdot`` for the stream
kernels.

Every kernel wrapper counts its launches; the counts are cleared right
before each main-path run and read right after it.  The script prints one
JSON line with each kernel's numbers, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is not 0 and no result line is printed; so does a machine without a
CUDA device, and a run that loaded JAX or any module of ``spada_tpu``.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
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


def host_enqueue_s(fn, reps: int = 5) -> float:
    """Host seconds one call of ``fn`` takes to enqueue its device work."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return dt


#: the kernels that must run on tensor cores: the wide path of the four
#: main-path tile kernels (csrc/tile_mma.cuh)
MMA_KERNELS = ("tile_spgemm_mma", "tile_stream_mma", "tile_panel_mma",
               "tile_grid_mma")


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
    from spada_tpu_torch.ops.engine import run_worklist_reference, tile_spgemm

    rng = np.random.default_rng(0)
    runs = np.array([3, 0, 1, 4, 2, 0])     # items per C tile; 0 = empty run
    n_c, w = len(runs), int(runs.sum())
    o_ids = np.repeat(np.arange(n_c), runs).astype(np.int32)
    empty = torch.from_numpy(runs == 0)
    for tk in (128, 512):
        for tm in (8, 32, 64, 128, 512):
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
                log(f"  tile_spgemm tm={tm:3d} tk=tn={tk} "
                    f"{str(dtype)[6:]:8s} max|d|/max|ref|={err:.2e}")
                require(err <= 1e-5, f"tile_spgemm tm={tm} tk={tk} {dtype}: "
                        f"relerr {err:.3e} > 1e-5")
                require(bool((got[empty.to(dev)] == 0).all()),
                        "tile_spgemm: an empty run gave a nonzero tile")
                errs["tile_spgemm"] = max(errs["tile_spgemm"],
                                          float(np.abs(g - r).max()))

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


def bf16_ulp(x):
    """The spacing of bf16 numbers at each value of ``x`` (bf16 values in a
    float32 tensor); 0 where ``x`` is 0."""
    import torch

    e = torch.floor(torch.log2(x.abs().clamp_min(1e-38)))
    return torch.where(x == 0, torch.zeros_like(x), torch.exp2(e - 7))


def check_engine_kernels(dev, errs: dict, rng) -> None:
    """tile_stream, tile_panel and tile_grid against their plain versions
    on random worklists with empty runs, and for ogroup 8 a whole group
    with no items (C tiles 8-15) and a last group of two C tiles."""
    import torch

    from spada_tpu_torch.convert import item_ptr_of, tile_ptr_of
    from spada_tpu_torch.ops import engine as E

    runs = np.array([3, 0, 1, 4, 2, 0, 0, 0] + [0] * 8 + [2, 1])
    n_c, w = len(runs), int(runs.sum())
    o_np = np.repeat(np.arange(n_c), runs).astype(np.int32)
    empty = torch.from_numpy(runs == 0).to(dev)

    def ids(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

    o, tp = ids(o_np), ids(tile_ptr_of(o_np, n_c))
    for tk in (128, 512):
        for tm in (8, 32, 64, 128, 512):
            for dtype in (torch.float32, torch.bfloat16):
                a = torch.from_numpy(rng.standard_normal(
                    (5, tm, tk), np.float32)).to(dev, dtype)
                b = torch.from_numpy(rng.standard_normal(
                    (4, tk, tk), np.float32)).to(dev, dtype)
                ai, bi = ids(rng.integers(0, 5, w)), ids(rng.integers(0, 4, w))
                a_t = a.transpose(1, 2).contiguous()
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
                p16 = p16.float()
                line = []
                for label, name, got, ref in cases:
                    err = relerr(got.cpu().numpy(), ref.cpu().numpy())
                    line.append(f"{label} {err:.1e}")
                    require(err <= 1e-5, f"{label} tm={tm} tk={tk} {dtype}: "
                            f"relerr {err:.3e} > 1e-5")
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
                        f"tile_panel bf16 out tm={tm} tk={tk} {dtype}: "
                        f"{float((gap / bar).max()):.2f} x the bar")
                require(bool((p16[empty] == 0).all()),
                        "tile_panel bf16 out: an empty run gave a nonzero "
                        "tile")
                log(f"  tm={tm:3d} tk=tn={tk} {str(dtype)[6:]:8s} "
                    f"max|d|/max|ref|: {', '.join(line)}; tile_panel bf16 "
                    f"out: max {ulps:.2f} ulp of the plain value, "
                    f"{int((gap > bf16_ulp(r16)).sum())} values over 1 ulp")


# --------------------------------------------------------------------------
# phase 3: cari through the CLI
# --------------------------------------------------------------------------

#: the kernel each --engine override runs
ENGINE_KERNEL = {"streaming": "tile_stream", "panel": "tile_panel",
                 "pallas_grid": "tile_grid"}


def run_cari(dev, totals: dict, engine=None) -> None:
    import scipy.io

    from spada_tpu_torch import cli

    argv = ["run", "spada", "SS", "cari", "config/default.json",
            "--device", str(dev), "--no-result"]
    if engine:
        argv += ["--engine", engine]
    kernel = ENGINE_KERNEL.get(engine, "tile_spgemm")
    with main_path(totals) as counts:
        c = cli.execute(argv)
    a = scipy.io.mmread(os.path.join(ROOT, "matrices", "cari.mtx")).tocsr()
    b = a if a.shape[0] == a.shape[1] else a.T.tocsr()
    ref = (a @ b).toarray()
    ok = np.allclose(c.todense(), ref, rtol=1e-4, atol=1e-3)
    log(f"  engine {engine or 'auto'}: launches {counts}; C vs scipy: "
        f"allclose(rtol=1e-4, atol=1e-3) = {ok}, max|d|/max|ref| = "
        f"{relerr(c.todense(), ref):.2e}")
    require(ok, f"cari under engine {engine} differs from scipy")
    require(counts.get(kernel, 0) > 0, f"cari did not launch {kernel}")
    require(engine is None or counts.get("tile_spgemm", 0) == 0,
            f"cari under --engine {engine} launched tile_spgemm")


# --------------------------------------------------------------------------
# phase 4: the tile side at the bench's size
# --------------------------------------------------------------------------

def run_nn(dev, cfg, totals: dict, errs: dict, times: dict, extra: dict,
           m: int = 16384, n: int = 4096):
    """Returns the run, its dense C and the f64 reference of C's first
    rows, for phase 6."""
    import torch

    from spada_tpu_torch.cli import run_spada
    from spada_tpu_torch.config import roofline_bound, tile_work
    from spada_tpu_torch.convert import worklist_to_torch
    from spada_tpu_torch.ops.engine import run_worklist_reference, tile_spgemm
    from spada_tpu_torch.io.workloads import (block_sparse_csr,
                                              relu_activation_csr)

    t0 = time.perf_counter()
    a = block_sparse_csr(m, m, 384, 0.2, seed=5, dtype=np.float32)
    b = relu_activation_csr(m, n, 0.35, seed=6, dtype=np.float32)
    log(f"  A {a.shape} nnz {a.nnz}, B {b.shape} nnz {b.nnz} "
        f"(generated in {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    with main_path(totals) as counts:
        run = run_spada(a, b, cfg, dev, log=lambda s: log("  " + s))
    log(f"  run_spada: {time.perf_counter() - t0:.1f} s host+device, "
        f"engine {run.choice}, launches {counts}")
    require(run.choice == "tile", f"nn dispatched to {run.choice}, not tile")
    require(counts.get("tile_spgemm", 0) > 0, "nn did not launch tile_spgemm")

    rows = min(GATE_ROWS, m)
    got = run.result.todense()[:rows]
    ref = (a.to_scipy()[:rows].toarray().astype(np.float64)
           @ b.to_scipy().toarray().astype(np.float64))
    err = relerr(got, ref)
    log(f"  gate vs scipy/numpy f64, rows [0, {rows}): "
        f"max|d|/max|ref| = {err:.2e} (limit 1e-4)")
    require(err < 1e-4, f"nn gate failed: relerr {err:.3e}")

    t_kernel = t_plain = 0.0
    bounds = []
    kind = torch.cuda.get_device_name(dev)
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
        require(e <= 1e-5, f"nn segment tm={tm}: kernel vs plain {e:.3e}")
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
        log(f"  segment tm={tm} tk=tn={tk}: W={wl.n_items} nC={wl.n_c_tiles}"
            f", {flops / 1e9:.1f} GFLOP of products in "
            f"{tile_flops / 1e9:.1f} of whole tiles, {nbytes / 1e9:.3f} GB"
            f"  kernel {tk_s * 1e3:.3f} ms ({tile_flops / tk_s / 1e12:.2f} "
            f"tile TFLOP/s)  plain {tp_s * 1e3:.3f} ms "
            f"({tile_flops / tp_s / 1e12:.2f})  bound {b_s * 1e3:.3f} ms "
            f"({by})  kernel vs plain max|d|/max|ref| {e:.2e}")
        t_kernel += tk_s
        t_plain += tp_s
        del a_t, b_t, dwl
    times["tile_spgemm"] = (t_kernel, t_plain)
    c = run.result.todense()
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
    # the four tile kernels compute this same C from these same inputs; the
    # bound is the sum of the segments', bound by what bounds the larger
    extra["nn"] = {"bound": (sum(s for s, _ in bounds), max(bounds)[1]),
                   "library": (t_lib, "torch.matmul, dense f32")}
    torch.cuda.empty_cache()
    return run, c, ref


# --------------------------------------------------------------------------
# phase 5: the element side at the bench's size
# --------------------------------------------------------------------------

def run_locpl(dev, cfg, totals: dict, errs: dict, times: dict, extra: dict,
              m: int = 65536, deg: float = 32.0) -> None:
    import torch

    from spada_tpu_torch.cli import run_spada
    from spada_tpu_torch.config import roofline_bound, stream_work
    from spada_tpu_torch.convert import stream_operands_to_torch
    from spada_tpu_torch.ops.element_stream import (esc_stream_mul,
                                                    esc_stream_mul_reference,
                                                    esc_stream_red,
                                                    esc_stream_red_reference,
                                                    stream_operands)
    from spada_tpu_torch.io.workloads import localized_powerlaw_csr
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
    require(counts.get("esc_stream_mul", 0) > 0
            and counts.get("esc_stream_red", 0) > 0,
            "locpl did not launch both stream kernels")

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
    ones = [i for i, c in enumerate(layout.classes) if c["L"] == 1]
    reds = [i for i, c in enumerate(layout.classes) if c["L"] > 1]
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
                    f"{name} class L={layout.classes[i]['L']}: {rel:.3e}")
            errs[name] = max(errs[name], e)
        work = [stream_work(layout.classes[i]["L"], layout.classes[i]["n_pad"])
                for i in idx]
        flops, nbytes = (sum(w[j] for w in work) for j in (0, 1))

        def kernel_all():
            return [kern(*ops[i]) for i in idx]

        def plain_all():
            return [plain_fn(*ops[i]) for i in idx]

        def library_all():
            return [library(*ops[i]) for i in idx]

        t_k, t_p = time_pair(kernel_all, plain_all)
        t_l, _ = cuda_time(library_all, warmup=1, reps=10)
        h_k = host_enqueue_s(kernel_all) / len(idx)
        h_p = host_enqueue_s(plain_all) / len(idx)
        b_s, by = roofline_bound(flops, nbytes, kind)
        log(f"  {name}: {len(idx)} classes, {nbytes / 1e9:.3f} GB  kernel "
            f"{t_k * 1e3:.3f} ms ({nbytes / t_k / 1e9:.0f} GB/s)  plain "
            f"{t_p * 1e3:.3f} ms ({nbytes / t_p / 1e9:.0f} GB/s)  library "
            f"{lib_name} {t_l * 1e3:.3f} ms  bound {b_s * 1e3:.3f} ms ({by})"
            f"  host enqueue per class: kernel {h_k * 1e6:.1f} us, plain "
            f"{h_p * 1e6:.1f} us")
        times[name] = (t_k, t_p)
        extra[name] = {"bound": (b_s, by), "library": (t_l, lib_name)}
    del ops
    torch.cuda.empty_cache()


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


def run_engines(dev, run, c_tile, ref_rows, totals: dict, errs: dict,
                times: dict) -> None:
    import dataclasses

    import torch

    from spada_tpu_torch.ops.spgemm import spgemm

    rows = ref_rows.shape[0]
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

        t_kernel = t_plain = 0.0
        t_og = [0.0, 0.0]  # tile_stream at ogroup 1 and 8
        tk, tn = res.host_state["tk"], res.host_state["tn"]
        for wl, a_np, b_np, tm in res.host_state["segments"]:
            a_t = torch.from_numpy(a_np).to(dev)
            b_t = torch.from_numpy(b_np).to(dev)
            kernel_fn, plain_fn = engine_pair(engine, a_t, b_t, wl, dev)
            g, r = kernel_fn(), plain_fn()
            r_np = r.cpu().numpy()
            e = relerr(g.cpu().numpy(), r_np)
            require(e <= 1e-5, f"{kernel} nn segment tm={tm}: kernel vs "
                    f"plain {e:.3e}")
            errs[kernel] = max(errs[kernel], float((g - r).abs().max()))
            del g, r
            tk_s, tp_s = time_pair(kernel_fn, plain_fn)
            flops = 2 * wl.n_items * tm * tk * tn
            log(f"  {kernel} segment tm={tm} tk=tn={tk}: W={wl.n_items} "
                f"nC={wl.n_c_tiles}  kernel {tk_s * 1e3:.3f} ms "
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
                    require(e_k <= 1e-5, f"tile_stream ogroup {k} nn "
                            f"segment tm={tm}: kernel vs plain {e_k:.3e}")
                t1, t8 = time_pair(*og)
                t_og[0] += t1
                t_og[1] += t8
                log(f"  tile_stream segment tm={tm}: ogroup 1 {t1 * 1e3:.3f}"
                    f" ms ({flops / t1 / 1e12:.2f} TFLOP/s), ogroup 8 "
                    f"{t8 * 1e3:.3f} ms ({flops / t8 / 1e12:.2f} TFLOP/s)")
                del og
            del a_t, b_t, r_np, kernel_fn, plain_fn
        times[kernel] = (t_kernel, t_plain)
        if engine == "streaming":
            log(f"  tile_stream on nn, one timing: ogroup 1 "
                f"{t_og[0] * 1e3:.3f} ms, ogroup 8 {t_og[1] * 1e3:.3f} ms")
        torch.cuda.empty_cache()


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
    from spada_tpu_torch.tools.tile_probe import probe_work, run_modes

    t0 = time.perf_counter()
    work = probe_work(65536, 384, 256, dev)
    log(f"  banded 65536^2 band 384, T=256 bf16 tiles built in "
        f"{time.perf_counter() - t0:.1f} s")
    sub_log = lambda s: log("  " + s)  # noqa: E731
    with main_path(totals) as counts:
        log(" probe_kernel, all modes:")
        res_k = run_modes(work, probe_kernel.ALL_MODES, log=sub_log)
        log(" probe_manual, all modes:")
        res_m = run_modes(work, probe_manual.ALL_MODES, log=sub_log)
        log(" probe_panel3d:")
        res_p = probe_panel3d.run(device=dev, log=sub_log)
        log(" probe_pallas_stream:")
        res_s = probe_pallas_stream.run(device=dev, log=sub_log)
    log(f"  launches {counts}")
    for k in ("tile_probe", "tile_spgemm", "tile_panel", "esc_stream_mul",
              "esc_stream_red", "esc_stream_mul_blocked",
              "esc_stream_red_blocked"):
        require(counts.get(k, 0) > 0, f"the probes did not launch {k}")

    modes = {**res_k, **res_m}
    for mode, rec in modes.items():
        if rec["exact"] is not None:
            require(rec["exact"], f"tile_probe {mode}: not bitwise its "
                    f"plain version")
        require(rec["relerr"] <= PROBE_TILE_TOL, f"tile_probe {mode}: "
                f"relerr {rec['relerr']:.3e} > {PROBE_TILE_TOL}")
        errs["tile_probe"] = max(errs["tile_probe"], rec["max_abs_err"])
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
    # the JSON rows of the probe's own launches: the TPU's first block
    for name, label, lib in (
            ("esc_stream_mul_blocked", "mul br=1024", "torch.mul"),
            ("esc_stream_red_blocked", "red2 chl=1048576",
             "torch.linalg.vecdot(dim=0)")):
        rec = res_s[label]
        errs[name] = max(errs[name], rec["max_abs_err"])
        times[name] = (rec["ms"] * 1e-3, rec["plain_ms"] * 1e-3)
        extra[name] = {"bound": (rec["bound_ms"] * 1e-3, rec["bound_by"]),
                       "library": (rec["library_ms"] * 1e-3, lib)}

    full = res_k["full"]
    times["tile_probe"] = (full["ms"] * 1e-3, full["plain_ms"] * 1e-3)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs a CUDA device")
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

    errs = dict.fromkeys(("tile_spgemm", "tile_stream", "tile_panel",
                          "tile_grid", "esc_stream_mul", "esc_stream_red",
                          "tile_probe", "esc_stream_mul_blocked",
                          "esc_stream_red_blocked"), 0.0)
    totals: dict = {}
    times: dict = {}
    extra: dict = {}
    log("== phase 2: kernels vs plain PyTorch versions (TF32 off)")
    check_kernels(dev, errs)
    log("== phase 3: cari through the port's CLI")
    for engine in (None, *ENGINE_KERNEL):
        run_cari(dev, totals, engine)
    cfg = h100_config(kind)
    log(f"== phase 4: nn pair, tile side (roofline profile: "
        f"{cfg.hbm_bytes_per_s / 1e12:.2f} TB/s, "
        f"{cfg.peak_flops_f32 / 1e12:.0f} TFLOP/s f32, datasheet)")
    nn_run, nn_c, nn_ref = run_nn(dev, cfg, totals, errs, times, extra)
    log("== phase 5: locpl pair, element side")
    run_locpl(dev, cfg, totals, errs, times, extra)
    log("== phase 6: nn pair under each engine override, phase 4's plan")
    run_engines(dev, nn_run, nn_c, nn_ref, totals, errs, times)
    del nn_run, nn_c, nn_ref
    log("== phase 7: the probes (spada_tpu_torch.tools)")
    t0 = time.perf_counter()
    run_probes(dev, totals, errs, times, extra)
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s")

    require("jax" not in sys.modules and "jaxlib" not in sys.modules,
            "JAX was imported")
    ref_mods = sorted(m for m in sys.modules
                      if m == "spada_tpu" or m.startswith("spada_tpu."))
    require(not ref_mods, f"modules of the JAX package were loaded: "
            f"{ref_mods}")
    # kernel -> (source, the TPU kernels it carries, bound/library key)
    sources = {"tile_spgemm": ("spada_tpu_torch/csrc/tile_spgemm.cu",
                               "spada_tpu/ops/engine.py:726, "
                               "tools/probe_panel3d.py:101", "nn"),
               "tile_stream": ("spada_tpu_torch/csrc/tile_stream.cu",
                               "spada_tpu/ops/engine.py:363", "nn"),
               "tile_panel": ("spada_tpu_torch/csrc/tile_panel.cu",
                              "spada_tpu/ops/engine.py:1275, "
                              "tools/probe_panel3d.py:101", "nn"),
               "tile_grid": ("spada_tpu_torch/csrc/tile_grid.cu",
                             "spada_tpu/ops/engine.py:199", "nn"),
               "esc_stream_mul": ("spada_tpu_torch/csrc/esc_stream.cu",
                                  "spada_tpu/ops/element_stream.py:168",
                                  "esc_stream_mul"),
               "esc_stream_red": ("spada_tpu_torch/csrc/esc_stream.cu",
                                  "spada_tpu/ops/element_stream.py:184",
                                  "esc_stream_red"),
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
                              "tools/probe_manual.py:375", "tile_probe")}
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
    (b_nn, by_nn), (lib_nn, lib_name) = (extra["nn"]["bound"],
                                         extra["nn"]["library"])
    log("== the tensor-core kernels on nn (csrc/tile_mma.cuh)")
    for name in ("tile_spgemm", "tile_stream", "tile_panel", "tile_grid"):
        log(f"  {name}: {times[name][0] * 1e3:.3f} ms, bound "
            f"{b_nn * 1e3:.3f} ms ({by_nn}, {b_nn / times[name][0]:.1%} of "
            f"it), plain {times[name][1] * 1e3:.3f} ms, library {lib_name} "
            f"{lib_nn * 1e3:.3f} ms")
    log(json.dumps({"kernels": kernels}))
    log(smi_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
