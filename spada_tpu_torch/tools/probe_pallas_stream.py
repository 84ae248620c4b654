"""The element class kernels as a bulk-copy pipeline, at a sweep of stage
sizes (port of ``tools/probe_pallas_stream.py``).

The TPU probe asked whether an explicitly pipelined streaming kernel, Pallas's
double-buffered block copies into VMEM, beats XLA's fused elementwise pass on
the element path's mix, and at which block size.  The card's counterpart of
that pipeline is :func:`esc_stream_mul_blocked` and
:func:`esc_stream_red_blocked` (``csrc/esc_stream.cu``): a persistent grid of
``grid_factor`` blocks per SM, each a ring of ``stages`` slots in shared
memory that one producer thread fills with bulk asynchronous copies
(``cp.async.bulk`` under mbarriers) while 256 threads consume them.  Their
``block`` is the work of one stage: elements of each operand (mul), or chunk
columns of each of the L rows (red).  The TPU's blocks (1024-2869 rows of
1024 f32, 4-11.7 MB an operand; 2^20 chunk columns, 8 MB) have no
counterpart: a block of the card has 227 KB of shared memory, and a stage
that does not fit raises ``ValueError``.  So each row of the sweep answers
the TPU question at the card's scale:

- ``mul <k>KiB S=<s> k=<g>`` (the TPU's ``mul_kernel`` rows): ``esc_stream_mul``'s
  function on [45904, 1024] f32 (the locpl L = 1 class), k KiB of each
  operand a stage, ``STAGE_KIB`` x ``STAGES`` x ``GRID_FACTORS`` where the
  blocks fit on an SM, beside ``mul default`` (the main path's
  ``esc_stream_mul``, one float4 a thread, nothing staged) and
  ``torch.mul`` (the fused elementwise pass);
- ``red2 <k>KiB S=<s> k=<g>`` (the TPU's ``red_kernel`` rows): the column sums
  at L = 2 of [2, 4478341 padded to 5 * 2^20] f32, the same sweep, beside
  ``red2 default`` (the main path's ``esc_stream_red``) and
  ``torch.linalg.vecdot(a, b, dim=0)``.

Every stage row is held bitwise to the main path's kernel (mul: ``a * b``;
red: ``esc_stream_red``'s compensated sums in its order) and to the plain
version.  The red operands (105 MB with the output) are about twice the L2
cache, so the red rows are also timed with L2 flushed before every call.

:func:`block_shape_sweep` times what the design of ``esc_stream_red`` and of
the grouped launch chose, on the operands of a real plan (``chip_smoke.py``
hands it the locpl classes): each red class at its default block shape, with
one serial compensated sum per thread (``group`` 1) and with other row
splits (``slices``), and the grouped launch under other class orders.

Prints ms and GB/s (bytes the call must move: each input read once, the
output written once) beside the HBM bound:

    python -m spada_tpu_torch.tools.probe_pallas_stream
    python -m spada_tpu_torch.tools.probe_pallas_stream --device cpu --rows 64
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict

import numpy as np
import torch

from spada_tpu_torch import _build
from spada_tpu_torch.ops.element_stream import (_check_operands,
                                                esc_stream_mul_reference,
                                                esc_stream_red_reference,
                                                red_group, red_slices)

ROWS = 45904           # rows of 1024: n = 47,005,696, the locpl L=1 class
N2 = 4478341           # chunks of the locpl L=2 class
CHL = 1 << 20          # the TPU red block: the L = 2 operands pad to it
#: the sweep: KiB of each operand a stage brings, ring depths, blocks per SM
STAGE_KIB = (4, 8, 16, 32)
STAGES = (2, 3, 4)
GRID_FACTORS = (1, 2)
#: the launch's defaults
DEFAULT_STAGES = 4
DEFAULT_GRID_FACTOR = 1

# what csrc/esc_stream.cu's pipeline takes: ring depth, blocks per SM, the
# shared memory of a block and of an SM on sm_90 (the runtime keeps 1 KB of
# an SM's per block), the ring's header (its mbarriers) and the red
# combine's scratch (a block whose rows are split over slices)
MAX_STAGES = 8
MAX_GRID_FACTOR = 4
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
_SMEM_RESERVED = 1024
_PIPE_HEADER = 2 * MAX_STAGES * 8
_RED_PART = 2 * 256 * 16


def stage_smem(L: int, block: int, stages: int, slices: int = 1) -> int:
    """Bytes of shared memory one block of the pipeline takes: a ring of
    ``stages`` slots of ``block`` elements (mul, ``L`` = 1) or chunk columns
    of L rows (red) of both operands, the mbarriers, and the red combine's
    scratch where ``slices`` > 1."""
    return (_PIPE_HEADER + (_RED_PART if slices > 1 else 0)
            + stages * 8 * L * block)


def fits_per_sm(smem: int, grid_factor: int) -> bool:
    """Whether ``grid_factor`` blocks of ``smem`` bytes fit on one SM."""
    return grid_factor * (smem + _SMEM_RESERVED) <= SMEM_PER_SM


def _check_pipe(kernel: str, a: torch.Tensor, b: torch.Tensor, block: int,
                stages: int, grid_factor: int, smem: int) -> None:
    """What the pipeline takes, on every device: the CPU path runs the plain
    version, but refuses what the card's launch would."""
    if block <= 0 or block % 4:
        raise ValueError(f"{kernel}: block must be a positive multiple of 4, "
                         f"got {block}")
    if not 1 <= stages <= MAX_STAGES:
        raise ValueError(f"{kernel}: stages must be 1 to {MAX_STAGES}, got "
                         f"{stages}")
    if not 1 <= grid_factor <= MAX_GRID_FACTOR:
        raise ValueError(f"{kernel}: grid_factor must be 1 to "
                         f"{MAX_GRID_FACTOR}, got {grid_factor}")
    if a.shape[1] % 4:
        raise ValueError(f"{kernel}: rows must be a multiple of 4 floats, got "
                         f"{a.shape[1]}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{kernel}: operands must be contiguous")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(f"{kernel}: bulk copies need 16-byte aligned "
                         f"operands")
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{kernel}: a ring of {stages} stages of block "
                         f"{block} takes {smem} bytes of shared memory, over "
                         f"the {SMEM_PER_BLOCK} a block has")


def esc_stream_mul_blocked(a: torch.Tensor, b: torch.Tensor, block: int,
                           stages: int = DEFAULT_STAGES,
                           grid_factor: int = DEFAULT_GRID_FACTOR
                           ) -> torch.Tensor:
    """``esc_stream_mul``'s product through the bulk-copy pipeline, ``block``
    elements of each operand a stage.  CUDA tensors run
    ``csrc/esc_stream.cu``; CPU tensors the plain version."""
    _check_operands(a, b, "esc_stream_mul_blocked")
    _check_pipe("esc_stream_mul_blocked", a, b, block, stages, grid_factor,
                stage_smem(1, block, stages))
    if a.device.type == "cpu":
        return esc_stream_mul_reference(a, b)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    status = _build.load().esc_stream_mul_blocked(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), block, stages,
        grid_factor, _build.current_stream(a))
    _build.check(status, "esc_stream_mul_blocked")
    _build.launches["esc_stream_mul_blocked"] += 1
    return out


def esc_stream_red_blocked(a: torch.Tensor, b: torch.Tensor, block: int,
                           stages: int = DEFAULT_STAGES,
                           grid_factor: int = DEFAULT_GRID_FACTOR
                           ) -> torch.Tensor:
    """``esc_stream_red``'s column sums, bit for bit, through the bulk-copy
    pipeline, ``block`` chunk columns of the L rows of each operand a
    stage.  CUDA tensors run ``csrc/esc_stream.cu``; CPU tensors the plain
    version."""
    _check_operands(a, b, "esc_stream_red_blocked")
    L, n_pad = a.shape
    slices = red_slices(L, n_pad // 4)
    _check_pipe("esc_stream_red_blocked", a, b, block, stages, grid_factor,
                stage_smem(L, block, stages, slices))
    if a.device.type == "cpu":
        return esc_stream_red_reference(a, b)
    out = torch.empty((1, n_pad), dtype=torch.float32, device=a.device)
    if n_pad == 0:
        return out
    if L == 0:
        return out.zero_()
    status = _build.load().esc_stream_red_blocked(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), L, n_pad, slices,
        red_group(L, slices), block, stages, grid_factor,
        _build.current_stream(a))
    _build.check(status, "esc_stream_red_blocked")
    _build.launches["esc_stream_red_blocked"] += 1
    return out


def stage_rows(L: int):
    """[(label suffix, block, stages, grid_factor)]: the sweep's rows for a
    kernel of ``L`` rows (1: mul), those whose blocks fit on an SM."""
    return [(f"{kib}KiB S={s} k={g}", kib * 1024 // (4 * L), s, g)
            for kib in STAGE_KIB for s in STAGES for g in GRID_FACTORS
            if fits_per_sm(stage_smem(L, kib * 1024 // (4 * L), s), g)]


def stream_cases(rows: int, n2: int, device, seed: int = 0):
    """The probe's two kernels on its operands: [(kernel name, main-path
    label, main-path call, [(stage label, block, stages, grid_factor,
    call)], plain call, library call, (flops, bytes))], each call taking
    no argument."""
    from spada_tpu_torch.config import stream_work
    from spada_tpu_torch.ops.element_stream import (esc_stream_mul,
                                                    esc_stream_red)

    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((rows, 1024), np.float32)).to(
        device)
    b = torch.from_numpy(rng.standard_normal((rows, 1024), np.float32)).to(
        device)
    n2p = -(-n2 // CHL) * CHL
    a2 = np.zeros((2, n2p), np.float32)
    b2 = np.zeros((2, n2p), np.float32)
    a2[:, :n2] = rng.standard_normal((2, n2), np.float32)
    b2[:, :n2] = rng.standard_normal((2, n2), np.float32)
    a2, b2 = torch.from_numpy(a2).to(device), torch.from_numpy(b2).to(device)

    def rows_of(kernel, x, y, L, prefix):
        return [(f"{prefix} {suffix}", blk, s, g,
                 lambda blk=blk, s=s, g=g: kernel(x, y, blk, s, g))
                for suffix, blk, s, g in stage_rows(L)]

    return [("esc_stream_mul_blocked", "mul default",
             lambda: esc_stream_mul(a, b),
             rows_of(esc_stream_mul_blocked, a, b, 1, "mul"),
             lambda: esc_stream_mul_reference(a, b),
             lambda: torch.mul(a, b), stream_work(1, a.numel())),
            ("esc_stream_red_blocked", "red2 default",
             lambda: esc_stream_red(a2, b2),
             rows_of(esc_stream_red_blocked, a2, b2, 2, "red2"),
             lambda: esc_stream_red_reference(a2, b2),
             lambda: torch.linalg.vecdot(a2, b2, dim=0),
             stream_work(2, n2p))]


def run(rows: int = ROWS, n2: int = N2, device="cuda",
        log: Callable[[str], None] = print) -> Dict[str, dict]:
    """Each main-path launch and stage row once against the plain version
    (and each stage row against the main path's bits), then timed on a
    CUDA device.  Returns {label: {"kernel", "block", "stages",
    "grid_factor", "exact", "relerr", "max_abs_err", "ms", "cold_ms",
    "main_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "gbps"}};
    ``exact`` says whether a stage row gave the main path's bits (None for
    the main path's own row), ``cold_ms`` is the red rows' time with L2
    flushed before every call; times are None on the CPU."""
    from spada_tpu_torch.config import roofline_bound
    from spada_tpu_torch.convert import check_device
    from spada_tpu_torch.tools.harness import call_s

    dev = check_device(device)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else None
    # twice the 50 MB L2 of an H100
    flush = (torch.empty(256 << 20, dtype=torch.uint8, device=dev) if cuda
             else None)

    def device_ms(call, **kw):  # the timing's launches are not counted
        return call_s(call, dev, **kw) * 1e3

    out = {}
    for kname, main_label, main, stage_calls, plain, library, (flops, nbytes) \
            in stream_cases(rows, n2, dev):
        ref, want = plain(), main()
        scale = max(float(ref.abs().max()), 1e-30)
        bound, by = roofline_bound(flops, nbytes, name)
        red = kname.startswith("esc_stream_red")
        common = {"bound_ms": bound * 1e3, "bound_by": by, "main_ms": None,
                  "plain_ms": None, "library_ms": None}
        if cuda:
            common.update(plain_ms=device_ms(plain),
                          library_ms=device_ms(library))
        # the main path's launch first: its time goes beside every stage row
        rows_ = [(main_label, kname.replace("_blocked", ""), None, None,
                  None, main)]
        rows_ += [(label, kname, blk, s, g, call)
                  for label, blk, s, g, call in stage_calls]
        for label, kernel, blk, s, g, call in rows_:
            got = want if blk is None else call()
            err = float((got - ref).abs().max())
            rec = {**common, "kernel": kernel, "block": blk, "stages": s,
                   "grid_factor": g,
                   "exact": None if blk is None else torch.equal(got, want),
                   "max_abs_err": err, "relerr": err / scale, "ms": None,
                   "cold_ms": None, "gbps": None}
            del got
            if cuda:
                ms = device_ms(call)
                if blk is None:
                    common["main_ms"] = ms
                rec.update(ms=ms, main_ms=common["main_ms"],
                           gbps=nbytes / ms / 1e6)
                if red:
                    rec["cold_ms"] = device_ms(call, flush=flush)
            out[label] = rec
            log(_row_line(label, rec))
        if cuda and red:
            log(f"  {'vecdot, L2 flushed':24s} "
                f"{device_ms(library, flush=flush):7.3f} ms")
        del ref, want
    return out


def _row_line(label: str, rec: dict) -> str:
    exact = {None: "", True: "  bitwise main", False: "  NOT bitwise main"}
    head = f"  {label:24s}"
    if rec["ms"] is None:
        return (f"{head} max|d|/max|ref| {rec['relerr']:.1e}"
                f"{exact[rec['exact']]} (plain version on the CPU, not timed)")
    cold = (f" (L2 flushed {rec['cold_ms']:.3f})"
            if rec["cold_ms"] is not None else "")
    return (f"{head} {rec['ms']:7.3f} ms{cold} {rec['gbps']:7.1f} GB/s  "
            f"bound {rec['bound_ms']:.3f} ms ({rec['bound_ms'] / rec['ms']:.0%})"
            f"  main {rec['main_ms']:.3f}  library {rec['library_ms']:.3f}  "
            f"plain {rec['plain_ms']:.3f} ms  max|d|/max|ref| "
            f"{rec['relerr']:.1e}{exact[rec['exact']]}")


def best_row(res: Dict[str, dict], kernel: str) -> str:
    """The label of ``kernel``'s fastest stage row in :func:`run`'s
    result."""
    return min((label for label, r in res.items() if r["kernel"] == kernel),
               key=lambda label: res[label]["ms"])


def block_shape_sweep(pairs, Ls, log: Callable[[str], None] = print) -> dict:
    """Device ms of the red classes of ``pairs`` (CUDA operands in the
    stream layout, ``Ls[i]`` products per chunk) under other block shapes,
    and of the grouped launch under other class orders.  Every variant is
    first held to the default's values (1e-6 of max|out|; the grouped
    orders bitwise).  Returns {"red": {L: {label: ms}}, "group": {label:
    ms}}."""
    from spada_tpu_torch.ops.element_stream import (esc_stream_group,
                                                    esc_stream_red,
                                                    group_table)
    from spada_tpu_torch.utils.timing import cuda_time

    out: dict = {"red": {}, "group": {}}
    for (a, b), L in zip(pairs, Ls):
        if L == 1:
            continue
        n4 = a.shape[1] // 4
        s0 = red_slices(L, n4)
        shapes = {"default": (s0, red_group(L, s0)), "group 1": (s0, 1)}
        if red_group(L, s0) > 2:
            shapes["group 2"] = (s0, 2)
        for s in sorted({1, s0 // 2, min(2 * s0, 32)} - {0, s0}):
            if L % s == 0:
                shapes[f"slices {s}"] = (s, red_group(L, s))
        ref = esc_stream_red(a, b)
        scale = max(float(ref.abs().max()), 1e-30)
        row = {}
        for label, (s, g) in shapes.items():
            got = esc_stream_red(a, b, slices=s, group=g)
            err = float((got - ref).abs().max()) / scale
            if err > 1e-6:
                raise RuntimeError(f"esc_stream_red L={L} {label}: "
                                   f"{err:.3e} from the default's values")
            row[label] = cuda_time(
                lambda: esc_stream_red(a, b, slices=s, group=g))[0] * 1e3
        out["red"][L] = row
        log(f"  red L={L:3d} n_pad={a.shape[1]:8d} slices {s0:2d}: "
            + "  ".join(f"{k} {v:.4f} ms" for k, v in row.items()))
    classes = [(L, a.numel() if L == 1 else a.shape[1])
               for (a, _), L in zip(pairs, Ls)]
    table = group_table(classes)[0].tolist()
    # rows per thread of a class's blocks, then its blocks: longest first
    heavy = [r[0] for r in sorted(table, key=lambda r: (-(r[1] // r[3]),
                                                        -r[2], r[0]))]
    ref = esc_stream_group(pairs, Ls)
    for label, order in (("as the classes come (default)", None),
                         ("longest blocks first", heavy),
                         ("shortest blocks first", heavy[::-1])):
        got = esc_stream_group(pairs, Ls, order=order)
        if not all(torch.equal(x, y) for x, y in zip(got, ref)):
            raise RuntimeError(f"esc_stream_group, {label}: not bitwise the "
                               f"default order's values")
        out["group"][label] = cuda_time(
            lambda: esc_stream_group(pairs, Ls, order=order))[0] * 1e3
        log(f"  grouped launch, {label}: {out['group'][label]:.4f} ms")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--rows", type=int, default=ROWS,
                   help="rows of 1024 of the mul operands")
    p.add_argument("--n2", type=int, default=N2,
                   help="chunks of the L = 2 red operands")
    args = p.parse_args(argv)
    return run(args.rows, args.n2, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
