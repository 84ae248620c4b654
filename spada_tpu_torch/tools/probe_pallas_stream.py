"""The element class kernels at fixed block sizes (port of
``tools/probe_pallas_stream.py``).

The TPU probe asked which block size lets a pipelined streaming kernel beat
XLA's fused elementwise pass on the element path's mix.  Here the same
sweep runs the port's element kernels (``csrc/esc_stream.cu``) as the main
path launches them and, through :func:`esc_stream_mul_blocked` and
:func:`esc_stream_red_blocked`, with the work of one CUDA block set to the
TPU's block, beside one PyTorch call that computes the same function:

- ``esc_stream_mul`` on [45904, 1024] f32 (the locpl L = 1 class size):
  the main path's launch (512 elements per block) and the TPU's blocks of
  1024, 2048 and 2869 rows of 1024, beside ``torch.mul``;
- ``esc_stream_red`` at L = 2 on [2, 4478341 padded to 2^20] f32: the main
  path's launch and the TPU's 2^20 chunk columns per block, beside
  ``torch.linalg.vecdot(a, b, dim=0)``.

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
CHL = 1 << 20          # the TPU red block: chunk columns per block
MUL_BLOCK_ROWS = (1024, 2048, 2869)


def _check_block(kernel: str, block: int) -> None:
    if block <= 0 or block % 4:
        raise ValueError(f"{kernel}: block must be a positive multiple of 4, "
                         f"got {block}")


def esc_stream_mul_blocked(a: torch.Tensor, b: torch.Tensor,
                           block: int) -> torch.Tensor:
    """``esc_stream_mul`` with ``block`` elements per CUDA block.  CUDA
    tensors run ``csrc/esc_stream.cu``; CPU tensors the plain version."""
    _check_block("esc_stream_mul_blocked", block)
    _check_operands(a, b, "esc_stream_mul_blocked")
    if a.device.type == "cpu":
        return esc_stream_mul_reference(a, b)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    status = _build.load().esc_stream_mul_blocked(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), block,
        _build.current_stream(a))
    _build.check(status, "esc_stream_mul_blocked")
    _build.launches["esc_stream_mul_blocked"] += 1
    return out


def esc_stream_red_blocked(a: torch.Tensor, b: torch.Tensor,
                           block: int) -> torch.Tensor:
    """``esc_stream_red`` with ``block`` chunk columns per CUDA block.
    CUDA tensors run ``csrc/esc_stream.cu``; CPU tensors the plain
    version."""
    _check_block("esc_stream_red_blocked", block)
    _check_operands(a, b, "esc_stream_red_blocked")
    if a.device.type == "cpu":
        return esc_stream_red_reference(a, b)
    L, n_pad = a.shape
    out = torch.empty((1, n_pad), dtype=torch.float32, device=a.device)
    if n_pad == 0:
        return out
    if L == 0:
        return out.zero_()
    slices = red_slices(L, n_pad // 4)
    status = _build.load().esc_stream_red_blocked(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), L, n_pad, slices,
        red_group(L, slices), block, _build.current_stream(a))
    _build.check(status, "esc_stream_red_blocked")
    _build.launches["esc_stream_red_blocked"] += 1
    return out


def stream_cases(rows: int, n2: int, device, seed: int = 0):
    """[(label, kernel name, kernel call, plain call, library call, (flops,
    bytes))]: zero-argument calls on the probe's operands."""
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
    mul_work, red_work = stream_work(1, a.numel()), stream_work(2, n2p)

    def mul_plain():
        return esc_stream_mul_reference(a, b)

    def mul_library():
        return torch.mul(a, b)

    def red_plain():
        return esc_stream_red_reference(a2, b2)

    def red_library():
        return torch.linalg.vecdot(a2, b2, dim=0)

    cases = [("mul default", "esc_stream_mul", lambda: esc_stream_mul(a, b),
              mul_plain, mul_library, mul_work)]
    cases += [(f"mul br={r}", "esc_stream_mul_blocked",
               lambda r=r: esc_stream_mul_blocked(a, b, r * 1024),
               mul_plain, mul_library, mul_work) for r in MUL_BLOCK_ROWS]
    cases += [("red2 default", "esc_stream_red",
               lambda: esc_stream_red(a2, b2), red_plain, red_library,
               red_work),
              (f"red2 chl={CHL}", "esc_stream_red_blocked",
               lambda: esc_stream_red_blocked(a2, b2, CHL), red_plain,
               red_library, red_work)]
    return cases


def run(rows: int = ROWS, n2: int = N2, device="cuda",
        log: Callable[[str], None] = print) -> Dict[str, dict]:
    """Each case once against its plain version, then timed on a CUDA
    device.  Returns {label: {"kernel", "relerr", "max_abs_err", "ms",
    "plain_ms", "library_ms", "bound_ms", "bound_by", "gbps"}} (times None
    on the CPU)."""
    from spada_tpu_torch.convert import check_device
    from spada_tpu_torch.config import roofline_bound

    dev = check_device(device)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else None
    out = {}
    for label, kname, kernel, plain, library, (flops, nbytes) in \
            stream_cases(rows, n2, dev):
        got, ref = kernel(), plain()
        err = float((got - ref).abs().max())
        bound, by = roofline_bound(flops, nbytes, name)
        rec = {"kernel": kname, "max_abs_err": err,
               "relerr": err / max(float(ref.abs().max()), 1e-30),
               "bound_ms": bound * 1e3, "bound_by": by, "ms": None,
               "plain_ms": None,
               "library_ms": None, "gbps": None}
        del got, ref
        if cuda:
            from spada_tpu_torch.utils.timing import cuda_time

            t, _ = cuda_time(kernel)
            tp, _ = cuda_time(plain)
            tl, _ = cuda_time(library)
            rec.update(ms=t * 1e3, plain_ms=tp * 1e3, library_ms=tl * 1e3,
                       gbps=nbytes / t / 1e9)
            log(f"  {label:18s} {t * 1e3:7.3f} ms {nbytes / t / 1e9:7.1f} "
                f"GB/s (bound {bound * 1e3:.3f} ms)  plain {tp * 1e3:7.3f} "
                f"ms  library {tl * 1e3:7.3f} ms  max|d|/max|ref| "
                f"{rec['relerr']:.1e}")
        else:
            log(f"  {label:18s} max|d|/max|ref| {rec['relerr']:.1e} (plain "
                f"version on the CPU, not timed)")
        out[label] = rec
    return out


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
