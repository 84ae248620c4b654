"""The tile-kernel ablation probe: ``csrc/tile_probe.cu`` and
``csrc/tile_probe_mma.cuh``, their wrapper, the plain version of every mode,
and the probes' shared workload and runner.

The port of the Pallas variants of ``tools/probe_kernel.py`` and
``tools/probe_manual.py``.  Those stripped the cached megakernel one
component at a time (DMA, dynamic slots, accumulate, copy-out, loop) to
attribute its time per work item.  :func:`tile_probe` does the same on the
card to the block the main-path tile kernels run: the tensor-core block
(``csrc/tile_mma.cuh``) for the shapes it takes (tm, tn multiples of 128,
tk of 32 for f32 tiles and 64 for bf16), the FP32 SIMT wide block
(``csrc/tile_wide.cuh``) for other wide shapes or on request
(``block="simt"``).  ``mode`` names a GPU mode (:data:`GPU_MODES` on both
blocks, :data:`MMA_MODES` on the tensor-core block only), and
:data:`TPU_MODES` maps every mode name of the two TPU probes to the GPU mode
that means the same on an SM (see the tables in ``csrc/tile_probe.cu`` and
``csrc/tile_probe_mma.cuh``).

Every mode has a plain PyTorch version (:func:`tile_probe_reference`) of the
C it produces; the wrapper takes it for CPU tensors only.  Modes that write
no C leave the output as the wrapper filled it, :data:`SENTINEL`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from spada_tpu_torch import _build
from spada_tpu_torch.config import roofline_bound, tile_work
from spada_tpu_torch.ops.engine import (_check_tile_args, _launched,
                                        _run_o_ids, run_worklist_reference)

#: the modes of both blocks, in the order of the kernels' ``mode`` argument
GPU_MODES = ("full", "nodma", "statslot", "oneslot", "noacc", "nocopy",
             "dots", "stat", "loop", "empty", "empty0", "flat")
#: the modes of the tensor-core block alone: the first four follow GPU_MODES
#: in the kernel's ``mode`` argument; ring2, ring3 (the ring's depth) and
#: akmajor (A staged k-major from k-transposed tiles) are its full mode
#: under other template arguments
MMA_MODES = ("onepass", "bigonly", "nofold", "nobar", "ring2", "ring3",
             "akmajor")
#: 3xTF32's split exists for f32 tiles only
F32_MODES = ("onepass", "bigonly")
ALL_GPU_MODES = GPU_MODES + MMA_MODES
#: mode -> (kernel mode, ring stages, A k-transposed) where not (mode, 4, 0)
_MMA_VARIANTS = {"ring2": ("full", 2, 0), "ring3": ("full", 3, 0),
                 "akmajor": ("full", 4, 1)}
BLOCKS = ("auto", "mma", "simt")

#: every mode name of the TPU probes -> the GPU mode that means the same
TPU_MODES = {
    # tools/probe_kernel.py
    "full": "full", "nodma": "nodma", "statslot": "statslot",
    "oneslot": "oneslot", "noacc": "noacc", "empty": "empty",
    "empty0": "empty0", "empty1": "empty", "emptyS": "empty0",
    "emptyD": "loop", "nozero": "empty0",
    # tools/probe_manual.py
    "v2full": "full", "v2nocopy": "nocopy", "v2nodma": "nodma",
    "v2dots": "dots", "v2loop": "loop", "v2store": "noacc", "v2stat": "stat",
    "v3acc": "full", "v3st": "stat", "v4stat": "stat", "v4unroll": "stat",
    "flat": "flat", "real": "full",
}

#: the suffixes ``tools/probe_kernel.py`` puts on a mode name
#: (``run_variant``) -> what each means here; None: no GPU mode
TPU_SUFFIXES = {
    "par": "a parallel grid: every GPU grid is one, so the base mode",
    "bf16": None,   # bf16 C: the kernel writes f32 C tiles only
    "tiny": None,   # an 8 x 128 output window: the kernel writes whole
                    # tiles; nocopy removes the store
}

#: what C holds after a mode that writes none
SENTINEL = -7.0

_ZERO = ("nodma", "loop", "empty", "empty0", "nobar")
_UNWRITTEN = ("nocopy", "dots", "stat", "bigonly")
_FULL = ("full", "flat", "nofold", "ring2", "ring3", "akmajor")

#: each mode's bar against its plain version, of max|plain C|.  nofold sums
#: through the tensor cores, which round toward zero: 64-item runs at
#: tk = 512 missed by 2.4e-4 (f32 tiles) on an H100, so twice that.
NOFOLD_TOL = 5e-4
TILE_TOL = 1e-5


def mode_tolerance(mode: str) -> float:
    return NOFOLD_TOL if mode == "nofold" else TILE_TOL


def _check_mode(mode: str) -> None:
    if mode not in ALL_GPU_MODES:
        raise ValueError(f"tile_probe: unknown mode {mode!r}; expected one "
                         f"of {', '.join(ALL_GPU_MODES)}")


def mma_takes(dtype: torch.dtype, tm: int, tk: int, tn: int) -> bool:
    """Whether the tensor-core block takes the tile shape
    (``spada::mma::takes`` of ``csrc/tile_mma.cuh``)."""
    bk = 32 if dtype == torch.float32 else 64
    return (tm > 0 and tm % 128 == 0 and tn > 0 and tn % 128 == 0
            and tk > 0 and tk % bk == 0)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to a 10-bit mantissa, to nearest,
    ties away from zero."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    return ((bits + 0x1000) & ~0x1FFF).to(torch.int32).view(torch.float32)


def gpu_mode(tpu_name: str) -> str:
    """The GPU mode of a TPU probe's mode name, suffix included
    (``full_par`` is ``full``); raises for a name or suffix with none.  A
    mode of the tensor-core block alone (:data:`MMA_MODES`) has no TPU name
    and is its own."""
    if tpu_name in MMA_MODES:
        return tpu_name
    base, _, suffix = tpu_name.partition("_")
    if base not in TPU_MODES or (suffix and suffix not in TPU_SUFFIXES):
        raise ValueError(f"unknown probe mode {tpu_name!r}; known: "
                         f"{', '.join(TPU_MODES)}, with an optional suffix "
                         f"_{', _'.join(TPU_SUFFIXES)}, and "
                         f"{', '.join(MMA_MODES)}")
    if suffix and TPU_SUFFIXES[suffix] is None:
        raise ValueError(
            f"probe mode {tpu_name!r}: the suffix _{suffix} has no GPU mode "
            f"(_bf16 wrote bf16 C, _tiny an 8 x 128 output window; "
            f"tile_probe writes whole f32 C tiles, and its nocopy mode "
            f"removes the store)")
    return TPU_MODES[base]


def tile_probe_reference(a_tiles, b_tiles, a_tid, b_tid, tile_ptr,
                         mode: str, a_slots: int = 12,
                         b_slots: int = 24) -> torch.Tensor:
    """Plain version of :func:`tile_probe`: the C tiles [nC, tm, tn] f32 the
    kernel writes in ``mode``."""
    _check_mode(mode)
    tm, tn = a_tiles.shape[1], b_tiles.shape[2]
    n_c = int(tile_ptr.shape[0]) - 1
    dev = a_tiles.device
    if mode in _UNWRITTEN:
        return torch.full((n_c, tm, tn), SENTINEL, dtype=torch.float32,
                          device=dev)
    if mode in _ZERO:
        return torch.zeros((n_c, tm, tn), dtype=torch.float32, device=dev)
    o_tid = _run_o_ids(tile_ptr, a_tid.shape[0])
    if mode in _FULL:
        return run_worklist_reference(a_tiles, b_tiles, a_tid, b_tid, o_tid,
                                      n_c)
    if mode == "onepass":
        # a 1xTF32 product: the operands rounded to TF32, exact products,
        # f32 sums
        return run_worklist_reference(
            _round_tf32(a_tiles.float()), _round_tf32(b_tiles.float()),
            a_tid, b_tid, o_tid, n_c)
    runs = torch.diff(tile_ptr.long()).to(torch.float32)[:, None, None]
    c = torch.arange(n_c, device=dev)
    ia = c % a_slots if mode == "statslot" else torch.zeros_like(c)
    ib = c % b_slots if mode == "statslot" else torch.zeros_like(c)
    prod = torch.bmm(a_tiles[ia].float(), b_tiles[ib].float())
    if mode == "noacc":
        # every item's product is A[0].B[0]: stored, not added up
        return torch.where(runs > 0, prod, torch.zeros_like(prod))
    return runs * prod


def tile_probe(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
               a_tid: torch.Tensor, b_tid: torch.Tensor,
               tile_ptr: torch.Tensor, mode: str = "full",
               a_slots: int = 12, b_slots: int = 24, block: str = "auto",
               a_tiles_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C tiles [nC, tm, tn] f32 of an o-sorted worklist, as a tile block
    computes them with the parts ``mode`` strips left out.

    Arguments as :func:`~spada_tpu_torch.ops.engine.tile_spgemm`; tm and tn
    multiples of 128.  ``block``: ``"mma"`` the tensor-core block (tk a
    multiple of 32 for f32 tiles, 64 for bf16; every mode), ``"simt"`` the
    FP32 SIMT wide block (tk a multiple of 8; :data:`GPU_MODES`), ``"auto"``
    the tensor-core block where it takes the shape, as ``tile_spgemm``
    chooses.  ``a_slots`` and ``b_slots`` are the fixed tile ids of
    ``statslot`` (C tile c reads A tile ``c % a_slots`` and B tile
    ``c % b_slots``).  ``a_tiles_t``: the k-transposed copy of ``a_tiles``
    that mode ``akmajor`` reads (made here when not given).  CUDA tensors
    run ``csrc/tile_probe_mma_*.cu`` or ``csrc/tile_probe.cu``.
    """
    _check_mode(mode)
    if block not in BLOCKS:
        raise ValueError(f"tile_probe: unknown block {block!r}; expected one "
                         f"of {', '.join(BLOCKS)}")
    _check_tile_args("tile_probe", a_tiles, b_tiles, 2, a_tid=a_tid,
                     b_tid=b_tid, tile_ptr=tile_ptr)
    tm, tk, tn = a_tiles.shape[1], a_tiles.shape[2], b_tiles.shape[2]
    if tm % 128 or tn % 128 or tk % 8 or 0 in (tm, tk, tn):
        raise ValueError(f"tile_probe takes tm, tn multiples of 128 and tk "
                         f"of 8; got tm={tm} tk={tk} tn={tn}")
    takes = mma_takes(a_tiles.dtype, tm, tk, tn)
    if block == "auto":
        block = "mma" if takes else "simt"
    if block == "mma" and not takes:
        raise ValueError(f"tile_probe: the tensor-core block takes tk "
                         f"multiples of 32 (f32 tiles) or 64 (bf16); got "
                         f"tk={tk} {a_tiles.dtype}")
    if block == "simt" and mode in MMA_MODES:
        raise ValueError(f"tile_probe: {mode} is a mode of the tensor-core "
                         f"block, which does not take tm={tm} tk={tk} "
                         f"tn={tn} {a_tiles.dtype} or was not asked for")
    if mode in F32_MODES and a_tiles.dtype != torch.float32:
        raise ValueError(f"tile_probe: {mode} is a mode of f32 tiles (bf16 "
                         f"operands are not split)")
    if not (1 <= a_slots <= a_tiles.shape[0]
            and 1 <= b_slots <= b_tiles.shape[0]):
        raise ValueError("tile_probe: a_slots and b_slots must be in 1..the "
                         "number of A and B tiles")
    if a_tiles_t is not None and (
            mode != "akmajor" or a_tiles_t.dtype != a_tiles.dtype
            or a_tiles_t.device != a_tiles.device
            or not a_tiles_t.is_contiguous() or tuple(a_tiles_t.shape) != (
                a_tiles.shape[0], tk, tm)):
        raise ValueError("tile_probe: a_tiles_t goes with mode akmajor and "
                         "is a_tiles.transpose(1, 2).contiguous()")
    if a_tiles.device.type == "cpu":
        return tile_probe_reference(a_tiles, b_tiles, a_tid, b_tid, tile_ptr,
                                    mode, a_slots, b_slots)
    n_c = int(tile_ptr.shape[0]) - 1
    c = torch.full((n_c, tm, tn), SENTINEL, dtype=torch.float32,
                   device=a_tiles.device)
    if n_c == 0:
        return c
    lib = _build.load()
    f32 = a_tiles.dtype == torch.float32
    if block == "simt":
        fn = lib.tile_probe_f32 if f32 else lib.tile_probe_bf16
        _launched("tile_probe", fn(
            a_tiles.data_ptr(), b_tiles.data_ptr(), a_tid.data_ptr(),
            b_tid.data_ptr(), tile_ptr.data_ptr(), c.data_ptr(), n_c, tm, tk,
            tn, a_slots, b_slots, GPU_MODES.index(mode),
            _build.current_stream(a_tiles)))
        return c
    kmode, stages, a_t = _MMA_VARIANTS.get(mode, (mode, 4, 0))
    if a_t and a_tiles_t is None:
        a_tiles_t = a_tiles.transpose(1, 2).contiguous()
    fn = lib.tile_probe_mma_f32 if f32 else lib.tile_probe_mma_bf16
    _launched("tile_probe_mma", fn(
        (a_tiles_t if a_t else a_tiles).data_ptr(), b_tiles.data_ptr(),
        a_tid.data_ptr(), b_tid.data_ptr(), tile_ptr.data_ptr(),
        c.data_ptr(), n_c, tm, tk, tn, a_slots, b_slots,
        ALL_GPU_MODES.index(kmode), stages, a_t,
        _build.current_stream(a_tiles)))
    return c


# --------------------------------------------------------------------------
# The probes' workload and runner (tools/probe_kernel.py, probe_manual.py)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ProbeWork:
    """A banded pair cut into T x T tiles, on a device, with its
    row-major worklist; ``a_csr`` and ``b_csr`` are the host pair."""

    a_tiles: torch.Tensor
    b_tiles: torch.Tensor
    a_tid: torch.Tensor
    b_tid: torch.Tensor
    tile_ptr: torch.Tensor
    n: int
    band: int
    T: int
    a_slots: int
    b_slots: int
    a_csr: object
    b_csr: object

    @property
    def n_items(self) -> int:
        return int(self.a_tid.shape[0])

    @property
    def n_c(self) -> int:
        return int(self.tile_ptr.shape[0]) - 1

    def work(self) -> tuple:
        """(flops, bytes) of the full mode: the useful products of the
        banded pair, the tiles and ids read once, C written once."""
        return tile_work(self.a_tiles, self.b_tiles, self.n_items, self.n_c,
                         self.a_csr, self.b_csr)

    def bound(self, device_name=None) -> tuple:
        """(seconds, what bounds it) of the full mode on the named card."""
        return roofline_bound(*self.work(), device_name, self.a_tiles.dtype,
                              matmul=True)


def probe_work(n: int, band: int, T: int, device, dtype=torch.bfloat16,
               a_slots: int = 12, b_slots: int = 24) -> ProbeWork:
    """The TPU probes' workload: ``banded_csr(n, n, band)`` with seeds 0 and
    1, BSR at T x T, the row-major worklist, tiles cast to ``dtype``."""
    from spada_tpu_torch.convert import bsr_to_torch, tile_ptr_of
    from spada_tpu_torch.io.workloads import banded_csr
    from spada_tpu_torch.ops.worklist import build_worklist
    from spada_tpu_torch.sparse.bsr import BsrMatrix

    a = banded_csr(n, n, bandwidth=band, seed=0, dtype=np.float32)
    b = banded_csr(n, n, bandwidth=band, seed=1, dtype=np.float32)
    a_bsr = BsrMatrix.from_csr(a, T, T, dtype=np.float32)
    b_bsr = BsrMatrix.from_csr(b, T, T, dtype=np.float32)
    wl = build_worklist(a_bsr, b_bsr, order="row")

    def ids(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    return ProbeWork(bsr_to_torch(a_bsr, device, dtype),
                     bsr_to_torch(b_bsr, device, dtype),
                     ids(wl.a_tid), ids(wl.b_tid),
                     ids(tile_ptr_of(wl.o_tid, wl.n_c_tiles)), n, band, T,
                     min(a_slots, a_bsr.n_tiles), min(b_slots, b_bsr.n_tiles),
                     a, b)


def run_modes(work: ProbeWork, names: List[str],
              log: Callable[[str], None] = print,
              block: str = "auto") -> Dict[str, dict]:
    """Run each mode name's GPU mode (TPU names, or :data:`MMA_MODES`) once
    on ``work`` on the given block (:func:`tile_probe`), hold it to its
    plain version, and on a CUDA device time it (median of 10, device
    held).

    Returns {GPU mode: {"tpu": [names], "max_abs_err", "relerr" (to the
    plain version, of max|plain|), "tol" (the bar "relerr" is held to,
    :func:`mode_tolerance`), "exact", "ms", "ns_per_item", "plain_ms"}}.
    "exact" is whether C is bitwise the plain C, for the modes that write
    zeros or nothing; None for the rest (full and flat included), which are
    held to the plain C by "relerr".  Times are None on the CPU.
    """
    modes = [gpu_mode(m) for m in names]
    cuda = work.a_tiles.device.type == "cuda"
    args = (work.a_tiles, work.b_tiles, work.a_tid, work.b_tid,
            work.tile_ptr)
    # akmajor's k-transposed A, made once outside the timed calls
    a_t = (work.a_tiles.transpose(1, 2).contiguous() if "akmajor" in modes
           else None)
    name = torch.cuda.get_device_name(work.a_tiles.device) if cuda else None
    flops, nbytes = work.work()
    bound, by = work.bound(name)
    log(f"W={work.n_items} nC={work.n_c} T={work.T} "
        f"{str(work.a_tiles.dtype)[6:]} tiles, {flops / 1e9:.1f} GFLOP of "
        f"products, {nbytes / 1e9:.3f} GB; bound of the full work "
        f"{bound * 1e3:.3f} ms ({by}; {bound / work.n_items * 1e9:.0f} "
        f"ns/item)")
    out: Dict[str, dict] = {}
    for tpu, mode in zip(names, modes):
        if mode in out:
            out[mode]["tpu"].append(tpu)
            continue
        kw = dict(mode=mode, a_slots=work.a_slots, b_slots=work.b_slots)
        run_kw = dict(kw, block=block,
                      a_tiles_t=a_t if mode == "akmajor" else None)
        got = tile_probe(*args, **run_kw)
        ref = tile_probe_reference(*args, **kw)
        err = float((got - ref).abs().max()) if got.numel() else 0.0
        scale = max(float(ref.abs().max()) if ref.numel() else 0.0, 1e-30)
        exact = (torch.equal(got, ref) if mode in _ZERO + _UNWRITTEN
                 else None)
        rec = {"tpu": [tpu], "max_abs_err": err, "relerr": err / scale,
               "tol": mode_tolerance(mode), "exact": exact, "ms": None,
               "ns_per_item": None, "plain_ms": None}
        del got, ref
        if cuda:
            from spada_tpu_torch.utils.timing import cuda_time

            t, _ = cuda_time(lambda: tile_probe(*args, **run_kw))
            tp, _ = cuda_time(lambda: tile_probe_reference(*args, **kw),
                              warmup=1, reps=3)
            rec.update(ms=t * 1e3, ns_per_item=t / work.n_items * 1e9,
                       plain_ms=tp * 1e3)
            log(f"  {mode:8s} ({'/'.join(rec['tpu'])}): {t * 1e3:8.3f} ms "
                f"({rec['ns_per_item']:6.0f} ns/item; bound "
                f"{bound * 1e3:.3f} ms)  plain {tp * 1e3:8.3f} ms  "
                f"max|d|/max|ref| {rec['relerr']:.1e}"
                f"{'' if exact is None else f'; bitwise {exact}'}")
        else:
            log(f"  {mode:8s}: max|d|/max|ref| {rec['relerr']:.1e} (plain "
                f"version on the CPU, not timed)")
        out[mode] = rec
    return out


def probe_main(argv, default_modes: List[str], env_T: bool,
               description: str) -> Dict[str, dict]:
    """The shared command line of ``probe_kernel`` and ``probe_manual``."""
    import argparse
    import os

    from spada_tpu_torch.convert import check_device

    p = argparse.ArgumentParser(description=description)
    p.add_argument("modes", nargs="*", default=default_modes,
                   help=f"TPU mode names ({', '.join(TPU_MODES)}), with an "
                   f"optional suffix _par, or modes of the tensor-core "
                   f"block alone ({', '.join(MMA_MODES)}; "
                   f"{', '.join(F32_MODES)} with --dtype float32)")
    p.add_argument("--block", default="auto", choices=BLOCKS,
                   help="the block probed: mma (tensor cores), simt (FP32 "
                   "FMAs), auto (mma where it takes the tile shape)")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"], help="tile type")
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=65536, help="matrix order")
    p.add_argument("--band", type=int, default=384)
    p.add_argument("--T", type=int, default=(int(os.environ.get(
        "PROBE_T", "256")) if env_T else 256), help="tile edge")
    args = p.parse_args(argv)
    dev = check_device(args.device)
    slots = (6, 10) if args.T >= 384 else (12, 24)
    work = probe_work(args.n, args.band, args.T, dev,
                      dtype=getattr(torch, args.dtype), a_slots=slots[0],
                      b_slots=slots[1])
    return run_modes(work, args.modes, block=args.block)
