"""Stream executor for the element (ESC) numeric phase, on CUDA kernels.

The layout half (``StreamLayout``, ``_class_geometry``,
``build_stream_layout``, ``stream_operands``, ``stream_to_csr``) mirrors
:mod:`spada_tpu.ops.element_stream` and is held equal to it by
``tests/test_torch_element.py``:

- L = 1: operands reshaped ``[rows, 1024]``, output the same shape.
- L >= 2: operands TRANSPOSED to ``[L, n_pad]``: chunks on the fast axis,
  the products of a chunk down the rows.  On a GPU this is already the
  coalesced layout: neighbouring threads own neighbouring chunks.

Each class pads N up to its block width with zero products (sentinel gather
index -> 0.0 operands); pad chunks map to CSR position 0 with value 0*0 = 0,
so ``np.add.at`` extraction stays exact.

The device half replaces the Pallas ``_mul_kernel``/``_red_kernel`` with
``csrc/esc_stream.cu``: :func:`esc_stream_mul` and :func:`esc_stream_red`
launch one class, and :func:`esc_stream_group`, which :func:`stream_execute`
calls, every class of a multiply in one launch (:func:`group_table` lays the
classes out over the grid).  Beside each wrapper is its plain PyTorch
version, which the wrapper takes only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spada_tpu_torch import _build
from spada_tpu_torch.ops.element import EscPlan
from spada_tpu_torch.utils import trace

_LANES = 1024          # L=1 row width
_BLOCK_BYTES = 1 << 23  # ~8 MB operand blocks (sets the padding granule)


@dataclasses.dataclass
class StreamLayout:
    """Padded device operand layout + extraction map for one ESC plan."""

    classes: List[dict]          # per class: L, n, n_pad, block (shape meta)
    esc_to_csr: np.ndarray       # [sum(padded chunks)] int32, pads -> 0
    nnz_c: int
    indptr: np.ndarray
    indices: np.ndarray
    shape: Tuple[int, int]
    n_products: int
    n_padded: int                # padded product slots actually streamed

    def operand_bytes(self, itemsize: int = 4, out_itemsize: int = 4) -> int:
        """Device bytes one execution streams (padded operands + outputs)."""
        return sum(2 * c["n_pad"] * c["L"] * itemsize
                   + c["n_pad"] * out_itemsize for c in self.classes)


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


_MIN_STEPS = 32   # blocks per class: padding <= 1 block <= ~3% of the class


def _class_geometry(L: int, n: int) -> dict:
    """Block shape for one class: (rows-per-block, lanes) and padded N.

    Blocks cap at ~8 MB per operand and shrink for small classes so a class
    spans >= ``_MIN_STEPS`` blocks — the padding (one partial block) then
    stays under ~3% of the class.
    """
    if L == 1:
        rows0 = _pad_to(n, _LANES) // _LANES
        br = min(_BLOCK_BYTES // (4 * _LANES),            # 2048 rows
                 max(8, _pad_to(-(-rows0 // _MIN_STEPS), 8)))
        rows = _pad_to(rows0, br)
        return {"L": 1, "n": n, "n_pad": rows * _LANES, "rows": rows,
                "br": br}
    chl = min(max(128, (_BLOCK_BYTES // (4 * L)) // 128 * 128),
              max(128, _pad_to(-(-n // _MIN_STEPS), 128)))
    n_pad = _pad_to(n, chl)
    return {"L": L, "n": n, "n_pad": n_pad, "chl": chl}


@trace.spanned("layout.structure")
def build_stream_layout(plan: EscPlan) -> StreamLayout:
    """Geometry + padded extraction map (structure only, value-free)."""
    classes = [_class_geometry(bk.L, bk.a_gidx.shape[0])
               for bk in plan.buckets]
    parts = []
    base = 0
    for bk, c in zip(plan.buckets, classes):
        n = c["n"]
        seg = np.zeros(c["n_pad"], np.int32)
        seg[:n] = plan.esc_to_csr[base : base + n]
        parts.append(seg)
        base += n
    esc_to_csr = (np.concatenate(parts) if parts
                  else np.zeros(0, np.int32))
    return StreamLayout(
        classes=classes, esc_to_csr=esc_to_csr, nnz_c=plan.nnz_c,
        indptr=plan.indptr, indices=plan.indices, shape=plan.shape,
        n_products=plan.n_products,
        n_padded=sum(c["n_pad"] * c["L"] for c in classes),
    )


def stream_operands(layout: StreamLayout, plan: EscPlan, a, b,
                    dtype=np.float32) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Gather operand values into the padded stream layout (host, per value
    refresh).  L=1 -> [rows, 1024]; L>=2 -> transposed [L, n_pad]."""
    with trace.span("layout.fill", products=layout.n_products):
        a_ext = np.append(a.data, 0.0).astype(dtype)
        b_ext = np.append(b.data, 0.0).astype(dtype)
        out = []
        for bk, c in zip(plan.buckets, layout.classes):
            n, L = c["n"], c["L"]
            if L == 1:
                av = np.zeros(c["n_pad"], dtype)
                bv = np.zeros(c["n_pad"], dtype)
                av[:n] = a_ext[bk.a_gidx[:, 0]]
                bv[:n] = b_ext[bk.b_gidx[:, 0]]
                out.append((av.reshape(c["rows"], _LANES),
                            bv.reshape(c["rows"], _LANES)))
            else:
                av = np.zeros((L, c["n_pad"]), dtype)
                bv = np.zeros((L, c["n_pad"]), dtype)
                av[:, :n] = a_ext[bk.a_gidx].T
                bv[:, :n] = b_ext[bk.b_gidx].T
                out.append((av, bv))
        return out


# --------------------------------------------------------------------------
# Kernels and their plain versions
# --------------------------------------------------------------------------

def esc_stream_mul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`esc_stream_mul`."""
    return a * b


def esc_stream_red_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`esc_stream_red`: [L, n] -> [1, n]."""
    return (a * b).sum(0, keepdim=True)


def _check_operands(a: torch.Tensor, b: torch.Tensor, kernel: str) -> None:
    # on the host's path of every multiply: each attribute is read once
    shape, dev = a.shape, a.device
    if shape != b.shape or len(shape) != 2:
        raise ValueError(f"{kernel}: operands must be two equal 2-D shapes, "
                         f"got {tuple(shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{kernel}: operands must be float32, got "
                        f"{a.dtype} and {b.dtype}")
    if dev != b.device:
        raise ValueError(f"{kernel}: operands on {dev} and {b.device}")
    if dev.type == "cuda":
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"{kernel}: operands must be contiguous")
        if shape[1] % 4 or a.data_ptr() % 16 or b.data_ptr() % 16:
            raise ValueError(f"{kernel}: rows must be a multiple of 4 floats "
                             f"on 16-byte aligned storage")
    elif dev.type != "cpu":
        raise ValueError(f"{kernel}: unsupported device {dev}")


def esc_stream_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L = 1 class: elementwise a * b ([rows, 1024] f32).  CUDA tensors run
    ``csrc/esc_stream.cu``; CPU tensors the plain version."""
    _check_operands(a, b, "esc_stream_mul")
    if a.device.type == "cpu":
        return esc_stream_mul_reference(a, b)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    lib = _build.load()
    status = lib.esc_stream_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                a.numel(), _build.current_stream(a))
    _build.check(status, "esc_stream_mul")
    _build.launches["esc_stream_mul"] += 1
    return out


# what csrc/esc_stream.cu launches: threads of a red or grouped block, the
# most row slices of a red block, the rows a thread loads before it adds,
# the float4s of a grouped mul block, the classes of one grouped launch
_THREADS = 256
_RED_MAX_SLICES = 32
_RED_GROUP = 4
_GROUP_MUL_FLOAT4 = 2 * _THREADS
MAX_GROUP_CLASSES = 16
# a class is split over row slices while it has fewer threads than this (two
# blocks an SM): measured on the localized power-law pair's classes on an
# H100, whole columns per thread were 8-10% faster than a split from 55,000
# float4 columns up, and a split faster below 2,000 (PERF.md)
_RED_TARGET_THREADS = 1 << 16


def red_slices(L: int, n4: int) -> int:
    """Row slices of a red block for a class of ``L`` rows by ``n4`` float4
    columns: the rows are split, in powers of two that divide L and leave a
    slice two rows or more, while the class has too few columns to fill the
    card with threads."""
    slices = 1
    while (slices < _RED_MAX_SLICES and L % (4 * slices) == 0
           and n4 * slices < _RED_TARGET_THREADS):
        slices *= 2
    return slices


def red_group(L: int, slices: int) -> int:
    """Rows a red thread loads before its first add (and its independent
    sums): the largest power of two up to 4 that divides its rows."""
    rows = L // slices
    return next(g for g in (_RED_GROUP, 2, 1) if rows % g == 0)


def esc_stream_red(a: torch.Tensor, b: torch.Tensor,
                   slices: Optional[int] = None,
                   group: Optional[int] = None) -> torch.Tensor:
    """L >= 2 class: column sums of a * b over the L rows ([L, n_pad] f32 ->
    [1, n_pad]).  CUDA tensors run ``csrc/esc_stream.cu``; CPU tensors the
    plain version.  ``slices`` and ``group`` are the block shape
    (:func:`red_slices`, :func:`red_group` by default); the probe sweeps
    them (``tools/probe_pallas_stream.py``)."""
    _check_operands(a, b, "esc_stream_red")
    if a.device.type == "cpu":
        return esc_stream_red_reference(a, b)
    L, n_pad = a.shape
    out = torch.empty((1, n_pad), dtype=torch.float32, device=a.device)
    if n_pad == 0:
        return out
    if L == 0:
        return out.zero_()
    slices = slices or red_slices(L, n_pad // 4)
    lib = _build.load()
    status = lib.esc_stream_red(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                L, n_pad, slices,
                                group or red_group(L, slices),
                                _build.current_stream(a))
    _build.check(status, "esc_stream_red")
    _build.launches["esc_stream_red"] += 1
    return out


def group_table(classes: Sequence[Tuple[int, int]],
                order: Optional[Sequence[int]] = None) -> Tuple[np.ndarray,
                                                                int]:
    """The grid of one grouped launch over ``classes``, (L, n) pairs with n
    the elements of an L = 1 class or the chunk columns ``n_pad`` of an
    L >= 2 class, a multiple of 4.

    Returns (table, n_blocks): ``table`` is int64 [k, 6], one row per class
    that has elements, in grid order, with the columns (class index, L, n4,
    slices, group, first_block); a class's blocks are ``first_block`` up to
    the next row's.  An L = 1 block multiplies ``_GROUP_MUL_FLOAT4``
    float4s; a block of an L >= 2 class sums ``256 / slices`` float4
    columns.  ``order`` lists class indices in grid order; by default the
    classes keep the order they come in.  A plan's classes come by
    ascending L, so the large classes of short blocks lead and the small
    ones of long blocks fill in as they drain; measured on an H100 that
    order and its reverse tie, and long blocks first is 3% slower
    (PERF.md; ``tools/probe_pallas_stream.block_shape_sweep`` reruns it).
    """
    if len(classes) > MAX_GROUP_CLASSES:
        raise ValueError(f"esc_stream_group takes at most "
                         f"{MAX_GROUP_CLASSES} classes, got {len(classes)}")
    rows = {}
    for i, (L, n) in enumerate(classes):
        if L < 1 or n < 0 or n % 4:
            raise ValueError(f"class {i}: L={L}, n={n}; need L >= 1 and n a "
                             f"non-negative multiple of 4")
        if n == 0:
            continue
        n4 = n // 4
        if L == 1:
            slices, group, per = 1, 1, _GROUP_MUL_FLOAT4
        else:
            slices = red_slices(L, n4)
            group, per = red_group(L, slices), _THREADS // slices
        rows[i] = [i, L, n4, slices, group, -(-n4 // per)]
    if order is None:
        order = list(rows)
    elif sorted(order) != sorted(rows):
        raise ValueError(f"order {list(order)} is not a permutation of the "
                         f"classes with elements, {sorted(rows)}")
    table = np.array([rows[i] for i in order], np.int64).reshape(-1, 6)
    n_blocks = int(table[:, 5].sum())
    table[:, 5] = np.cumsum(table[:, 5]) - table[:, 5]
    if n_blocks > 0x7FFFFFFF:
        raise ValueError(f"esc_stream_group: {n_blocks} blocks exceed a grid")
    return table, n_blocks


@functools.lru_cache(maxsize=64)
def _group_launch_of(classes: tuple, order: Optional[tuple]) -> tuple:
    """(table rows as tuples, n_blocks): what a launch needs beside the
    pointers, kept per class list so that a repeated multiply computes it
    once."""
    table, n_blocks = group_table(classes, order)
    return tuple(map(tuple, table.tolist())), n_blocks


def esc_stream_group(pairs, Ls: Sequence[int],
                     order: Optional[Sequence[int]] = None) -> tuple:
    """Every class of a multiply in one launch: ``pairs[i]`` are the (a, b)
    operands of a class of ``Ls[i]`` products per chunk, [rows, cols] for
    L = 1 (multiplied elementwise) and [L, n_pad] otherwise (summed over the
    rows).  Returns one tensor per class, as :func:`esc_stream_mul` and
    :func:`esc_stream_red` would, bit for bit.  CUDA tensors run
    ``esc_stream_group`` of ``csrc/esc_stream.cu``; CPU tensors the plain
    versions.  ``order``: see :func:`group_table`."""
    t = (trace.launch("esc_stream_group", classes=len(pairs))
         if trace.active() else None)
    try:
        if len(pairs) != len(Ls):
            raise ValueError(f"esc_stream_group: {len(pairs)} operand pairs "
                             f"for {len(Ls)} classes")
        if not pairs:
            return ()
        for (a, b), L in zip(pairs, Ls):
            _check_operands(a, b, "esc_stream_group")
            if L != 1 and a.shape[0] != L:
                raise ValueError(f"esc_stream_group: a class of L={L} has "
                                 f"operands {tuple(a.shape)}")
        dev = pairs[0][0].device
        if any(a.device != dev for a, _ in pairs):
            raise ValueError("esc_stream_group: classes on several devices")
        if dev.type == "cpu":
            if t is not None:
                t.step("launch.call", block="plain")
            return tuple(esc_stream_mul_reference(a, b) if L == 1
                         else esc_stream_red_reference(a, b)
                         for (a, b), L in zip(pairs, Ls))
        classes = tuple((L, a.numel() if L == 1 else a.shape[1])
                        for (a, _), L in zip(pairs, Ls))
        rows, n_blocks = _group_launch_of(
            classes, None if order is None else tuple(order))
        if t is not None:
            t.step("launch.alloc")
        outs = tuple(torch.empty_like(a) if L == 1
                     else a.new_empty((1, a.shape[1]))
                     for (a, _), L in zip(pairs, Ls))
        if n_blocks == 0:
            return outs
        if t is not None:
            t.step("launch.call")
        args = []
        for i, L, n4, slices, group, first in rows:
            args += (pairs[i][0].data_ptr(), pairs[i][1].data_ptr(),
                     outs[i].data_ptr(), L, n4, slices, group, first)
        table = (ctypes.c_longlong * len(args))(*args)
        status = _build.load().esc_stream_group(
            table, len(rows), n_blocks, _build.current_stream(outs[0]))
        _build.check(status, "esc_stream_group")
        _build.launches["esc_stream_group"] += 1
        return outs
    finally:
        if t is not None:
            t.end()


def stream_execute(layout: StreamLayout, operands) -> tuple:
    """Per-class chunk values in class order, all classes in one launch
    (:func:`esc_stream_group`).

    ``operands``: a tuple of (a, b) tensor pairs in the stream layout
    (:func:`spada_tpu_torch.convert.stream_operands_to_torch`).  Returns a
    tuple, not one concatenated tensor: the consumers take the classes one
    by one.
    """
    return esc_stream_group(operands, [c["L"] for c in layout.classes])


def stream_execute_reference(layout: StreamLayout, operands) -> tuple:
    """Plain version of :func:`stream_execute`, on any device."""
    return tuple(esc_stream_mul_reference(av, bv) if c["L"] == 1
                 else esc_stream_red_reference(av, bv)
                 for c, (av, bv) in zip(layout.classes, operands))


# --------------------------------------------------------------------------
# Extraction
# --------------------------------------------------------------------------

def stream_values_host(values) -> np.ndarray:
    """Flatten per-class outputs to one host array in padded esc order
    (class-concatenated; L=1 blocks flatten row-major)."""
    from spada_tpu_torch.convert import c_tiles_to_numpy

    parts = [c_tiles_to_numpy(v).reshape(-1) for v in values]
    return (np.concatenate(parts) if parts else np.zeros(0, np.float32))


def stream_to_csr(layout: StreamLayout, values):
    """Extraction: combine padded chunk values into the CSR data array
    (pads add 0.0 at position 0 — exact)."""
    from spada_tpu_torch.sparse.csr import CsrMatrix

    data = np.zeros(max(layout.nnz_c, 1), np.float64)
    np.add.at(data, layout.esc_to_csr,
              stream_values_host(values).astype(np.float64))
    return CsrMatrix(layout.shape, layout.indptr, layout.indices,
                     data[: layout.nnz_c].astype(np.float32))


@dataclasses.dataclass
class StreamResult:
    """Element-path result: host plan and layout, per-class device values."""

    plan: EscPlan
    layout: StreamLayout
    values: tuple
    elapsed_s: Optional[float] = None

    def to_csr(self):
        return stream_to_csr(self.layout, self.values)

    def todense(self) -> np.ndarray:
        return self.to_csr().todense()
