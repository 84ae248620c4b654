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
``csrc/esc_stream.cu`` (:func:`esc_stream_mul`, :func:`esc_stream_red`),
one launch per class.  Beside each wrapper is its plain PyTorch version,
which the wrapper takes only for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from spada_tpu_torch import _build
from spada_tpu_torch.ops.element import EscPlan

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
    if a.shape != b.shape or a.dim() != 2:
        raise ValueError(f"{kernel}: operands must be two equal 2-D shapes, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"{kernel}: operands must be float32, got "
                        f"{a.dtype} and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"{kernel}: operands on {a.device} and {b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {a.device}")
    if a.device.type == "cuda":
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"{kernel}: operands must be contiguous")
        if a.shape[1] % 4 or a.data_ptr() % 16 or b.data_ptr() % 16:
            raise ValueError(f"{kernel}: rows must be a multiple of 4 floats "
                             f"on 16-byte aligned storage")


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


def esc_stream_red(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L >= 2 class: column sums of a * b over the L rows ([L, n_pad] f32 ->
    [1, n_pad]).  CUDA tensors run ``csrc/esc_stream.cu``; CPU tensors the
    plain version."""
    _check_operands(a, b, "esc_stream_red")
    if a.device.type == "cpu":
        return esc_stream_red_reference(a, b)
    L, n_pad = a.shape
    out = torch.empty((1, n_pad), dtype=torch.float32, device=a.device)
    if n_pad == 0:
        return out
    if L == 0:
        return out.zero_()
    lib = _build.load()
    status = lib.esc_stream_red(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                L, n_pad, _build.current_stream(a))
    _build.check(status, "esc_stream_red")
    _build.launches["esc_stream_red"] += 1
    return out


def stream_execute(layout: StreamLayout, operands) -> tuple:
    """Per-class chunk values, one launch per class, in class order.

    ``operands``: a tuple of (a, b) tensor pairs in the stream layout
    (:func:`spada_tpu_torch.convert.stream_operands_to_torch`).  Returns a
    tuple, not one concatenated tensor: a device concatenate would stream
    the whole output once more.
    """
    return tuple(esc_stream_mul(av, bv) if c["L"] == 1
                 else esc_stream_red(av, bv)
                 for c, (av, bv) in zip(layout.classes, operands))


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
