"""Carry the host state of a run (tiles, worklists, stream operands) to
PyTorch tensors and back.

The host planners produce NumPy objects; the JAX package hands the same
objects to its device functions.  These helpers give the port's functions
the same inputs on a given device, so a test can feed one NumPy object to
both packages; :func:`from_reference` turns the JAX package's host objects
into the port's.  Nothing here picks a device: every function takes one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from spada_tpu_torch.utils import trace


@dataclasses.dataclass
class DeviceWorkList:
    """A worklist's index arrays on a device (int32)."""

    a_tid: torch.Tensor              # [W]
    b_tid: torch.Tensor              # [W]
    o_tid: torch.Tensor              # [W]
    tile_ptr: Optional[torch.Tensor]  # [n_c_tiles + 1]; row order only
    n_c_tiles: int
    order: str

    @property
    def n_items(self) -> int:
        return int(self.a_tid.shape[0])


def check_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for ``dev``'s queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def tile_ptr_of(o_tid: np.ndarray, n_c_tiles: int) -> np.ndarray:
    """int32 [n_c_tiles + 1]: each C tile's item range in an o-sorted
    worklist (``spada_tpu/ops/engine.py:940-942``); empty runs give
    lo == hi."""
    return np.searchsorted(np.asarray(o_tid),
                           np.arange(n_c_tiles + 1)).astype(np.int32)


def item_ptr_of(o_tid: np.ndarray, n_c_tiles: int, ogroup: int
                ) -> np.ndarray:
    """int32 [ceil(n_c_tiles / ogroup) + 1]: each group of ``ogroup``
    consecutive C tiles' item range in an o-sorted worklist
    (``spada_tpu/ops/engine.py:427-430``); a group with no items gives
    lo == hi."""
    if ogroup < 1:
        raise ValueError(f"ogroup must be >= 1, got {ogroup}")
    n_groups = -(-n_c_tiles // ogroup)
    return np.searchsorted(np.asarray(o_tid),
                           np.arange(n_groups + 1) * ogroup).astype(np.int32)


def worklist_to_torch(wl, device) -> DeviceWorkList:
    """Either package's ``WorkList`` -> :class:`DeviceWorkList` on
    ``device``."""
    dev = check_device(device)

    def ids(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)

    tile_ptr = (ids(tile_ptr_of(wl.o_tid, wl.n_c_tiles))
                if wl.order == "row" else None)
    return DeviceWorkList(ids(wl.a_tid), ids(wl.b_tid), ids(wl.o_tid),
                          tile_ptr, int(wl.n_c_tiles), wl.order)


def bsr_to_torch(bsr, device, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """A ``BsrMatrix``'s tile payload [n_tiles, tm, tn] on ``device``.

    The host tiles may be f32 or bf16 (``ml_dtypes``); they are widened to
    f32 on the host and rounded to ``dtype`` by PyTorch, which rounds to
    nearest even as ``ml_dtypes`` does.
    """
    dev = check_device(device)
    host = torch.from_numpy(np.ascontiguousarray(bsr.tiles, np.float32))
    with trace.span("layout.upload", bytes=host.numel() * dtype.itemsize):
        return host.to(device=dev, dtype=dtype).contiguous()


def stream_operands_to_torch(ops: Sequence[Tuple[np.ndarray, np.ndarray]],
                             device) -> tuple:
    """Per-class (a, b) stream operands -> a tuple of f32 tensor pairs."""
    dev = check_device(device)
    with trace.span("layout.upload",
                    bytes=sum(4 * (av.size + bv.size) for av, bv in ops)):
        return tuple(
            (torch.from_numpy(np.ascontiguousarray(av, np.float32)).to(dev),
             torch.from_numpy(np.ascontiguousarray(bv, np.float32)).to(dev))
            for av, bv in ops)


def from_reference(obj):
    """The port's host object equal to ``obj``, a ``CsrMatrix``,
    ``BsrMatrix``, ``ExecutionPlan`` (with its panels), ``EscPlan``, or a
    partitioned problem (``ShardedProblem``, ``HaloProblem``,
    ``ElementDpProblem`` with its plans) of the JAX package.

    The attributes are read as NumPy arrays and numbers, so any object of
    those shapes converts; nothing of the JAX package is imported.  Arrays
    are shared, not copied, where their dtype already matches."""
    from spada_tpu_torch.ops.element import EscBucket, EscPlan
    from spada_tpu_torch.parallel.element_dp import ElementDpProblem
    from spada_tpu_torch.parallel.halo import HaloProblem
    from spada_tpu_torch.parallel.partition import ShardedProblem
    from spada_tpu_torch.plan.planner import ExecutionPlan, PanelSpec
    from spada_tpu_torch.sparse.bsr import BsrMatrix
    from spada_tpu_torch.sparse.csr import CsrMatrix

    if hasattr(obj, "a_stacked"):
        return _fields_of(ElementDpProblem, obj,
                          plans=[from_reference(p) for p in obj.plans])
    if hasattr(obj, "send_idx"):
        return _fields_of(HaloProblem, obj)
    if hasattr(obj, "work_per_shard"):
        return _fields_of(ShardedProblem, obj)
    if hasattr(obj, "buckets"):
        return _fields_of(EscPlan, obj, buckets=[
            _fields_of(EscBucket, bk) for bk in obj.buckets])
    if hasattr(obj, "panels"):
        return ExecutionPlan(
            [PanelSpec(int(p.row_start), int(p.row_end), int(p.tm))
             for p in obj.panels],
            int(obj.tile_k), int(obj.tile_n), dict(obj.meta))
    if hasattr(obj, "tile_rowptr"):
        return BsrMatrix(
            (int(obj.shape[0]), int(obj.shape[1])), int(obj.tm), int(obj.tn),
            np.asarray(obj.tiles), np.asarray(obj.tile_col),
            np.asarray(obj.tile_rowptr), np.asarray(obj.nnz_per_tile))
    if hasattr(obj, "indptr"):
        return CsrMatrix(obj.shape, np.asarray(obj.indptr),
                         np.asarray(obj.indices), np.asarray(obj.data))
    raise TypeError(f"from_reference: no port counterpart for "
                    f"{type(obj).__name__}")


def _fields_of(cls, obj, **given):
    """``cls`` (a dataclass) with each field read from ``obj``'s attribute
    of that name, unless ``given``: arrays as NumPy arrays, lists and tuples
    element by element, other values as they are."""
    def plain(x):
        if isinstance(x, (list, tuple)):
            return type(x)(plain(v) for v in x)
        if hasattr(x, "__array__") and not np.isscalar(x):
            return np.asarray(x)
        return x

    return cls(**{f.name: given[f.name] if f.name in given
                  else plain(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)})


def sparse_mlp_from_reference(model, device):
    """The port's ``SparseMLP`` on ``device`` with the structure and the
    parameters of ``model``, a ``SparseMLP`` of the JAX package (its specs,
    and its params as arrays of any kind NumPy reads)."""
    from spada_tpu_torch.models.sparse_nn import SparseLinearSpec, SparseMLP

    specs = [SparseLinearSpec(int(s.n_tile_rows), int(s.n_k_tiles),
                              int(s.tm), int(s.tk),
                              np.asarray(s.tile_row, np.int32),
                              np.asarray(s.tile_col, np.int32))
             for s in model.specs]
    return SparseMLP(specs, [np.asarray(p, np.float32) for p in model.params],
                     device)


def c_tiles_to_numpy(t) -> np.ndarray:
    """C tiles (a tensor on any device, or an array) -> host f32 array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(t, np.float32)
