"""Carry the host state of a run (tiles, worklists, stream operands) to
PyTorch tensors and back.

The host planners produce NumPy objects; the JAX package hands the same
objects to its device functions.  These helpers give the port's functions
the same inputs on a given device, so a test can feed one NumPy object to
both packages.  Nothing here picks a device: every function takes one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


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
    return host.to(device=dev, dtype=dtype).contiguous()


def stream_operands_to_torch(ops: Sequence[Tuple[np.ndarray, np.ndarray]],
                             device) -> tuple:
    """Per-class (a, b) stream operands -> a tuple of f32 tensor pairs."""
    dev = check_device(device)
    return tuple(
        (torch.from_numpy(np.ascontiguousarray(av, np.float32)).to(dev),
         torch.from_numpy(np.ascontiguousarray(bv, np.float32)).to(dev))
        for av, bv in ops)


def c_tiles_to_numpy(t) -> np.ndarray:
    """C tiles (a tensor on any device, or an array) -> host f32 array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(t, np.float32)
