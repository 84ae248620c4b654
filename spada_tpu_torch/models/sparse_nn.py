"""Block-sparse MLP: the flagship model, on PyTorch.

The single-device half of :mod:`spada_tpu.models.sparse_nn`.  A layer's
weight is block-sparse: its trainable parameter is the payload of its
nonzero tiles, [n_tiles, tm, tk] f32, at fixed tile coordinates, the same
BSR payloads the SpGEMM engine consumes.  ``spmm`` multiplies it by dense
column-major activations with plain tensor operations (the reference, too,
computes it outside any Pallas kernel, as a batched ``dot_general`` and a
scatter-add): gather x's k-slabs by tile column, one batched product with
the tiles, an index-add into row tiles.  Autograd through the three gives
the reference's ``jax.value_and_grad``: a tile's gradient exists only for
the tiles there are, and x's is the transposed block-sparse product.

The products are f32 as long as TF32 is off for matrix products
(``torch.backends.cuda.matmul.allow_tf32``, off by default), as the
reference's ``precision="highest"``.

:func:`entry` is the counterpart of ``__graft_entry__.entry``: the same
model and input, on a device.  The sharded training step
(``make_sharded_train_step``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spada_tpu_torch.convert import check_device
from spada_tpu_torch.sparse.bsr import BsrMatrix
from spada_tpu_torch.sparse.csr import CsrMatrix


@dataclasses.dataclass
class SparseLinearSpec:
    """Static structure of one block-sparse weight matrix [out, in]."""

    n_tile_rows: int     # out / tm
    n_k_tiles: int       # in / tk
    tm: int
    tk: int
    tile_row: np.ndarray  # int32 [n_tiles]
    tile_col: np.ndarray  # int32 [n_tiles] (k-tile index)

    @classmethod
    def from_bsr(cls, w: BsrMatrix) -> "SparseLinearSpec":
        return cls(
            n_tile_rows=w.n_tile_rows,
            n_k_tiles=w.n_tile_cols,
            tm=w.tm, tk=w.tn,
            tile_row=w.tile_rows(), tile_col=w.tile_col.astype(np.int32),
        )


def spmm(tiles: torch.Tensor, spec: SparseLinearSpec, x: torch.Tensor,
         tile_row: Optional[torch.Tensor] = None,
         tile_col: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = W @ x for block-sparse W (tile payloads ``tiles``) and dense x.

    ``tiles``: f32 [n_tiles, tm, tk]; ``x``: f32 [in_pad, batch] with
    in_pad = n_k_tiles * tk.  Returns [out_pad, batch].  ``tile_row`` and
    ``tile_col`` are the spec's coordinates as int64 tensors on x's device;
    without them they are uploaded from the spec on every call.
    """
    dev = x.device
    if tile_row is None:
        tile_row = torch.from_numpy(spec.tile_row.astype(np.int64)).to(dev)
    if tile_col is None:
        tile_col = torch.from_numpy(spec.tile_col.astype(np.int64)).to(dev)
    n = x.shape[1]
    xt = x.reshape(spec.n_k_tiles, spec.tk, n).index_select(0, tile_col)
    parts = torch.bmm(tiles, xt)                       # [n_tiles, tm, n]
    y = x.new_zeros((spec.n_tile_rows, spec.tm, n)).index_add(
        0, tile_row, parts)
    return y.reshape(spec.n_tile_rows * spec.tm, n)


def _live_k_tiles(prev_rows: Sequence[int], tm_prev: int, tk: int,
                  n_k_tiles: int) -> List[int]:
    """The k-tiles of a layer's input that the previous layer's live row
    panels (tile rows of height ``tm_prev``) write, after the pad/trim to
    ``n_k_tiles * tk`` rows."""
    live = set()
    for r in prev_rows:
        lo, hi = r * tm_prev // tk, ((r + 1) * tm_prev - 1) // tk
        live.update(range(lo, min(hi, n_k_tiles - 1) + 1))
    return sorted(live)


class SparseMLP(torch.nn.Module):
    """Block-sparse MLP acting on column-major activations [features,
    batch], ReLU between layers.  ``params`` holds each layer's tile
    payloads; each layer's tile coordinates are int64 buffers
    (``tile_row{i}``, ``tile_col{i}``) on the module's device."""

    def __init__(self, specs: Sequence[SparseLinearSpec], params,
                 device="cuda"):
        super().__init__()
        dev = check_device(device)
        self.specs = list(specs)
        self.params = torch.nn.ParameterList(
            torch.nn.Parameter(torch.from_numpy(
                np.ascontiguousarray(p, np.float32)).to(dev))
            for p in params)
        for i, spec in enumerate(self.specs):
            for name in ("tile_row", "tile_col"):
                self.register_buffer(f"{name}{i}", torch.from_numpy(
                    getattr(spec, name).astype(np.int64)).to(dev))

    @classmethod
    def from_density(cls, dims: Tuple[int, ...], density: float,
                     tm: int = 128, tk: int = 128, seed: int = 0,
                     device="cuda") -> "SparseMLP":
        """Random block-sparse MLP: dims = (in, hidden..., out), with the
        reference's generator calls, so for ``tm == tk`` its structure and
        payloads equal the reference's bit for bit.

        The connectivity guard rewires one tile onto a live input k-tile
        when a layer's kept k-tiles all miss the previous layer's nonzero
        output row panels (a structurally dead network computes exactly
        zero).  The live k-tiles are those the previous layer's live row
        panels cover; for ``tm == tk`` they are its tile rows, the
        reference's set.  The reference compares tm-granular rows with
        tk-granular k-tiles, which for ``tm != tk`` misses dead layers and
        rewires onto dead ones.
        """
        rng = np.random.default_rng(seed)
        specs, params = [], []
        prev_rows = None
        for fan_in, fan_out in zip(dims[:-1], dims[1:]):
            n_tr = -(-fan_out // tm)
            n_kt = -(-fan_in // tk)
            total = n_tr * n_kt
            n_keep = max(1, int(total * density))
            chosen = rng.choice(total, size=n_keep, replace=False)
            chosen.sort()
            trow = (chosen // n_kt).astype(np.int32)
            tcol = (chosen % n_kt).astype(np.int32)
            if prev_rows is not None:
                live = _live_k_tiles(prev_rows, tm, tk, n_kt)
                if live and not set(tcol.tolist()) & set(live):
                    tcol[0] = np.int32(rng.choice(live))
            prev_rows = sorted(set(trow.tolist()))
            scale = np.sqrt(2.0 / max(fan_in * density, 1.0))
            tiles = rng.standard_normal((n_keep, tm, tk)).astype(
                np.float32) * scale
            specs.append(SparseLinearSpec(n_tr, n_kt, tm, tk, trow, tcol))
            params.append(tiles)
        return cls(specs, params, device)

    @classmethod
    def from_csr_weights(cls, weights: List[CsrMatrix], tm: int = 128,
                         tk: int = 128, device="cuda") -> "SparseMLP":
        specs, params = [], []
        for w in weights:
            bsr = BsrMatrix.from_csr(w, tm, tk, dtype=np.float32)
            specs.append(SparseLinearSpec.from_bsr(bsr))
            params.append(bsr.tiles)
        return cls(specs, params, device)

    @property
    def in_pad(self) -> int:
        return self.specs[0].n_k_tiles * self.specs[0].tk

    @property
    def out_pad(self) -> int:
        return self.specs[-1].n_tile_rows * self.specs[-1].tm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [in_pad, batch] -> [out_pad, batch]; ReLU between layers."""
        h = x
        for i, spec in enumerate(self.specs):
            h = spmm(self.params[i], spec, h, getattr(self, f"tile_row{i}"),
                     getattr(self, f"tile_col{i}"))
            if i + 1 < len(self.specs):
                h = torch.relu(h)
                # pad/trim to the next layer's expected input height
                want = self.specs[i + 1].n_k_tiles * self.specs[i + 1].tk
                if h.shape[0] < want:
                    h = torch.nn.functional.pad(h, (0, 0, 0,
                                                    want - h.shape[0]))
                elif h.shape[0] > want:
                    h = h[:want]
        return h

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.mean((self.forward(x) - y) ** 2)


def make_train_step(model: SparseMLP, lr: float = 1e-3):
    """One SGD step on the tile payloads: ``step(x, y)`` updates ``model``
    in place and returns the loss before the update (a device scalar)."""

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        model.zero_grad(set_to_none=True)
        loss = model.loss(x, y)
        loss.backward()
        with torch.no_grad():
            for p in model.params:
                p -= lr * p.grad
        return loss.detach()

    return step


def entry(device="cuda"):
    """(forward, example_args) of the flagship model on ``device``: the
    counterpart of ``__graft_entry__.entry``, with its model ((512, 512,
    256), density 0.25, 128-edge tiles, seed 0) and its input (batch 64
    from ``default_rng(1)``)."""
    dev = check_device(device)
    model = SparseMLP.from_density((512, 512, 256), density=0.25, tm=128,
                                   tk=128, seed=0, device=dev)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (model.in_pad, 64)).astype(np.float32)).to(dev)
    return model.forward, (x,)
