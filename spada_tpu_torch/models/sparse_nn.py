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
model and input, on a device.  :func:`make_sharded_train_step` is the
reference's step over a ('dp', 'tp') mesh, on torch.distributed.
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


def _next_input(h: torch.Tensor, spec: SparseLinearSpec) -> torch.Tensor:
    """``h`` padded with zero rows or trimmed to the input height of the
    layer ``spec``."""
    want = spec.n_k_tiles * spec.tk
    if h.shape[0] < want:
        return torch.nn.functional.pad(h, (0, 0, 0, want - h.shape[0]))
    return h[:want]


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
                h = _next_input(torch.relu(h), self.specs[i + 1])
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


class _CopyToTp(torch.autograd.Function):
    """A layer's input, replicated over tp: identity forward; backward, the
    all-reduce over tp of its cotangent, which on each rank holds only that
    rank's tiles' share."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        torch.distributed.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTp(torch.autograd.Function):
    """A layer's output: the all-reduce over tp of the ranks' partial
    products forward; identity backward, since the loss downstream is
    replicated over tp and each rank's cotangent is already the whole."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def make_sharded_train_step(model: SparseMLP, mesh, lr: float = 1e-3):
    """Training step over a ('dp', 'tp') mesh, this process being one rank:
    returns ``(step, shard_params)`` as the reference does.

    - The batch (columns of x and y) is split over dp: the rank at mesh
      coordinate (d, t) trains on the d-th block of columns.
    - Each layer's tiles are split over tp round-robin (tile i to tp rank
      i % n_tp) and padded to an equal count, as in the reference.
      ``shard_params`` is this rank's share, a list of [Tmax, tm, tk]
      tensors on the model's device: the reference's ``shard_params[i][t]``.
      Padded slots hold zero tiles aimed at tile (0, 0).
    - Forward: each rank multiplies its tiles; the partial outputs are
      all-reduced over tp.  Backward goes through a pair of autograd
      functions, Megatron's: at a layer's input an identity whose backward
      all-reduces the cotangent over tp (each rank's holds only its own
      tiles' share), at its output the all-reduce whose backward is the
      identity.  An all-reduce alone would give n_tp times the gradient at
      the last layer; one whose backward is the identity would drop the
      other ranks' share at every earlier layer.
    - Weight gradients are averaged over dp (the loss is the mean over the
      whole batch), and padded slots are masked out of the update: their
      forward contribution is nil, their gradient is not.

    ``step(params, x, y)`` takes this rank's params and the whole batch
    (x [in_pad, batch], y [out_pad, batch], batch a multiple of n_dp) and
    returns ``(new_params, loss)``, the loss over the whole batch.  A mesh
    dimension of one rank issues no collective.
    """
    from spada_tpu_torch.parallel.mesh import group_of, resolve_mesh

    dev = model.params[0].device
    mesh = resolve_mesh(mesh, tuple(mesh.shape), ("dp", "tp"), dev,
                        "make_sharded_train_step")
    n_dp, n_tp = mesh.shape
    d, t = mesh.get_coordinate()
    dp_group, tp_group = group_of(mesh, "dp"), group_of(mesh, "tp")

    shard_params, masks, trows, tcols = [], [], [], []
    for spec, tiles in zip(model.specs, model.params):
        n_tiles = tiles.shape[0]
        ix = np.arange(t, n_tiles, n_tp)
        tmax = max(1, -(-n_tiles // n_tp))
        buf = tiles.new_zeros((tmax,) + tuple(tiles.shape[1:]))
        buf[: len(ix)] = tiles.detach()[torch.from_numpy(ix).to(dev)]
        mask = tiles.new_zeros((tmax, 1, 1))
        mask[: len(ix)] = 1.0
        rows = np.zeros(tmax, np.int64)
        cols = np.zeros(tmax, np.int64)
        rows[: len(ix)] = spec.tile_row[ix]
        cols[: len(ix)] = spec.tile_col[ix]
        shard_params.append(buf)
        masks.append(mask)
        trows.append(torch.from_numpy(rows).to(dev))
        tcols.append(torch.from_numpy(cols).to(dev))

    def step(params, x: torch.Tensor, y: torch.Tensor):
        if x.shape[1] % n_dp:
            raise ValueError(f"batch {x.shape[1]} is not a multiple of "
                             f"n_dp = {n_dp}")
        w = x.shape[1] // n_dp
        h, yl = x[:, d * w:(d + 1) * w], y[:, d * w:(d + 1) * w]
        ps = [p.detach().requires_grad_() for p in params]
        for i, spec in enumerate(model.specs):
            if tp_group is not None:
                h = _CopyToTp.apply(h, tp_group)
            h = spmm(ps[i], spec, h, trows[i], tcols[i])
            if tp_group is not None:
                h = _ReduceFromTp.apply(h, tp_group)
            if i + 1 < len(model.specs):
                h = _next_input(torch.relu(h), model.specs[i + 1])
        loss = torch.mean((h - yl) ** 2)
        grads = torch.autograd.grad(loss, ps)
        loss = loss.detach()
        if dp_group is not None:
            for g in (*grads, loss):
                torch.distributed.all_reduce(g, group=dp_group)
                g /= n_dp
        with torch.no_grad():
            new = [p - lr * g * m for p, g, m in zip(params, grads, masks)]
        return new, loss

    return step, shard_params


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
