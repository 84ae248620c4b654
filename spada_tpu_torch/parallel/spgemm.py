"""Sharded SpGEMM over a (dp, tp) mesh, on torch.distributed.

The port of :mod:`spada_tpu.parallel.spgemm`.  One process per rank; every
rank calls :func:`spgemm_sharded` with the same
:class:`~spada_tpu_torch.parallel.partition.ShardedProblem` and computes its
own shard (d, t):

- **dp** (A's row panels) is communication-free: each dp panel owns its C
  tiles.
- **tp** (k slabs): the tp ranks of a panel hold k-partial C tiles, merged
  by ``reduce_scatter_tensor`` over the tp group (the default; each tp rank
  keeps a contiguous range of C tiles) or by ``all_reduce`` (``merge=
  'psum'``).  With one tp rank there is no collective.

Per rank (:func:`sharded_rank`) the worklist drops its padding items (those
aimed at the dump slot ``nCmax``, whose products are exactly zero), is
stable-sorted by C tile as ``spada_tpu/parallel/cached.py:71`` sorts it,
and runs on the CUDA tile kernel ``tile_spgemm`` (``engine='cached'`` or
``'auto'``), or on the plain scatter-add engine (``'xla'``).  The
reference's Belady slot plans and its 70k-item launch cap are TPU
machinery and have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from spada_tpu_torch.convert import c_tiles_to_numpy, check_device
from spada_tpu_torch.ops.engine import prepare_cached, run_worklist_reference
from spada_tpu_torch.parallel.mesh import gather, group_of, resolve_mesh
from spada_tpu_torch.parallel.partition import ShardedProblem
from spada_tpu_torch.sparse.csr import CsrMatrix

_MERGES = ("reduce_scatter", "psum")


@dataclasses.dataclass
class ShardedResult:
    """C tiles per dp panel plus assembly metadata."""

    problem: ShardedProblem
    c_tiles: np.ndarray       # [n_dp, nCmax+1, tm, tn] (last slot = dump)

    def todense(self) -> np.ndarray:
        p = self.problem
        d = np.zeros(p.shape, np.float32)
        for dp in range(p.n_dp):
            nC = int(p.n_c_tiles[dp])
            for t in range(nC):
                r0 = int(p.row_base[dp]) + int(self.c_tile_row[dp, t]) * p.tm
                c0 = int(self.c_tile_col[dp, t]) * p.tn
                h = min(p.tm, p.shape[0] - r0)
                w = min(p.tn, p.shape[1] - c0)
                if h > 0 and w > 0:
                    d[r0 : r0 + h, c0 : c0 + w] += self.c_tiles[dp, t, :h, :w]
        return d

    @property
    def c_tile_row(self):
        return self.problem.c_tile_row

    @property
    def c_tile_col(self):
        return self.problem.c_tile_col

    def to_csr(self) -> CsrMatrix:
        p = self.problem
        rows_all, cols_all, vals_all = [], [], []
        for dp in range(p.n_dp):
            nC = int(p.n_c_tiles[dp])
            tiles = self.c_tiles[dp, :nC]
            t, r, c = np.nonzero(tiles)
            rows = p.row_base[dp] + p.c_tile_row[dp, t].astype(np.int64) * p.tm + r
            cols = p.c_tile_col[dp, t].astype(np.int64) * p.tn + c
            keep = (rows < p.shape[0]) & (cols < p.shape[1])
            rows_all.append(rows[keep])
            cols_all.append(cols[keep])
            vals_all.append(tiles[t, r, c][keep])
        if not rows_all:
            return CsrMatrix(
                p.shape, np.zeros(p.shape[0] + 1, np.int64), [], []
            )
        return CsrMatrix.from_coo(
            p.shape,
            np.concatenate(rows_all),
            np.concatenate(cols_all),
            np.concatenate(vals_all),
        )


def resolve_engine(engine: str) -> str:
    """'auto' -> 'cached': an entry point runs the CUDA tile kernel on the
    device it is given (its plain version on the CPU), where the
    reference's 'auto' picks 'xla' off the TPU."""
    if engine not in ("auto", "cached", "xla"):
        raise ValueError(f"unknown engine {engine!r}")
    return "cached" if engine == "auto" else engine


def tile_dtype(engine: str, engine_dtype: Optional[torch.dtype]
               ) -> torch.dtype:
    """The tiles' dtype on the device: bf16 by default for the kernel, as
    the reference's cached engine; f32 always for the plain engine."""
    if engine == "xla":
        return torch.float32
    return engine_dtype or torch.bfloat16


def prepare_segment(a_tiles: torch.Tensor, b_tiles: torch.Tensor, a_tid,
                    b_tid, o_tid, n_c_tiles: int, engine: str,
                    chunk: int = 1024) -> Callable[..., torch.Tensor]:
    """C tiles [n_c_tiles, tm, tn] f32 of one padded worklist, as a call:
    the items aimed at the dump slot ``n_c_tiles - 1`` are dropped (their
    products are exactly zero, so the dump tile stays zero), the rest
    stable-sorted by C tile for ``tile_spgemm`` (``engine='cached'``) or run
    ``chunk`` items per ``bmm`` by the plain engine (``'xla'``).  Ids are
    checked and uploaded here, once.  The call takes, in place of
    ``b_tiles``, other B tiles of the same shape, dtype and device."""
    o_tid = np.asarray(o_tid)
    keep = o_tid != n_c_tiles - 1
    a, b, o = (np.asarray(x)[keep] for x in (a_tid, b_tid, o_tid))
    if engine == "cached":
        order = np.argsort(o, kind="stable")
        return prepare_cached(a_tiles, b_tiles, a[order], b[order], o[order],
                              n_c_tiles)
    ids = [torch.from_numpy(x.astype(np.int64)).to(a_tiles.device)
           for x in (a, b, o)]
    tm, tk, tn = a_tiles.shape[1], a_tiles.shape[2], b_tiles.shape[2]
    chunk_bytes = chunk * (tm * tk + tk * tn + tm * tn) * 4
    return lambda b_now=b_tiles: run_worklist_reference(
        a_tiles, b_now, *ids, n_c_tiles, chunk_bytes=chunk_bytes)


def sharded_rank(problem: ShardedProblem, d: int, t: int, device,
                 engine: str = "cached",
                 engine_dtype: Optional[torch.dtype] = None,
                 chunk: int = 1024) -> Callable[..., torch.Tensor]:
    """Rank (d, t)'s body: a call giving its k-partial C tiles [nCmax + 1,
    tm, tn] f32 on ``device``, before the tp merge.  Its tiles and ids are
    uploaded here, once; the call only launches.  No collective."""
    dev = check_device(device)
    engine = resolve_engine(engine)
    dtype = tile_dtype(engine, engine_dtype)
    p = problem
    a = torch.from_numpy(np.ascontiguousarray(p.a_tiles[d, t])).to(dev, dtype)
    b = torch.from_numpy(np.ascontiguousarray(p.b_tiles[d, t])).to(dev, dtype)
    return prepare_segment(a, b, p.a_tid[d, t], p.b_tid[d, t], p.o_tid[d, t],
                           p.nCmax + 1, engine, chunk)


def merge_tp(c: torch.Tensor, mesh, merge: str) -> torch.Tensor:
    """Combine the tp ranks' k-partial C tiles.  ``'reduce_scatter'`` pads
    the tile dim to a multiple of tp and leaves each tp rank its range of
    summed tiles; ``'psum'`` all-reduces, so every tp rank holds all.  One
    tp rank: nothing to merge, no collective."""
    group = group_of(mesh, "tp")
    if group is None:
        return c
    n_tp = mesh.shape[1]
    if merge == "reduce_scatter":
        pad = (-c.shape[0]) % n_tp
        if pad:
            c = torch.cat([c, c.new_zeros((pad,) + tuple(c.shape[1:]))])
        out = c.new_empty((c.shape[0] // n_tp,) + tuple(c.shape[1:]))
        dist.reduce_scatter_tensor(out, c, group=group)
        return out
    dist.all_reduce(c, group=group)
    return c


def spgemm_sharded(
    problem: ShardedProblem,
    mesh=None,
    device="cuda",
    chunk: int = 1024,
    merge: str = "reduce_scatter",
    engine: str = "auto",
    engine_dtype: Optional[torch.dtype] = None,
) -> ShardedResult:
    """Execute a partitioned SpGEMM, this process being one rank of the
    mesh; every rank returns the whole result.

    ``mesh``: a ``DeviceMesh`` of shape (n_dp, n_tp) named ('dp', 'tp'), or
    None for that mesh over the default process group, whose world size must
    be n_dp·n_tp.  ``engine``: 'cached' and 'auto' run ``tile_spgemm`` per
    rank on ``engine_dtype`` tiles (bf16 by default, f32 sums; C is f32,
    where the reference writes bf16 C on a one-tp mesh); 'xla' the plain f32
    scatter-add engine, ``chunk`` items per ``bmm``.  ``merge``: see
    :func:`merge_tp`.
    """
    if merge not in _MERGES:
        raise ValueError(f"unknown merge {merge!r}")
    engine = resolve_engine(engine)
    dev = check_device(device)
    p = problem
    mesh = resolve_mesh(mesh, (p.n_dp, p.n_tp), ("dp", "tp"), dev,
                        "spgemm_sharded")
    d, t = mesh.get_coordinate()
    c = sharded_rank(p, d, t, dev, engine, engine_dtype, chunk)()
    c = merge_tp(c, mesh, merge)
    g = gather(c, mesh)                     # [n_dp * n_tp, rows, tm, tn]
    if merge == "reduce_scatter" and p.n_tp > 1:
        # tp ranks hold consecutive tile ranges: concatenate them back
        g = g.reshape((p.n_dp, -1) + tuple(g.shape[2:]))
    else:
        g = g.reshape((p.n_dp, p.n_tp) + tuple(g.shape[1:]))[:, 0]
    return ShardedResult(problem=p,
                         c_tiles=c_tiles_to_numpy(g)[:, : p.nCmax + 1])
