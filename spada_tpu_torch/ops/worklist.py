"""Host-side symbolic phase: tile-level work-list construction.

A mirror of :mod:`spada_tpu.ops.worklist`, kept array-for-array equal to it
by ``tests/test_torch_worklist.py``.

The whole multiply schedule is planned up front as a flat list of tile
products, sorted so that the partial sums of one output tile are a
*consecutive* run: the CUDA tile kernel then keeps a C tile's accumulator in
registers for the whole run and writes it once.

Work item w: C[out ⟵ ti,tj] += A_tile[a_tid[w]] @ B_tile[b_tid[w]].

Orderings (the dataflow axis of the reference's ``Accelerator`` enum,
frontend.rs:36-41):
- row-major (``spada``/``rowwise``/``ip``): sorted by output tile, k inner —
  output-stationary Gustavson; one accumulator per C tile.
- k-major (``op``): outer-product order, k outermost — partials for one output
  tile are non-consecutive, so the engine must scatter-accumulate.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from spada_tpu_torch.sparse.bsr import BsrMatrix


@dataclasses.dataclass
class WorkList:
    """Flat tile-product schedule plus the symbolic structure of C."""

    a_tid: np.ndarray       # int32 [W] index into A.tiles
    b_tid: np.ndarray       # int32 [W] index into B.tiles
    o_tid: np.ndarray       # int32 [W] index into C tiles (dense-id space)
    first: np.ndarray       # int32 [W] 1 where o_tid starts a new run
    # symbolic C structure (one entry per nonzero C tile)
    c_tile_row: np.ndarray  # int32 [nC]
    c_tile_col: np.ndarray  # int32 [nC]
    n_c_tiles: int
    order: str              # 'row' | 'k'

    @property
    def n_items(self) -> int:
        return int(len(self.a_tid))


def build_worklist(a: BsrMatrix, b: BsrMatrix, order: str = "row") -> WorkList:
    """Join A's tile columns against B's tile rows.

    For every nonzero A tile (ti, k) and every nonzero B tile (k, tj) emit a
    work item targeting C tile (ti, tj).  This *is* the symbolic SpGEMM at
    tile granularity: the set of distinct (ti, tj) is exactly the nonzero
    tile structure of C (two-phase symbolic+numeric, SURVEY.md §7.3).
    """
    if a.tn != b.tm:
        raise ValueError(
            f"tile-K mismatch: A tiles are (?,{a.tn}), B tiles ({b.tm},?)")
    a_rows = a.tile_rows()                      # [nA] tile-row ti of each A tile
    a_k = a.tile_col.astype(np.int64)           # [nA] tile-col = contraction tile k
    b_lens = np.diff(b.tile_rowptr)             # B tiles per k row
    # drop A tiles whose k row in B is empty
    counts = b_lens[a_k]                        # [nA] fan-out of each A tile
    keep = counts > 0
    a_ids = np.nonzero(keep)[0]
    counts = counts[keep]
    W = int(counts.sum())
    if W == 0:
        return WorkList(
            a_tid=np.zeros(0, np.int32), b_tid=np.zeros(0, np.int32),
            o_tid=np.zeros(0, np.int32), first=np.zeros(0, np.int32),
            c_tile_row=np.zeros(0, np.int32), c_tile_col=np.zeros(0, np.int32),
            n_c_tiles=0, order=order,
        )
    # expand: work item w -> (A tile, B tile)
    a_tid = np.repeat(a_ids, counts)            # [W]
    # ranges b_tile_rowptr[k] .. +len for each expanded A tile
    starts = b.tile_rowptr[a_k[a_ids]]
    offset_in_item = np.arange(W) - np.repeat(np.cumsum(counts) - counts, counts)
    b_tid = (np.repeat(starts, counts) + offset_in_item).astype(np.int64)

    ti = a_rows[a_tid].astype(np.int64)
    tj = b.tile_col[b_tid].astype(np.int64)
    k = a_k[a_tid]
    out_key = ti * b.n_tile_cols + tj

    if order == "row":
        perm = np.lexsort((k, out_key))
    elif order == "k":
        perm = np.lexsort((out_key, k))
    else:
        raise ValueError(f"unknown order {order!r}")
    a_tid, b_tid, out_key = a_tid[perm], b_tid[perm], out_key[perm]

    uniq_keys = np.unique(out_key)
    o_tid = np.searchsorted(uniq_keys, out_key).astype(np.int32)
    first = np.zeros(W, dtype=np.int32)
    if order == "row":
        first[0] = 1
        first[1:] = (o_tid[1:] != o_tid[:-1]).astype(np.int32)
    # (k-major order never has a valid 'first' structure; engine must scatter)

    return WorkList(
        a_tid=a_tid.astype(np.int32),
        b_tid=b_tid.astype(np.int32),
        o_tid=o_tid,
        first=first,
        c_tile_row=(uniq_keys // b.n_tile_cols).astype(np.int32),
        c_tile_col=(uniq_keys % b.n_tile_cols).astype(np.int32),
        n_c_tiles=int(len(uniq_keys)),
        order=order,
    )
