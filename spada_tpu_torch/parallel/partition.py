"""Host-side partitioning of one SpGEMM over a (dp, tp) device mesh.

Copy of :mod:`spada_tpu.parallel.partition` for spada_tpu_torch, held equal
to it by ``tests/test_torch_host.py``; the strategy chooser calls the port's
own ``dispatch_dataflow`` and ``partition_halo``.  The port's device side
(:mod:`spada_tpu_torch.parallel.spgemm`) drops the padding items again and
runs each rank's worklist on the CUDA tile kernel.  The text below is the
reference's.

Everything data-dependent happens here, before jit: per-shard tile arrays and
worklists are built with NumPy and padded to uniform static shapes so the
device program is a fixed-shape shard_map.  Null work items point at a
reserved zero A-tile and a reserved dump C-tile, so padding is mathematically
inert (0 @ B accumulated into a discarded tile).

The dp split balances *work items* (tile products), not rows — the analog of
the reference's cost-balanced block shapes rather than naive equal rows.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from spada_tpu_torch.config import SpadaConfig
from spada_tpu_torch.sparse.bsr import BsrMatrix
from spada_tpu_torch.sparse.csr import CsrMatrix


@dataclasses.dataclass
class ShardedProblem:
    """Static-shape device inputs for one sharded SpGEMM.

    Array layouts (leading dims are mesh dims; ``S = n_dp * n_tp`` shards):
      a_tiles  f32 [n_dp, n_tp, Amax, tm, tk]   (slot Amax-1 is all-zero)
      b_tiles  f32 [n_dp, n_tp, Bmax, tk, tn]   (slot Bmax-1 is all-zero)
      a_tid/b_tid/o_tid  i32 [n_dp, n_tp, Wmax]
      (o_tid == nCmax marks the dump tile; valid ids are per-dp C-tile slots)
    Per-dp symbolic C structure:
      c_tile_row/c_tile_col  i32 [n_dp, nCmax]  (-1 marks padding slots)
    """

    n_dp: int
    n_tp: int
    tm: int
    tk: int
    tn: int
    shape: Tuple[int, int]
    a_tiles: np.ndarray
    b_tiles: np.ndarray
    a_tid: np.ndarray
    b_tid: np.ndarray
    o_tid: np.ndarray
    c_tile_row: np.ndarray
    c_tile_col: np.ndarray
    row_base: np.ndarray        # int64 [n_dp] first global row of each dp panel
    n_c_tiles: np.ndarray       # int64 [n_dp] valid C tiles per dp
    work_per_shard: np.ndarray  # int64 [n_dp, n_tp] true work items
    nCmax: int
    Wmax: int

    @property
    def imbalance(self) -> float:
        """max/mean work per shard — 1.0 is perfect balance."""
        w = self.work_per_shard
        return float(w.max() / max(w.mean(), 1e-9)) if w.size else 1.0


def _balanced_row_splits(work_per_tile_row: np.ndarray, n_dp: int) -> List[int]:
    """Contiguous split of tile-rows into n_dp chunks with ~equal work."""
    cum = np.concatenate([[0], np.cumsum(work_per_tile_row)])
    total = cum[-1]
    bounds = [0]
    for d in range(1, n_dp):
        target = total * d / n_dp
        bounds.append(int(np.searchsorted(cum, target)))
    bounds.append(len(work_per_tile_row))
    # enforce monotonicity (degenerate distributions)
    for i in range(1, len(bounds)):
        bounds[i] = max(bounds[i], bounds[i - 1])
    return bounds


def partition_spgemm(
    a: CsrMatrix,
    b: CsrMatrix,
    n_dp: int,
    n_tp: int = 1,
    config: Optional[SpadaConfig] = None,
    tm: Optional[int] = None,
) -> ShardedProblem:
    config = config or SpadaConfig()
    tm = tm or config.default_tm
    tk, tn = config.tile_k, config.tile_n

    a_bsr = BsrMatrix.from_csr(a, tm, tk, dtype=np.float32)
    b_bsr = BsrMatrix.from_csr(b, tk, tn, dtype=np.float32)
    a_rows = a_bsr.tile_rows()
    b_fan = np.diff(b_bsr.tile_rowptr)                      # B tiles per k
    # work per A tile = fanout of its k; work per tile-row = sum over its tiles
    per_tile_work = b_fan[a_bsr.tile_col.astype(np.int64)]
    work_per_tile_row = np.zeros(a_bsr.n_tile_rows, np.int64)
    np.add.at(work_per_tile_row, a_rows.astype(np.int64), per_tile_work)
    dp_bounds = _balanced_row_splits(work_per_tile_row, n_dp)

    # tp: contiguous k-tile slabs balanced by B tile count
    k_work = np.maximum(b_fan, 1)
    tp_bounds = _balanced_row_splits(k_work, n_tp)

    n_k_tiles = b_bsr.n_tile_rows

    # ---- per-dp: symbolic C space is the union over all k (tp-independent)
    per_dp = []
    for d in range(n_dp):
        r0, r1 = dp_bounds[d], dp_bounds[d + 1]
        sel = (a_rows >= r0) & (a_rows < r1)
        per_dp.append((r0, r1, np.nonzero(sel)[0]))

    shard_data = []   # [(a_tiles, b_tiles, a_tid, b_tid, o_tid, W)]
    dp_meta = []      # (c_row, c_col, nC)
    for d in range(n_dp):
        r0, r1, a_sel = per_dp[d]
        # local-A CSR-free worklist against full B to get the C-tile space
        ti_all = a_rows[a_sel].astype(np.int64) - r0
        k_all = a_bsr.tile_col[a_sel].astype(np.int64)
        # expand against full B for symbolic C
        fan = b_fan[k_all]
        Wd = int(fan.sum())
        if Wd:
            rep = np.repeat(np.arange(len(a_sel)), fan)
            starts = b_bsr.tile_rowptr[k_all]
            offs = np.arange(Wd) - np.repeat(np.cumsum(fan) - fan, fan)
            b_ids_full = np.repeat(starts, fan) + offs
            ti_full = ti_all[rep]
            tj_full = b_bsr.tile_col[b_ids_full].astype(np.int64)
            out_key = ti_full * b_bsr.n_tile_cols + tj_full
            uniq = np.unique(out_key)
            o_full = np.searchsorted(uniq, out_key)
        else:
            b_ids_full = np.zeros(0, np.int64)
            ti_full = tj_full = out_key = uniq = np.zeros(0, np.int64)
            o_full = np.zeros(0, np.int64)
            rep = np.zeros(0, np.int64)
        c_row = (uniq // b_bsr.n_tile_cols).astype(np.int32)
        c_col = (uniq % b_bsr.n_tile_cols).astype(np.int32)
        dp_meta.append((c_row, c_col, len(uniq)))

        k_full = k_all[rep] if Wd else np.zeros(0, np.int64)
        for t in range(n_tp):
            k0, k1 = tp_bounds[t], tp_bounds[t + 1]
            wsel = (k_full >= k0) & (k_full < k1)
            # local A tiles for this shard: those with k in slab
            asel_local = np.nonzero((k_all >= k0) & (k_all < k1))[0]
            a_remap = np.full(len(a_sel), -1, np.int64)
            a_remap[asel_local] = np.arange(len(asel_local))
            a_tid_l = a_remap[rep[wsel]]
            # local B tiles for this shard
            bsel_local = np.nonzero(
                (b_bsr.tile_rows() >= k0) & (b_bsr.tile_rows() < k1)
            )[0]
            b_remap = np.full(b_bsr.n_tiles, -1, np.int64)
            b_remap[bsel_local] = np.arange(len(bsel_local))
            b_tid_l = b_remap[b_ids_full[wsel]]
            assert (a_tid_l >= 0).all() and (b_tid_l >= 0).all()
            shard_data.append((
                a_bsr.tiles[a_sel[asel_local]],
                b_bsr.tiles[bsel_local],
                a_tid_l, b_tid_l, o_full[wsel],
            ))

    nCmax = max((m[2] for m in dp_meta), default=0) or 1
    Amax = max((len(s[0]) for s in shard_data), default=0) + 1
    Bmax = max((len(s[1]) for s in shard_data), default=0) + 1
    Wmax = max((len(s[2]) for s in shard_data), default=0) or 1

    a_tiles = np.zeros((n_dp, n_tp, Amax, tm, tk), np.float32)
    b_tiles = np.zeros((n_dp, n_tp, Bmax, tk, tn), np.float32)
    a_tid = np.full((n_dp, n_tp, Wmax), Amax - 1, np.int32)
    b_tid = np.full((n_dp, n_tp, Wmax), Bmax - 1, np.int32)
    o_tid = np.full((n_dp, n_tp, Wmax), nCmax, np.int32)
    c_tile_row = np.full((n_dp, nCmax), -1, np.int32)
    c_tile_col = np.full((n_dp, nCmax), -1, np.int32)
    work = np.zeros((n_dp, n_tp), np.int64)

    for d in range(n_dp):
        c_row, c_col, nC = dp_meta[d]
        c_tile_row[d, :nC] = c_row
        c_tile_col[d, :nC] = c_col
        for t in range(n_tp):
            at, bt, ai, bi, oi = shard_data[d * n_tp + t]
            a_tiles[d, t, : len(at)] = at
            b_tiles[d, t, : len(bt)] = bt
            W = len(ai)
            a_tid[d, t, :W] = ai
            b_tid[d, t, :W] = bi
            o_tid[d, t, :W] = oi
            work[d, t] = W

    return ShardedProblem(
        n_dp=n_dp, n_tp=n_tp, tm=tm, tk=tk, tn=tn,
        shape=(a.shape[0], b.shape[1]),
        a_tiles=a_tiles, b_tiles=b_tiles,
        a_tid=a_tid, b_tid=b_tid, o_tid=o_tid,
        c_tile_row=c_tile_row, c_tile_col=c_tile_col,
        row_base=np.array([dp_bounds[d] * tm for d in range(n_dp)], np.int64),
        n_c_tiles=np.array([m[2] for m in dp_meta], np.int64),
        work_per_shard=work, nCmax=nCmax, Wmax=Wmax,
    )


def choose_parallel_strategy(
    a: CsrMatrix,
    b: CsrMatrix,
    n_dev: int,
    config: Optional[SpadaConfig] = None,
    tm: Optional[int] = None,
):
    """Pick the distributed strategy by modeled cost — the reference's
    dataflow adaptivity lifted to the distributed axis (SURVEY.md
    §2.3/§5.8).

    - element_dp (dp = n_dev): scattered structure that the density
      dispatch routes to the element engine distributes by E-balanced row
      slabs with ZERO collectives (parallel/element_dp.py) — always the
      winner when the element engine wins per-chip.
    - reduce, (dp = n_dev/2, tp = 2): every dp panel's C tiles ride one
      psum over tp; ring all-reduce moves ~2*(tp-1)/tp of the C-tile bytes.
    - halo (dp = n_dev): each remotely-needed B tile moves once.

    Returns (strategy, details).
    """
    from spada_tpu_torch.parallel.halo import partition_halo

    config = config or SpadaConfig()
    if config.element_dispatch == "auto":
        from spada_tpu_torch.ops.spgemm import dispatch_dataflow

        choice, det = dispatch_dataflow(a, b, config)
        if choice == "element":
            return "element_dp", {
                "halo_bytes": 0, "reduce_bytes": 0,
                "element_e_products": det["element"]["e_products"],
                "comm_bytes": 0,  # row slabs share nothing
            }
    tm = tm or config.default_tm
    tk, tn = config.tile_k, config.tile_n

    halo = partition_halo(a, b, n_dev, config, tm=tm)
    # padded slots are what actually ride the ICI (per-offset ppermute
    # capacities keep padding near the true count, unlike a global cap)
    halo_bytes = halo.halo_tiles_padded * tk * tn * 4

    n_tp = 2 if n_dev % 2 == 0 else 1
    n_dp = n_dev // n_tp
    red = partition_spgemm(a, b, n_dp, n_tp, config, tm=tm)
    c_bytes = int(red.n_c_tiles.sum()) * tm * tn * 4
    reduce_bytes = int(2 * (n_tp - 1) / max(n_tp, 1) * c_bytes)

    details = {
        "halo_bytes": halo_bytes,
        "reduce_bytes": reduce_bytes,
        "halo_problem": halo,
        "reduce_problem": red,
    }
    return ("halo" if halo_bytes < reduce_bytes else "reduce"), details
