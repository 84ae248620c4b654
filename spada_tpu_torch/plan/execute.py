"""Plan execution: one tile-engine launch per distinct panel height.

The port of the execution half of :mod:`spada_tpu.plan.planner`
(``spada_tpu/plan/planner.py:197-368``).  ``_Segment``, ``PlanResult`` and
``_slice_rows_padded`` are copies of the reference's, held equal to it by
``tests/test_torch_host.py``; ``iter_plan_segments`` and ``execute_plan``
run the port's worklist builder and tile engines, and
``make_profiled_measure`` times them for ``plan_spgemm(scheme='profiled')``.
Planning itself (``plan_spgemm``, ``choose_tile_size``) is in
:mod:`spada_tpu_torch.plan.planner`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from spada_tpu_torch.config import SpadaConfig
from spada_tpu_torch.ops.worklist import build_worklist
from spada_tpu_torch.plan.planner import ExecutionPlan, PanelSpec
from spada_tpu_torch.sparse.bsr import BsrMatrix
from spada_tpu_torch.sparse.csr import CsrMatrix
from spada_tpu_torch.utils import trace


@dataclasses.dataclass
class _Segment:
    tm: int
    result: object                 # SpGemmResult
    tile_row_to_global: np.ndarray  # int64 [n_local_tile_rows] -> global row base


@dataclasses.dataclass
class PlanResult:
    """Mixed-panel-height SpGEMM result (same surface as SpGemmResult)."""

    shape: tuple
    segments: List[_Segment]
    n_work_items: int = 0
    mxu_flops: int = 0
    useful_flops: int = 0
    elapsed_s: Optional[float] = None
    # launch state retained for measure_device_perf reuse (one plan, one
    # BSR/worklist build per CLI run — VERDICT round-4 item 8)
    host_state: Optional[dict] = None

    def todense(self) -> np.ndarray:
        d = np.zeros(self.shape, np.float32)
        for seg in self.segments:
            tiles = np.asarray(seg.result.c_tiles)
            tn = seg.result.tn
            for t in range(tiles.shape[0]):
                g0 = int(seg.tile_row_to_global[seg.result.c_tile_row[t]])
                c0 = int(seg.result.c_tile_col[t]) * tn
                h = min(seg.tm, self.shape[0] - g0)
                w = min(tn, self.shape[1] - c0)
                if h > 0 and w > 0:
                    # += not =: a panel's last tile pads past the panel end
                    # into rows owned by another segment; padded rows are
                    # exactly zero, so accumulation composes segments safely
                    d[g0 : g0 + h, c0 : c0 + w] += tiles[t, :h, :w]
        return d

    def to_csr(self) -> CsrMatrix:
        rows_all, cols_all, vals_all = [], [], []
        for seg in self.segments:
            tiles = np.asarray(seg.result.c_tiles)
            t, r, c = np.nonzero(tiles)
            rows = seg.tile_row_to_global[seg.result.c_tile_row[t]] + r
            cols = seg.result.c_tile_col[t].astype(np.int64) * seg.result.tn + c
            keep = (rows < self.shape[0]) & (cols < self.shape[1])
            rows_all.append(rows[keep])
            cols_all.append(cols[keep])
            vals_all.append(tiles[t, r, c][keep])
        if rows_all:
            return CsrMatrix.from_coo(
                self.shape,
                np.concatenate(rows_all),
                np.concatenate(cols_all),
                np.concatenate(vals_all),
            )
        return CsrMatrix(self.shape, np.zeros(self.shape[0] + 1, np.int64), [], [])


def _slice_rows_padded(a: CsrMatrix, panels: List[PanelSpec], tm: int):
    """Stack the rows of all panels with this tm into one CSR, each panel
    padded with empty rows to a multiple of tm.  Returns (csr, tile_row_base)
    where tile_row_base[i] is the global row of local tile-row i."""
    lens = a.row_lens()
    seg_lens, seg_idx, bases = [], [], []
    for p in panels:
        n_rows = p.row_end - p.row_start
        n_tiles = -(-n_rows // tm)
        pad = n_tiles * tm - n_rows
        seg_lens.append(lens[p.row_start : p.row_end])
        if pad:
            seg_lens.append(np.zeros(pad, np.int64))
        seg_idx.append(
            np.arange(a.indptr[p.row_start], a.indptr[p.row_end], dtype=np.int64)
        )
        bases.extend(p.row_start + tm * np.arange(n_tiles))
    lens_local = np.concatenate(seg_lens) if seg_lens else np.zeros(0, np.int64)
    idx = np.concatenate(seg_idx) if seg_idx else np.zeros(0, np.int64)
    indptr = np.zeros(len(lens_local) + 1, np.int64)
    indptr[1:] = np.cumsum(lens_local)
    sub = CsrMatrix(
        (len(lens_local), a.shape[1]), indptr, a.indices[idx], a.data[idx]
    )
    return sub, np.asarray(bases, dtype=np.int64)


def iter_plan_segments(a: CsrMatrix, b_bsr: BsrMatrix, plan: ExecutionPlan):
    """Yield (tm, panels, bases, a_bsr, worklist) per panel-height group,
    with f32 host tiles (the device dtype is chosen at upload)."""
    by_tm = {}
    for p in plan.panels:
        by_tm.setdefault(p.tm, []).append(p)
    for tm, panels in sorted(by_tm.items()):
        with trace.span("layout.structure", tm=tm) as attrs:
            sub, bases = _slice_rows_padded(a, panels, tm)
            if sub.nnz == 0:
                continue
            a_bsr = BsrMatrix.from_csr(sub, tm, plan.tile_k, dtype=np.float32)
            wl = build_worklist(a_bsr, b_bsr, order="row")
            attrs.update(items=wl.n_items, c_tiles=wl.n_c_tiles)
        if wl.n_items == 0:
            continue
        yield tm, panels, bases, a_bsr, wl


def make_profiled_measure(a: CsrMatrix, b: CsrMatrix,
                          config: Optional[SpadaConfig] = None,
                          device="cuda"):
    """The ``measure`` callback of ``plan_spgemm(scheme='profiled')``
    (the port of the reference's function of the same name): the measured
    latency of the reference's scheme 3 (rowwise_perf_adjust.rs:121-231),
    collected per candidate before committing.

    B's tiles are built and uploaded once.  ``measure(row_start, row_end,
    tm)`` builds the span's tiles and worklist at panel height ``tm``,
    uploads them once, makes one warm call and returns the seconds of the
    auto engine on them: device seconds on CUDA events on a card
    (:func:`~spada_tpu_torch.utils.timing.cuda_time`), wall seconds on the
    CPU, as the reference times off its accelerator.  An empty worklist
    takes 0.0 s.
    """
    from spada_tpu_torch.convert import bsr_to_torch, check_device
    from spada_tpu_torch.ops.engine import prepare_worklist
    from spada_tpu_torch.ops.spgemm import tile_dtype
    from spada_tpu_torch.utils.timing import cuda_time

    config = config or SpadaConfig()
    dev = check_device(device)
    dtype = tile_dtype(config)
    b_bsr = BsrMatrix.from_csr(b, config.tile_k, config.tile_n,
                               dtype=np.float32)
    b_t = bsr_to_torch(b_bsr, dev, dtype)

    def measure(row_start: int, row_end: int, tm: int) -> float:
        sub, _ = _slice_rows_padded(
            a, [PanelSpec(row_start, row_end, tm)], tm)
        a_bsr = BsrMatrix.from_csr(sub, tm, config.tile_k, dtype=np.float32)
        wl = build_worklist(a_bsr, b_bsr, order="row")
        if wl.n_items == 0:
            return 0.0
        call = prepare_worklist(wl, bsr_to_torch(a_bsr, dev, dtype), b_t,
                                precision=config.precision)
        if dev.type == "cuda":
            return cuda_time(call, warmup=1, reps=3)[0]
        call()
        t0 = time.perf_counter()
        call()
        return time.perf_counter() - t0

    return measure


def execute_plan(a: CsrMatrix, b: CsrMatrix, plan: ExecutionPlan,
                 config: Optional[SpadaConfig] = None,
                 device="cuda") -> PlanResult:
    """Run every panel-height segment of ``plan`` on ``device``.

    The result holds host C tiles per segment, as the reference's does, and
    keeps each launch's host worklist and f32 tiles in ``host_state``
    (``{"segments": [(wl, a_tiles, b_tiles, tm)], "tk", "tn"}``) so a
    timing can rerun exactly these launches."""
    from spada_tpu_torch.convert import bsr_to_torch, c_tiles_to_numpy, check_device
    from spada_tpu_torch.ops.engine import run_worklist
    from spada_tpu_torch.ops.spgemm import (SpGemmResult, _count_useful_flops,
                                            _resolve_engine, tile_dtype)

    config = config or SpadaConfig()
    dev = check_device(device)
    engine = _resolve_engine(config)
    dtype = tile_dtype(config)

    b_bsr = BsrMatrix.from_csr(b, plan.tile_k, plan.tile_n, dtype=np.float32)
    b_t = bsr_to_torch(b_bsr, dev, dtype)

    segments = []
    host_segs = []
    n_work = 0
    mxu = 0
    t0 = time.perf_counter()
    for tm, panels, bases, a_bsr, wl in iter_plan_segments(a, b_bsr, plan):
        host_segs.append((wl, a_bsr.tiles, b_bsr.tiles, tm))
        # per-segment cost attribution (simulator.rs:589-603 analog)
        with trace.span("segment", tm=tm, n_panels=len(panels),
                        work_items=wl.n_items, c_tiles=wl.n_c_tiles):
            c_tiles = c_tiles_to_numpy(run_worklist(
                wl, bsr_to_torch(a_bsr, dev, dtype), b_t,
                precision=config.precision, engine=engine))
        res = SpGemmResult(
            shape=(a_bsr.shape[0], b.shape[1]), tm=tm, tn=plan.tile_n,
            c_tiles=c_tiles, c_tile_row=wl.c_tile_row,
            c_tile_col=wl.c_tile_col, tk=plan.tile_k,
            tile_itemsize=dtype.itemsize, n_work_items=wl.n_items,
        )
        segments.append(_Segment(tm, res, bases))
        n_work += wl.n_items
        mxu += 2 * wl.n_items * tm * plan.tile_k * plan.tile_n
    elapsed = time.perf_counter() - t0

    return PlanResult(
        shape=(a.shape[0], b.shape[1]),
        segments=segments,
        n_work_items=n_work,
        mxu_flops=mxu,
        useful_flops=_count_useful_flops(a, b),
        elapsed_s=elapsed,
        host_state={"segments": host_segs, "tk": plan.tile_k,
                    "tn": plan.tile_n},
    )
