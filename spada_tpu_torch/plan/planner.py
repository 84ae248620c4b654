"""The adaptive planner: row groups -> per-group panel heights -> execution.

This is the TPU-native re-realization of the Spada adaptive scheduler: where
the simulator adjusts block shapes *during* execution from per-block feedback
(scheduler.rs:667-727 dispatching to the four adjust schemes), the planner
makes the same decision *before* jit execution so the device graph stays
static:

- ``scheme='analytic'`` (default): sweep every candidate panel height per row
  group through the exact tile-engine byte model
  (:func:`spada_tpu.plan.estimator.panel_cost_model`) and commit the argmin —
  the closed-form equivalent of scheme 0's sample-then-commit.
- ``scheme='profiled'``: measure actual kernel latency per candidate on a
  sampled prefix of each wide group (the scheme-3 signal,
  rowwise_perf_adjust.rs:121-231) and commit the argmin latency/element.

``execute_plan`` then runs one engine launch per distinct panel height
(static shapes per launch) and stitches the block-sparse results.

Copy of the planning half of :mod:`spada_tpu.plan.planner` for
spada_tpu_torch, held equal to it by ``tests/test_torch_host.py``; only
the imports differ.  The execution half (``PlanResult``, ``_Segment``,
``_slice_rows_padded``, ``iter_plan_segments``, ``execute_plan``) is in
:mod:`spada_tpu_torch.plan.execute`, with ``make_profiled_measure``, which
times the port's device engines.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np

from spada_tpu_torch.config import SpadaConfig
from spada_tpu_torch.plan.estimator import BTileStructure, panel_cost_model
from spada_tpu_torch.plan.groups import parse_group
from spada_tpu_torch.sparse.bsr import BsrMatrix
from spada_tpu_torch.sparse.csr import CsrMatrix


@dataclasses.dataclass
class PanelSpec:
    row_start: int
    row_end: int
    tm: int


@dataclasses.dataclass
class ExecutionPlan:
    panels: List[PanelSpec]
    tile_k: int = 128
    tile_n: int = 128
    meta: dict = dataclasses.field(default_factory=dict)

    def tm_histogram(self) -> dict:
        h: dict = {}
        for p in self.panels:
            h[p.tm] = h.get(p.tm, 0) + (p.row_end - p.row_start)
        return h


def plan_spgemm(
    a: CsrMatrix,
    b: CsrMatrix,
    config: Optional[SpadaConfig] = None,
    scheme: str = "analytic",
    measure: Optional[Callable[[int, int, int], float]] = None,
) -> ExecutionPlan:
    """Produce per-row-group panel heights.

    ``measure(row_start, row_end, tm) -> seconds`` enables profile-guided
    planning ('profiled'); required there, ignored for 'analytic'.
    """
    config = config or SpadaConfig()
    groups = parse_group(a.row_lens(), config.var_factor)
    bt = BTileStructure(b, config.tile_k, config.tile_n)
    itemsize = 2 if config.engine_dtype == "bfloat16" else 4

    def span_cost(s: int, e: int, tm: int) -> float:
        if scheme == "profiled" and measure is not None:
            # sample a prefix of the span (sample_num panels' worth)
            span = min(e - s, config.sample_num * tm)
            return measure(s, s + span, tm) / max(span, 1) * (e - s)
        return panel_cost_model(a, s, e, tm, bt, itemsize=itemsize,
                                config=config)["cost"]

    def best_for(s: int, e: int):
        best_tm, best_cost, per_tm = config.default_tm, float("inf"), {}
        for tm in config.tm_choices:
            c = span_cost(s, e, tm)
            per_tm[tm] = c
            if c < best_cost:
                best_cost, best_tm = c, tm
        return best_tm, best_cost, per_tm

    panels: List[PanelSpec] = []
    costs: List[float] = []
    group_costs = []
    for gi in groups.groups:
        s, e = gi.row_range
        if a.get_ele_num(s, e) == 0:
            panels.append(PanelSpec(s, e, config.default_tm))
            costs.append(0.0)
            continue
        best_tm, best_cost, per_tm = best_for(s, e)
        group_costs.append(per_tm)
        panels.append(PanelSpec(s, e, best_tm))
        costs.append(best_cost)

    # Agglomerative coalescing: a group is at most one panel tall to the
    # per-group argmin above, so it cannot see that fusing neighbors into a
    # TALLER shared panel collapses duplicate k-tile fan-out (the global
    # W reduction behind big tiles).  This is the batch analog of the
    # reference's narrow-group neighbor comparison
    # (rowwise_adjust.rs:209-255): merge adjacent spans while the union
    # models faster than the parts.
    if scheme == "analytic":
        improved = True
        while improved and len(panels) > 1:
            improved = False
            out_p, out_c = [panels[0]], [costs[0]]
            for p, c in zip(panels[1:], costs[1:]):
                q, cq = out_p[-1], out_c[-1]
                if q.row_end == p.row_start:
                    u_tm, u_cost, _ = best_for(q.row_start, p.row_end)
                    if u_cost < (cq + c) * 0.98:
                        out_p[-1] = PanelSpec(q.row_start, p.row_end, u_tm)
                        out_c[-1] = u_cost
                        improved = True
                        continue
                out_p.append(p)
                out_c.append(c)
            panels, costs = out_p, out_c

        # Global uniform candidate: pairwise greedy merging can stall in a
        # local minimum while the single whole-matrix panel span (which
        # collapses ALL duplicate k-fanout across groups) models cheaper —
        # the planner must never do worse than its own uniform choice
        # (round-5: the mixed rmat plan carried 2x the work items of
        # uniform T and measured 1.4x slower)
        if len(panels) > 1 and a.shape[0] > 0:
            u_tm, u_cost, _ = best_for(0, a.shape[0])
            if u_cost < sum(costs):
                panels = [PanelSpec(0, a.shape[0], u_tm)]
                costs = [u_cost]

    # merge adjacent same-height groups into single panels
    merged: List[PanelSpec] = []
    for p in panels:
        if merged and merged[-1].tm == p.tm and merged[-1].row_end == p.row_start:
            merged[-1] = PanelSpec(merged[-1].row_start, p.row_end, p.tm)
        else:
            merged.append(p)
    return ExecutionPlan(
        merged, config.tile_k, config.tile_n,
        meta={"scheme": scheme, "n_groups": groups.n_groups,
              "group_costs": group_costs},
    )


# ----------------------------------------------------------------------------
# Matrix-level tile-size selection
# ----------------------------------------------------------------------------

def choose_tile_size(
    a: CsrMatrix,
    b: CsrMatrix,
    config: Optional[SpadaConfig] = None,
    candidates=(128, 256, 384, 512),
):
    """Pick the MXU tile edge T for this matrix pair.

    The reference adapts block shapes to sparsity structure cycle-by-cycle;
    on TPU the equivalent matrix-level decision is the tile granularity:
    bigger tiles amortize the measured per-work-item overhead but pay
    padding bytes/FLOPs on sparse structure.  Cost model (round-4,
    validated within 1% on the banded-64k hardware sweep,
    tools/probe_item_overhead.py):

        t(T) = max(unique_bytes(T) / BW,  mxu(T))  +  W(T) * t_item(T)

    where unique_bytes counts each distinct nonzero A/B tile once (the
    Belady cache gets reuse ~free at these working-set sizes) plus the C
    writeback, mxu = 2 W T^3 / peak, and t_item is the measured per-item
    non-MXU overhead (config.engine_item_overhead_s).  The overhead term
    ADDS to the max of the streaming/compute bounds — the per-item
    scalar->MXU->VPU chain does not overlap them (measured: predictions
    5.02/3.05/1.98/1.82 ms vs 5.03/3.05/1.98/1.81 measured at
    T=128/256/384/512).  An earlier max-of-three-terms model, fitted
    under the old timing harness whose phantom operand pass grew with
    tile bytes, systematically biased the choice toward small T.

    Returns (T, details dict).
    """
    from spada_tpu_torch.sparse.bsr import tiles_of_csr

    config = config or SpadaConfig()
    details = {}
    best_t, best_cost = candidates[0], float("inf")
    itemsize = 2 if config.engine_dtype == "bfloat16" else 4
    for T in candidates:
        _, a_cols, _ = tiles_of_csr(a, T, T)
        b_rows_t, _, _ = tiles_of_csr(b, T, T)
        b_fan = np.bincount(b_rows_t, minlength=-(-b.shape[0] // T))
        W = int(b_fan[a_cols].sum())
        # count only tiles the worklist actually touches: A tiles whose k
        # has B fanout, and B tiles in k-rows some A tile reaches — the
        # full-n_b count overestimated the streaming bound on structures
        # with partial A/B overlap and biased T selection (ADVICE round-4)
        n_a = int((b_fan[a_cols] > 0).sum())
        n_b = int(b_fan[np.unique(a_cols)].sum())
        # symbolic nC at this granularity is <= W; approximate with the
        # nnz-tile count of the (cheap) boolean product bound: use W as an
        # upper bound and the A-tile-row x B-tile-col grid as a floor
        n_c_est = min(W, (-(-a.shape[0] // T)) * (-(-b.shape[1] // T)))
        unique_bytes = (n_a + n_b + n_c_est) * T * T * itemsize
        t_item = config.engine_item_overhead_s.get(
            T, 0.18e-6 * (T / 128) ** 1.5
        )
        t = (max(unique_bytes / config.hbm_bytes_per_s,
                 2 * W * T ** 3 / config.peak_flops_bf16)
             + W * t_item)
        details[T] = {"W": W, "bytes": unique_bytes, "t_est": t}
        if t < best_cost:
            best_cost, best_t = t, T
    return best_t, details


# ----------------------------------------------------------------------------
# Column-window planning for the outer-product dataflow (schemes 1/2)
# ----------------------------------------------------------------------------

def plan_op_dataflow(
    a: CsrMatrix,
    b: CsrMatrix,
    config: Optional[SpadaConfig] = None,
    scheme: Optional[int] = None,
    max_anchors: int = 512,
):
    """Drive the ``op`` dataflow's A-panel height with the colwise policies.

    The reference's column-wise schemes hill-climb block/window heights
    against the blocks to the LEFT while marching k-major
    (colwise_reg_adjust.rs:47-109, colwise_irr_adjust.rs:47-110).  TPU
    realization: the same policy objects, fed the closed-form traffic cost
    of each visited (row-band, k-block) anchor, commit per-anchor heights
    ahead of jit; the modal committed height (element-weighted), scaled by
    the v5e sublane granule (8 rows is the narrowest efficient bf16 tile),
    becomes the op engine's panel height ``tm``.  This replaces the former
    hard-coded ``tm=8`` so schemes 1/2 decide something real.

    Returns ``(tm, details)``.
    """
    from spada_tpu_torch.plan.policy import (BlockFeedback, ColwiseIrrPolicy,
                                       ColwiseRegPolicy, traffic_cost)
    from spada_tpu_torch.plan.topo import BlockTopoTracker

    config = config or SpadaConfig()
    if scheme is None:
        scheme = config.adjust_scheme if config.adjust_scheme in (1, 2) else 1
    bw = config.colwise_block_width
    n_rows = a.shape[0]
    b_row_lens = np.diff(b.indptr).astype(np.int64)
    topo = BlockTopoTracker()
    if scheme == 2:
        pol = ColwiseIrrPolicy(config.lane_num, config.group_diviser, bw)
    else:
        pol = ColwiseRegPolicy(config.lane_num, bw)

    def irr_height(row_s: int, anchor_col: int) -> int:
        # scheme 2 reads the group's remembered shape off-boundary; seed it
        # if this sampled traversal skipped the boundary anchor
        gid = row_s // pol.group_size
        if row_s % pol.group_size != 0 and gid not in pol.group_shape:
            pol.group_shape[gid] = (pol.lane_num, pol.block_width)
        h, w = pol.adjust_block_shape(row_s, anchor_col, n_rows, topo)
        # every anchor placed in topo must have a known shape (off-boundary
        # anchors reuse the group shape without committing one themselves)
        pol.block_shape[(row_s, anchor_col)] = (h, w)
        return h

    height_votes: dict = {}
    token = 0
    row_s = 0
    band_h = config.lane_num
    while row_s < n_rows and token < max_anchors:
        # march k-blocks left->right inside this row band
        lo, hi = a.indptr[row_s], a.indptr[min(row_s + band_h, n_rows)]
        cols = np.sort(a.indices[lo:hi])
        edges = np.searchsorted(cols, np.arange(0, a.shape[1] + bw, bw))
        next_h = band_h
        for bi, ci in enumerate(np.flatnonzero(np.diff(edges))):
            if token >= max_anchors:
                break
            anchor_col = int(ci) * bw
            if scheme == 2:
                h = irr_height(row_s, anchor_col)
                if bi == 0:
                    next_h = h
            else:
                blk_h, _ = pol.adjust_block_shape(row_s, n_rows)
                h, _ = pol.adjust_window_shape(
                    token, row_s, anchor_col, blk_h, topo)
            seg = cols[edges[ci]:edges[ci + 1]]
            a_ele = len(seg)
            b_words = int(2 * b_row_lens[seg].sum())
            cost = traffic_cost(b_words, 0, 2 * b_words + 2 * a_ele,
                                config.cost_miss_weight)
            pol.block_info[token] = BlockFeedback(a_ele_num=a_ele, cost=cost)
            topo.add_block(token, row_s, anchor_col)
            height_votes[h] = height_votes.get(h, 0) + a_ele
            token += 1
        row_s += band_h
        band_h = max(1, next_h)
    if not height_votes:
        return 8, {"scheme": scheme, "anchors": 0, "heights": {}}
    mode_h = max(height_votes.items(), key=lambda kv: kv[1])[0]
    # scale lane-granular heights to sublane-granular MXU panels
    tm = 1 << int(np.clip(np.round(np.log2(max(mode_h, 1) * 8)), 3, 7))
    return tm, {"scheme": scheme, "anchors": token,
                "heights": height_votes, "mode_h": mode_h}
