"""The tile side's cost model of the card, and the planner that uses it.

The reference's planner is fitted to its own chip: one core steps through
the work items one after another, so its estimator adds time up over items,
``max(bytes / BW, flops / peak) + W * (acc * tm * tn + fixed)``
(:func:`spada_tpu_torch.plan.estimator.panel_cost_model`), and its tile-edge
model charges each distinct tile once (``choose_tile_size``).  On an H100
three things differ, and this model prices them:

- the grid runs in parallel: ``tile_spgemm`` runs a block per C tile and
  piece (:func:`block_pieces`), so a plan with fewer blocks than SMs takes
  its longest run of items times one block's latency per item, not W
  times a throughput;
- each plan segment (one per distinct panel height,
  ``plan.execute.iter_plan_segments``) is one launch, and the launches run
  one after another on the stream;
- a tile read again comes from L2 while the reads between its two uses fit
  in it: the distinct tiles come from HBM once, an A tile's re-reads
  (within its panel's run) from L2, and a B tile's from L2 when its next
  reader is within the panels whose reads L2 holds, from HBM otherwise.

A span (rows [s, e) in panels of height tm, tk x tn = T x T tiles) is
priced by :func:`card_span_cost`: ``max(t_bytes, W * t_item, L * t_lat)``,
``t_item`` and ``t_lat`` the card's measured times of one item of that
shape on a full grid and on one block, L the most items of one C tile;
each C tile's f32 write adds to the items' term.
A plan (:func:`card_plan_cost`) pays per segment one launch plus that max
over the segment's spans (their byte and throughput terms summed, their
longest run the longest of any), and the segments add up.  The terms are
``CardConfig``'s ``tile_*`` fields.  Left at their defaults (the
reference's form, ``config.REFERENCE_TILE_TERMS``), :func:`card_span_cost`
gives ``panel_cost_model``'s cost, :func:`card_tile_size` gives
``choose_tile_size``'s details and :func:`plan_spgemm_card` gives
``plan_spgemm``'s plan.

:func:`planner_for` is the one resolver the port's callers plan through:
the card's pair under a ``CardConfig``, the reference's copies under a
``SpadaConfig``.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from spada_tpu_torch.config import CardConfig, SpadaConfig
from spada_tpu_torch.plan.estimator import BTileStructure
from spada_tpu_torch.plan.groups import parse_group
from spada_tpu_torch.plan.planner import (ExecutionPlan, PanelSpec,
                                          choose_tile_size, plan_spgemm)
from spada_tpu_torch.sparse.csr import CsrMatrix

#: the merge of two neighbouring spans must save this share of their cost
#: (``plan_spgemm``'s 2%)
MERGE_MARGIN = 0.02


def _itemsize(config) -> int:
    return 2 if config.engine_dtype == "bfloat16" else 4


@functools.lru_cache(maxsize=64)
def _table(rows: tuple) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """{T: (tm ascending, seconds)} of a ``((tm, T, s), ...)`` table."""
    by_t: dict = {}
    for tm, t, s in rows:
        by_t.setdefault(t, []).append((tm, s))
    return {t: tuple(np.asarray(v, np.float64).T) for t, v in
            ((t, sorted(v)) for t, v in by_t.items())}


def shape_time(rows: tuple, tm: int, tk: int, tn: int) -> float:
    """The seconds a ``((tm, T, s), ...)`` table gives a tm x tk x tn item:
    the recorded point at (tm, T), T = tk = tn; between two recorded
    heights at that T, the straight line between them; below the lowest,
    its time; above the highest, its time scaled by tm.  Raises
    ``ValueError`` where tk != tn or no point has that T."""
    if tk != tn:
        raise ValueError(f"the card's tables hold T x T tiles, got tk={tk} "
                         f"tn={tn}")
    by_t = _table(rows)
    if tk not in by_t:
        raise ValueError(f"no measured item time at T={tk} (the table has "
                         f"T in {sorted(by_t)})")
    tms, ss = by_t[tk]
    if tm > tms[-1]:
        return float(ss[-1] * tm / tms[-1])
    return float(np.interp(tm, tms, ss))


def block_pieces(tm: int, tk: int, tn: int, itemsize: int) -> int:
    """The blocks ``tile_spgemm`` runs per C tile of tm x tn (tk deep), from
    the block :func:`spada_tpu_torch.ops.engine.tile_block` names for the
    shape and its BM x BN piece: 128 x 128 on the tensor-core and wide SIMT
    blocks, min(tm, 64) x 128 on the thin block, min(tm, 64) x 64 on the
    narrow SIMT block."""
    from spada_tpu_torch.ops.engine import tile_block

    block = tile_block(tm, tk, tn, "bfloat16" if itemsize == 2 else
                       "float32")
    bm, bn = {"mma": (128, 128), "wide_simt": (128, 128),
              "mma_thin": (min(tm, 64), 128),
              "narrow_simt": (min(tm, 64), 64)}[block]
    return (tm // bm) * (tn // bn)


def _zero_span(tm: int) -> dict:
    return dict(work=0, c_tiles=0, bytes=0.0, mxu_flops=0, cost=0.0, tm=tm,
                blocks=0, longest=0, a_unique=0, b_unique=0, hbm_bytes=0.0,
                l2_bytes=0.0, t_bytes=0.0, t_roof=0.0, t_thr=0.0, t_lat=0.0,
                t_add=0.0)


_NO_GAPS = (np.zeros(0, np.int64), np.zeros(0, np.int64))


def _items(ap: np.ndarray, ak: np.ndarray, bt: BTileStructure) -> tuple:
    """(W, C tiles, longest run, A tiles used, B tiles touched, panels,
    B gaps) of the items the distinct A tiles (panel ``ap``, k-tile ``ak``)
    make with B's tiles: every (panel, k) expanded to its j tiles, as
    ``panel_cost_model`` expands them, counted per (panel, j).  B gaps:
    (gap values ascending, how many re-reads of a B tile come at most that
    many panels after its last read), the distance, in o-sorted order, at
    which each B tile is read again."""
    fan = bt.fanout(ak)
    W = int(fan.sum())
    if not W:
        return 0, 0, 0, 0, 0, 0, _NO_GAPS
    panel_rep = np.repeat(ap, fan)
    starts = bt.rowptr[ak]
    offs = np.arange(W) - np.repeat(np.cumsum(fan) - fan, fan)
    b_idx = np.repeat(starts, fan) + offs        # the item's B tile
    j_rep = bt.tile_j[b_idx]
    _, runs = np.unique(panel_rep * bt.n_tile_cols + j_rep,
                        return_counts=True)
    used = fan > 0
    # each (panel, B tile) is one item, and the items come in panel order:
    # a stable sort by B tile lists each B tile's reads in panel order
    order = np.argsort(b_idx, kind="stable")
    again = b_idx[order][1:] == b_idx[order][:-1]
    gaps, n_gaps = np.unique(np.diff(panel_rep[order])[again],
                             return_counts=True)
    b_touched = W - int(again.sum())
    return (W, len(runs), int(runs.max()), int(used.sum()), b_touched,
            len(np.unique(ap[used])), (gaps, np.cumsum(n_gaps)))


def _price(W: int, c_tiles: int, longest: int, a_used: int, b_used: int,
           n_panels: int, b_gaps: tuple, tm: int, tk: int, tn: int,
           itemsize: int, config) -> dict:
    """A span's terms and cost from its item counts (see the module
    docstring); in the reference's form, ``panel_cost_model``'s cost."""
    bytes_moved = (W * (tm * tk + tk * tn) * itemsize
                   + c_tiles * tm * tn * itemsize)
    mxu_flops = 2 * W * tm * tk * tn
    item = getattr(config, "tile_item_s", ())
    lat = getattr(config, "tile_item_latency_s", ())
    l2_rate = getattr(config, "tile_l2_bytes_per_s", 0.0)
    out = dict(work=W, c_tiles=int(c_tiles), bytes=float(bytes_moved),
               mxu_flops=mxu_flops, tm=tm,
               blocks=int(c_tiles) * block_pieces(tm, tk, tn, itemsize),
               longest=longest, a_unique=a_used, b_unique=b_used)
    c_write = c_tiles * tm * tn * 4          # the kernels write f32 C
    if l2_rate > 0:
        # the distinct tiles and C from HBM.  An A tile is read again
        # within its panel's run, from L2.  A B tile read again within the
        # panels whose reads L2 holds (its size over one panel's reads,
        # each item's tiles) comes from L2, from HBM otherwise
        a_b, b_b = tm * tk * itemsize, tk * tn * itemsize
        per_panel = (W * b_b + a_used * a_b) / n_panels
        gaps, within = b_gaps
        k = np.searchsorted(gaps, config.tile_l2_bytes / per_panel, "right")
        b_hits = int(within[k - 1]) if k else 0
        b_again = W - b_used
        hbm = (a_used * a_b + b_used * b_b + c_write
               + (b_again - b_hits) * b_b)
        l2 = (W - a_used) * a_b + b_hits * b_b
        t_bytes = hbm / config.hbm_bytes_per_s + l2 / l2_rate
    else:
        hbm, l2 = float(bytes_moved), 0.0
        t_bytes = bytes_moved / config.hbm_bytes_per_s
    if item:
        # the card's time per item holds its compute and its reads, and
        # each C tile's write adds to it (a block writes its C tile when
        # its run ends): the two sit in the max beside the byte term
        t_roof = t_bytes
        t_thr = (W * shape_time(item, tm, tk, tn)
                 + c_write / config.hbm_bytes_per_s)
        t_add = 0.0
    else:
        # the reference's form: the per-item terms add to the byte/flop max
        t_roof = max(t_bytes, mxu_flops / config.peak_flops_bf16)
        t_thr = 0.0
        t_over = (config.engine_acc_s_per_elem * tm * tn
                  + config.engine_item_fixed_s)
        t_add = W * t_over
    t_lat = longest * shape_time(lat, tm, tk, tn) if lat else 0.0
    out.update(hbm_bytes=float(hbm), l2_bytes=float(l2), t_bytes=t_bytes,
               t_roof=t_roof, t_thr=t_thr, t_lat=t_lat, t_add=t_add,
               cost=max(t_roof, t_thr, t_lat) + t_add)
    return out


def span_counts(a: CsrMatrix, row_start: int, row_end: int, tm: int,
                bt: BTileStructure) -> tuple:
    """(W, C tiles, longest run, A tiles used, B tiles touched, panels, B
    gaps) of rows [row_start, row_end) of ``a`` in panels of height ``tm``
    against ``bt`` (:func:`_items`): what :func:`card_span_cost`
    prices."""
    tk = bt.tk
    s, e = a.indptr[row_start], a.indptr[row_end]
    if e == s:
        return 0, 0, 0, 0, 0, 0, _NO_GAPS
    rows = np.repeat(np.arange(row_start, row_end),
                     np.diff(a.indptr[row_start:row_end + 1]))
    cols = a.indices[s:e].astype(np.int64)
    a_tiles = np.unique(((rows - row_start) // tm) * bt.n_k_tiles
                        + cols // tk)
    return _items(a_tiles // bt.n_k_tiles, a_tiles % bt.n_k_tiles, bt)


def price_span(counts: tuple, tm: int, bt: BTileStructure, itemsize: int,
               config) -> dict:
    """:func:`card_span_cost` of a span's :func:`span_counts` under
    ``config``."""
    if not counts[0]:
        return _zero_span(tm)
    return _price(*counts, tm, bt.tk, bt.tn, itemsize, config)


def card_span_cost(a: CsrMatrix, row_start: int, row_end: int, tm: int,
                   bt: BTileStructure, itemsize: int = 4,
                   config=None) -> dict:
    """The card's model of rows [row_start, row_end) of ``a`` in panels of
    height ``tm`` against ``bt`` (B's tiles): ``panel_cost_model``'s
    ``work``, ``c_tiles``, ``bytes`` and ``mxu_flops``, and

    - ``blocks``: C tiles times :func:`block_pieces`;
    - ``longest``: the most items of one (panel, j) C tile;
    - ``a_unique``, ``b_unique``: the A tiles the items use and the B tiles
      they touch, each read once from HBM (``hbm_bytes``); the re-reads
      from L2 (``l2_bytes``), a B tile's where its reader before is within
      ``tile_l2_bytes`` of reads (the panels between, at one panel's
      reads each), from HBM otherwise;
    - the terms ``t_bytes`` (``t_roof``: the byte term, in the reference's
      form the byte/flop max), ``t_thr`` (W times the item's throughput
      time), ``t_lat`` (the longest run times one block's time per item)
      and ``t_add`` (the reference's per-item terms, which add to the
      max), and ``cost``, the span alone without its launch:
      ``max(t_roof, t_thr, t_lat) + t_add``."""
    return price_span(span_counts(a, row_start, row_end, tm, bt), tm, bt,
                      itemsize, config or CardConfig())


def card_plan_cost(plan_spans: Sequence[dict], config) -> Tuple[float, dict]:
    """(seconds, {tm: seconds}) of a plan given as its spans
    (:func:`card_span_cost` dicts): per segment, one per distinct tm as
    ``iter_plan_segments`` forms them, ``tile_launch_s`` plus
    ``max(sum of t_roof, sum of t_thr, max of t_lat) + sum of t_add``;
    the segments add up, since their launches run one after another.
    Spans with no items make no segment."""
    launch = getattr(config, "tile_launch_s", 0.0)
    segs: dict = {}
    for sp in plan_spans:
        if not sp["work"]:
            continue
        g = segs.setdefault(sp["tm"], [0.0, 0.0, 0.0, 0.0])
        g[0] += sp["t_roof"]
        g[1] += sp["t_thr"]
        g[2] = max(g[2], sp["t_lat"])
        g[3] += sp["t_add"]
    per = {tm: launch + max(r, t, lat) + add
           for tm, (r, t, lat, add) in sorted(segs.items())}
    return sum(per.values()), per


class _Segments:
    """The per-tm sums of a plan's spans (:func:`card_plan_cost`'s), kept
    as spans come and go, so that a change's whole-plan cost is the change
    in the segments it touches."""

    def __init__(self, config):
        self.launch = getattr(config, "tile_launch_s", 0.0)
        self.sums: dict = {}        # tm -> [t_roof, t_thr, t_add, spans]
        self.lats: dict = {}        # tm -> the spans' t_lat, ascending

    def apply(self, sp: dict, sign: int) -> None:
        """Add (``sign`` 1) or take out (-1) one span."""
        if not sp["work"]:
            return
        tm = sp["tm"]
        g = self.sums.setdefault(tm, [0.0, 0.0, 0.0, 0])
        g[0] += sign * sp["t_roof"]
        g[1] += sign * sp["t_thr"]
        g[2] += sign * sp["t_add"]
        g[3] += sign
        lats = self.lats.setdefault(tm, [])
        if sign > 0:
            bisect.insort(lats, sp["t_lat"])
        else:
            del lats[bisect.bisect_left(lats, sp["t_lat"])]
        if not g[3]:
            del self.sums[tm], self.lats[tm]

    def _segment(self, tm: int, out=(), inn=()) -> float:
        r, t, add, n = self.sums.get(tm, (0.0, 0.0, 0.0, 0))
        for sign, group in ((-1, out), (1, inn)):
            for sp in group:
                r += sign * sp["t_roof"]
                t += sign * sp["t_thr"]
                add += sign * sp["t_add"]
                n += sign
        if n <= 0:
            return 0.0
        # the longest t_lat left once ``out``'s are taken out
        skip = sorted(sp["t_lat"] for sp in out)
        lat = 0.0
        for v in reversed(self.lats.get(tm, ())):
            if skip and v == skip[-1]:
                skip.pop()
                continue
            lat = v
            break
        lat = max([lat] + [sp["t_lat"] for sp in inn])
        return self.launch + max(r, t, lat) + add

    def delta(self, out: Sequence[dict], inn: Sequence[dict]) -> float:
        """The plan's cost with the spans ``out`` replaced by ``inn``, less
        its cost now."""
        out = [sp for sp in out if sp["work"]]
        inn = [sp for sp in inn if sp["work"]]
        return sum(
            self._segment(tm, [sp for sp in out if sp["tm"] == tm],
                          [sp for sp in inn if sp["tm"] == tm])
            - self._segment(tm)
            for tm in {sp["tm"] for sp in (*out, *inn)})


def tile_heights(config, T: int) -> List[int]:
    """The panel heights the planner tries at tile edge T, as
    ``cli.plan_spada`` sets them: the config's choices up to T, and T."""
    return sorted({t for t in config.tm_choices if t <= T} | {T})


def card_tile_size(a: CsrMatrix, b: CsrMatrix,
                   config: Optional[SpadaConfig] = None,
                   candidates=(128, 256, 384, 512),
                   cutoff: Optional[float] = None):
    """The card's counterpart of ``choose_tile_size``, with its return
    shape, (T, {T: {"W", "bytes", "t_est", ...}}): at each T, the cheapest
    plan of one segment of uniform panels over all rows at a height the
    planner then tries (:func:`tile_heights`), priced by
    :func:`card_plan_cost` (its launch included), as
    :func:`cheapest_uniform` finds it; ``tm`` that height, ``bytes`` what
    it reads from HBM, with ``c_tiles``, ``longest`` and ``blocks``
    beside.  With ``cutoff`` (seconds), a T whose every height costs at
    least that much by its lower bound is not priced: its ``t_est`` is
    that bound, marked ``"bound": True``.  Without an item table (the
    reference's form) it is ``choose_tile_size``."""
    config = config or CardConfig()
    if not getattr(config, "tile_item_s", ()):
        return choose_tile_size(a, b, config, candidates)
    itemsize = _itemsize(config)
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    cols = np.asarray(a.indices, np.int64)
    details = {}
    best_t, best_cost = candidates[0], float("inf")
    for T in candidates:
        got = cheapest_uniform(rows, cols, BTiles.of_csr(b, T),
                               tile_heights(config, T), itemsize, config,
                               cutoff)
        if got.get("bound"):
            details[T] = {"W": None, "bytes": None, "t_est": got["t_est"],
                          "tm": got["tm"], "bound": True}
        else:
            sp = got["span"]
            details[T] = {"W": sp["work"], "bytes": sp["hbm_bytes"],
                          "t_est": got["t_est"], "tm": got["tm"],
                          "c_tiles": sp["c_tiles"], "longest": sp["longest"],
                          "blocks": sp["blocks"]}
        if got["t_est"] < best_cost:
            best_cost, best_t = got["t_est"], T
    return best_t, details


@dataclasses.dataclass(frozen=True)
class BTiles:
    """B's T x T tiles by k-tile row, the arrays ``BTileStructure`` holds,
    built from B's nonzeros' (row, col) index arrays alone
    (:meth:`of_arrays`), so that a permuted or shifted B is described
    without its CSR."""

    tk: int
    tn: int
    n_k_tiles: int
    n_tile_cols: int
    tile_k: np.ndarray
    tile_j: np.ndarray
    rowptr: np.ndarray

    @classmethod
    def of_arrays(cls, rows: np.ndarray, cols: np.ndarray, shape: tuple,
                  T: int) -> "BTiles":
        """The tiles of the B of ``shape`` whose nonzeros sit at
        (``rows``, ``cols``)."""
        n_k, n_j = -(-shape[0] // T), -(-shape[1] // T)
        uniq = np.unique((np.asarray(rows, np.int64) // T) * n_j
                         + np.asarray(cols, np.int64) // T)
        tile_k = uniq // n_j
        rowptr = np.zeros(n_k + 1, np.int64)
        np.cumsum(np.bincount(tile_k, minlength=n_k), out=rowptr[1:])
        return cls(T, T, n_k, n_j, tile_k, uniq % n_j, rowptr)

    @classmethod
    def of_csr(cls, b: CsrMatrix, T: int) -> "BTiles":
        return cls.of_arrays(np.repeat(np.arange(b.shape[0]),
                                       np.diff(b.indptr)),
                             b.indices, b.shape, T)

    def fanout(self, k_tiles: np.ndarray) -> np.ndarray:
        """The B tiles of each k-tile row in ``k_tiles``."""
        return np.diff(self.rowptr)[k_tiles]


def cheapest_uniform(rows: np.ndarray, cols: np.ndarray, bt: BTiles,
                     heights: Sequence[int], itemsize: int, config,
                     cutoff: Optional[float] = None) -> dict:
    """The cheapest plan of one segment of uniform panels over all rows of
    an A given by its nonzeros' ``rows`` and ``cols`` (any order), against
    B's tiles ``bt`` (T x T), at one of ``heights``, priced by
    :func:`card_plan_cost`: {"t_est", "tm", "span"}.  The A tiles of every
    height come from one pass over the nonzeros, at the heights' greatest
    common divisor, and each height gets a lower bound from its tiles
    alone (:func:`_floor`); a height whose bound is at least the cheapest
    plan priced is not priced.  With ``cutoff``, where every height's bound
    is at least that much: {"t_est": the lowest bound, "tm", "bound":
    True}."""
    T = bt.tk
    g = int(np.gcd.reduce(heights))
    fine = np.unique((rows // g) * bt.n_k_tiles + cols // T)
    f_panel, f_k = fine // bt.n_k_tiles, fine % bt.n_k_tiles
    tiles, floor = {}, {}
    for tm in heights:
        tiles[tm] = np.unique((f_panel // (tm // g)) * bt.n_k_tiles + f_k)
        floor[tm] = _floor(tiles[tm] // bt.n_k_tiles,
                           tiles[tm] % bt.n_k_tiles, bt, tm, itemsize,
                           config)
    order = sorted(heights, key=lambda h: (floor[h], h))
    if cutoff is not None and floor[order[0]] >= cutoff:
        return {"t_est": floor[order[0]], "tm": order[0], "bound": True}
    best = None
    for tm in order:
        # a height that cannot cost less (or as little at a lower tm)
        if best is not None and (floor[tm], tm) > best[:2]:
            break
        counts = _items(tiles[tm] // bt.n_k_tiles, tiles[tm] % bt.n_k_tiles,
                        bt)
        sp = price_span(counts, tm, bt, itemsize, config)
        t, _ = card_plan_cost([sp], config)
        if best is None or (t, tm) < best[:2]:
            best = (t, tm, sp)
    return {"t_est": best[0], "tm": best[1], "span": best[2]}


def _floor(ap: np.ndarray, ak: np.ndarray, bt: BTiles, tm: int,
           itemsize: int, config) -> float:
    """A lower bound of :func:`card_plan_cost` of one span of the distinct
    A tiles (panel ``ap`` ascending, k-tile ``ak``) under the card's
    terms, from their tiles without expanding their items: W, the A tiles
    used, the B tiles touched, the panels and, per panel, its widest
    k-tile's B tiles (its C tiles are at least that many); a B tile's
    re-read at the faster of L2 and HBM, or from HBM where L2 holds less
    than one panel's reads (a re-read comes at least a panel later); the
    launch plus the larger of the byte and throughput terms
    :func:`_price` gives them, less a hair for rounding."""
    fan = bt.fanout(ak)
    W = int(fan.sum())
    if not W:
        return 0.0
    T = bt.tk
    used = fan > 0
    a_used = int(used.sum())
    b_used = int(bt.fanout(np.unique(ak[used])).sum())
    starts = np.flatnonzero(np.r_[True, ap[1:] != ap[:-1]])
    c_write = int(np.maximum.reduceat(fan, starts).sum()) * tm * T * 4
    a_b, b_b = tm * T * itemsize, T * T * itemsize
    hbm = config.hbm_bytes_per_s
    l2 = getattr(config, "tile_l2_bytes_per_s", 0.0)
    if l2 > 0:
        per_panel = (W * b_b + a_used * a_b) / len(starts)
        again = hbm if config.tile_l2_bytes < per_panel else max(l2, hbm)
        t_bytes = ((a_used * a_b + b_used * b_b + c_write) / hbm
                   + (W - a_used) * a_b / l2 + (W - b_used) * b_b / again)
    else:
        t_bytes = (W * (a_b + b_b) + c_write * itemsize / 4) / hbm
    t_thr = W * shape_time(config.tile_item_s, tm, T, T) + c_write / hbm
    return ((getattr(config, "tile_launch_s", 0.0) + max(t_bytes, t_thr))
            * (1 - 1e-9))


def plan_spgemm_card(a: CsrMatrix, b: CsrMatrix,
                     config: Optional[SpadaConfig] = None,
                     scheme: str = "analytic",
                     measure: Optional[Callable[[int, int, int], float]] = None
                     ) -> ExecutionPlan:
    """``plan_spgemm`` under the card's model: the per-group argmin of
    :func:`card_span_cost`, the merging of neighbours, the check against
    the best uniform plan and the merge of equal heights, as there, with
    two changes: a merge and the uniform check compare whole-plan costs
    (:func:`card_plan_cost`), so a second segment pays its launch; a merge
    must save :data:`MERGE_MARGIN` of the two spans' own costs, and the
    uniform plan, one launch, replaces the mixed plan wherever it models
    cheaper.  ``plan.meta`` adds ``t_est`` and each segment's
    (``segments``, {tm: seconds}).  Under ``scheme='profiled'`` the
    measured costs decide, as in ``plan_spgemm``, which runs."""
    config = config or CardConfig()
    if scheme != "analytic":
        return plan_spgemm(a, b, config, scheme=scheme, measure=measure)
    groups = parse_group(a.row_lens(), config.var_factor)
    bt = BTileStructure(b, config.tile_k, config.tile_n)
    itemsize = _itemsize(config)
    spans: Dict[tuple, dict] = {}

    def span(s: int, e: int, tm: int) -> dict:
        key = (s, e, tm)
        if key not in spans:
            spans[key] = card_span_cost(a, s, e, tm, bt, itemsize, config)
        return spans[key]

    def plan_cost(panels: List[PanelSpec]) -> Tuple[float, dict]:
        return card_plan_cost([span(p.row_start, p.row_end, p.tm)
                               for p in panels], config)

    def best_for(s: int, e: int):
        best_tm, best_cost, per_tm = config.default_tm, float("inf"), {}
        for tm in config.tm_choices:
            c = span(s, e, tm)["cost"]
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

    improved = True
    while improved and len(panels) > 1:
        improved = False
        now = _Segments(config)
        for p in panels:
            now.apply(span(p.row_start, p.row_end, p.tm), 1)
        out_p, out_c = [panels[0]], [costs[0]]
        for p, c in zip(panels[1:], costs[1:]):
            q, cq = out_p[-1], out_c[-1]
            if q.row_end == p.row_start:
                u_tm, u_cost, _ = best_for(q.row_start, p.row_end)
                parts = [span(q.row_start, q.row_end, q.tm),
                         span(p.row_start, p.row_end, p.tm)]
                union = span(q.row_start, p.row_end, u_tm)
                if now.delta(parts, [union]) < -MERGE_MARGIN * (cq + c):
                    for sp in parts:
                        now.apply(sp, -1)
                    now.apply(union, 1)
                    out_p[-1] = PanelSpec(q.row_start, p.row_end, u_tm)
                    out_c[-1] = u_cost
                    improved = True
                    continue
            out_p.append(p)
            out_c.append(c)
        panels, costs = out_p, out_c

    if len(panels) > 1 and a.shape[0] > 0:
        u_tm, u_cost, _ = best_for(0, a.shape[0])
        uniform = [PanelSpec(0, a.shape[0], u_tm)]
        if plan_cost(uniform)[0] < plan_cost(panels)[0]:
            panels, costs = uniform, [u_cost]

    merged_p: List[PanelSpec] = []
    for p in panels:
        if (merged_p and merged_p[-1].tm == p.tm
                and merged_p[-1].row_end == p.row_start):
            merged_p[-1] = PanelSpec(merged_p[-1].row_start, p.row_end, p.tm)
        else:
            merged_p.append(p)
    t_est, per_seg = plan_cost(merged_p)
    return ExecutionPlan(
        merged_p, config.tile_k, config.tile_n,
        meta={"scheme": scheme, "n_groups": groups.n_groups,
              "group_costs": group_costs, "t_est": t_est,
              "segments": per_seg})


def plan_t_est(a: CsrMatrix, b: CsrMatrix, plan: ExecutionPlan,
               *configs) -> List[Tuple[float, dict]]:
    """:func:`card_plan_cost` of ``plan``'s panels under each of
    ``configs`` (one tile dtype): what the card's model (or, in the
    reference's form, the reference's estimator summed over the panels)
    says the plan takes.  The panels' counts are taken once."""
    bt = BTileStructure(b, plan.tile_k, plan.tile_n)
    itemsize = _itemsize(configs[0])
    counts = [(span_counts(a, p.row_start, p.row_end, p.tm, bt), p.tm)
              for p in plan.panels]
    return [card_plan_cost([price_span(c, tm, bt, itemsize, cfg)
                            for c, tm in counts], cfg) for cfg in configs]


def planner_for(config) -> Tuple[Callable, Callable]:
    """(tile-edge choice, panel planner) for ``config``: the card's pair
    (:func:`card_tile_size`, :func:`plan_spgemm_card`) under a
    ``CardConfig``, the reference's copies (``choose_tile_size``,
    ``plan_spgemm``) under a ``SpadaConfig``."""
    if isinstance(config, CardConfig):
        return card_tile_size, plan_spgemm_card
    return choose_tile_size, plan_spgemm
