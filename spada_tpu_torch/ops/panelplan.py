"""Host-side panel-granular VMEM cache planning for the panel-dot kernel.

A mirror of :mod:`spada_tpu.ops.panelplan`, kept array-for-array equal to
it by ``tests/test_torch_panelplan.py`` (the native fast path is the port's
own build of ``native/spada_native.cpp``).  The port's panel kernel
(``csrc/tile_panel.cu``) has no slot cache: here the plans only rank the
C-tile run orders of ``ops.engine.run_worklist_panel(run_order='auto')``
by the loads the reference's kernel would make, so that the port chooses
the order the reference chooses.  The text below is the reference's.

The cached kernel (:mod:`spada_tpu.ops.engine`) dots one (tm, tk) x (tk, tn)
tile pair per work item and accumulates each C tile's run in a f32 VMEM
buffer — on the banded benchmark that read-modify-write VPU traffic plus the
per-item scalar/MXU dependence chain caps MXU utilization at ~45%.  The
panel-dot engine removes the per-item accumulate entirely: a C tile's whole
run becomes ONE ``dot_general`` over k-concatenated VMEM panels, with the
MXU accumulating internally across the contraction.  That requires the run's
A (resp. B) tiles to sit in *adjacent* cache slots, which is this planner's
job: a greedy adjacency-preserving slot assignment, the panel-granular
sibling of the Belady planner in :mod:`spada_tpu.ops.cacheplan`.

Reuse is recognized in two forms (both common under row-major o-sorted
worklists of k-local structure, e.g. banded matrices, where consecutive runs
of one A row-panel share a shifting k-window — the same locality the
reference's fiber cache exploits online, storage.rs:460-1007):

- **full-panel hit** — every tile of the run is already resident in
  consecutive slots (any placement, including as an infix of a longer
  earlier panel): zero loads;
- **tail extension** — a prefix of the run is resident ending exactly at
  the allocation cursor: only the suffix is loaded, extending the block.

Everything else allocates a fresh contiguous block at the cursor (wrapping
to 0 when the run would straddle the ring end — panels never wrap) and
loads every tile.  Runs longer than ``max_panel`` are planned as aligned
``max_panel``-sized chunks, each placed like a short run; the kernel dots
chunk panels and accumulates across them, so arbitrary run lengths keep
panel-granular MXU work (one accumulate per chunk, not per item).

Pipeline-safety: same contract as ``plan_tile_cache`` — the kernel issues
item ``w``'s DMA ``depth`` items ahead — with one panel-specific extension:
a panel's slots are read at the run's *dot*, which happens after the whole
run has been prefetched, so every slot of a run ending at item ``hi-1`` is
protected until ``hi-1`` (not just until the item that nominally occupies
it).  A load for item ``w`` may overwrite a slot only if its protection
horizon is before ``w - depth``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PanelPlan:
    slot: np.ndarray     # int32 [W] VMEM slot of each item's tile; items of
    #                      a panel-dotted run occupy consecutive slots
    load: np.ndarray     # int32 [W] 1 if the slot must be DMA-loaded
    n_slots: int
    n_loads: int
    max_panel: int       # chunk size; longer runs were planned as chunks

    @property
    def hit_rate(self) -> float:
        return 1.0 - self.n_loads / max(len(self.load), 1)


def plan_panel_cache(tile_ids: np.ndarray, run_ptr: np.ndarray,
                     n_slots: int, depth: int = 4,
                     max_panel: int = 4) -> PanelPlan:
    """Adjacency-preserving slot assignment for one operand's tile stream.

    ``run_ptr`` is the int CSR pointer [R+1] of C-tile runs over the
    o-sorted item stream (``searchsorted(o_ids, arange(n_c_tiles+1))``).
    """
    assert n_slots >= max_panel + depth + 2, (n_slots, max_panel, depth)
    assert n_slots <= 256, "packed encoding carries 8 slot bits"
    tile_ids = np.asarray(tile_ids, dtype=np.int64)
    run_ptr = np.asarray(run_ptr, dtype=np.int64)
    W = len(tile_ids)
    slot_of = np.full(W, -1, np.int32)
    load = np.zeros(W, np.int32)
    if W == 0:
        return PanelPlan(slot_of, load, n_slots, 0, max_panel)

    # native fast path (identical decisions; parity-tested)
    from spada_tpu_torch import native

    res = native.plan_panel_cache(tile_ids, run_ptr, n_slots, depth,
                                  max_panel)
    if res is not None:
        slot_n, load_n, n_loads = res
        return PanelPlan(slot_n, load_n, n_slots, n_loads, max_panel)

    NEG = -(10 ** 9)
    resident: dict = {}                       # tile -> current slot
    slot_tile = np.full(n_slots, -1, np.int64)
    # protection horizon: last item index whose DOT still reads this slot
    slot_prot = np.full(n_slots, NEG, np.int64)
    cursor = 0
    n_loads = 0

    def place(w: int, t: int, s: int, protect: int, is_load: bool):
        nonlocal n_loads
        old = slot_tile[s]
        if is_load and old >= 0 and resident.get(int(old)) == s:
            del resident[int(old)]
        resident[int(t)] = s
        slot_tile[s] = t
        slot_of[w] = s
        slot_prot[s] = protect
        if is_load:
            load[w] = 1
            n_loads += 1

    def window_safe(s0: int, n: int, w0: int) -> bool:
        # slots s0..s0+n-1 get loads for items w0..w0+n-1
        return bool(np.all(slot_prot[s0:s0 + n]
                           < np.arange(w0, w0 + n) - depth))

    def alloc_fresh(w0: int, tiles, protect: int) -> None:
        nonlocal cursor
        L = len(tiles)
        start = cursor if cursor + L <= n_slots else 0
        first = start
        while not window_safe(start, L, w0):
            start += 1
            if start + L > n_slots:
                start = 0
            if start == first:
                raise RuntimeError("panel plan deadlock: raise n_slots")
        for i, t in enumerate(tiles):
            place(w0 + i, int(t), start + i, protect, is_load=True)
        cursor = start + L
        if cursor >= n_slots:
            cursor = 0

    for r in range(len(run_ptr) - 1):
        rlo, rhi = int(run_ptr[r]), int(run_ptr[r + 1])
        # runs longer than max_panel are dotted as aligned max_panel-sized
        # chunks (accumulated across chunks by the kernel); each chunk is
        # placed exactly like a short run
        for lo in range(rlo, rhi, max_panel):
            hi = min(lo + max_panel, rhi)
            L = hi - lo
            tiles = tile_ids[lo:hi]
            last = hi - 1  # the chunk's dot reads its slots at this item
            # full-panel hit: all tiles resident in consecutive slots
            s0 = resident.get(int(tiles[0]), -1)
            if s0 >= 0 and s0 + L <= n_slots and all(
                resident.get(int(tiles[i]), -1) == s0 + i
                for i in range(1, L)
            ):
                for i in range(L):
                    place(lo + i, int(tiles[i]), s0 + i, last,
                          is_load=False)
                continue
            # tail extension: longest resident prefix ending at the cursor
            ext = 0
            for p in range(min(L - 1, cursor), 0, -1):
                if cursor + (L - p) > n_slots:
                    continue
                if all(resident.get(int(tiles[i]), -1) == cursor - p + i
                       for i in range(p)) \
                        and window_safe(cursor, L - p, lo + p):
                    ext = p
                    break
            if ext:
                for i in range(ext):
                    place(lo + i, int(tiles[i]), cursor - ext + i, last,
                          is_load=False)
                for i in range(ext, L):
                    place(lo + i, int(tiles[i]), cursor + i - ext, last,
                          is_load=True)
                cursor += L - ext
                if cursor >= n_slots:
                    cursor = 0
                continue
            alloc_fresh(lo, tiles, last)

    return PanelPlan(slot_of, load, n_slots, n_loads, max_panel)


# --------------------------------------------------------------------------
# Run-order adaptivity
# --------------------------------------------------------------------------
#
# The order in which C tiles are processed is free: the engine emits tiles
# in processing order and callers carry (c_tile_row, c_tile_col) metadata,
# so no gather is needed to "restore" an order.  Different traversals favor
# different operands' panel adjacency:
#
# - row-major (ci, cj): consecutive runs share one A row-panel whose k
#   window shifts -> A tail-extends, B streams;
# - col-major (cj, ci): symmetric — B tail-extends, A streams;
# - diagonal (cj - ci, ci): for k-local structure (banded and
#   near-banded), BOTH operands' k windows shift by one step per run ->
#   both tail-extend.
#
# ``choose_run_order`` plans both operands under each candidate and picks
# the minimum total loads — the reference's rowwise/colwise adaptive
# dataflow decision (scheduler.rs:675-700, colwise_reg_adjust.rs:47-109)
# re-realized as a plan-time traversal choice that drives a real kernel.

_RUN_ORDERS = ("row", "col", "diag")


def order_runs(c_row: np.ndarray, c_col: np.ndarray,
               order: str) -> np.ndarray:
    """Permutation of run (C tile) indices for a traversal order."""
    c_row = np.asarray(c_row, np.int64)
    c_col = np.asarray(c_col, np.int64)
    if order == "row":
        key = (c_row, c_col)
    elif order == "col":
        key = (c_col, c_row)
    elif order == "diag":
        key = (c_col - c_row, c_row)
    else:
        raise ValueError(f"unknown run order {order!r}")
    return np.lexsort(key[::-1])


def permute_runs(perm: np.ndarray, run_ptr: np.ndarray,
                 *item_arrays) -> tuple:
    """Reorder the item stream by run permutation; within-run order kept.

    Returns (new_run_ptr, relabeled_o_ids, *permuted_item_arrays) where the
    relabeled o ids are the runs' ranks in the new order (sorted ascending,
    so the grouped kernel machinery applies unchanged).
    """
    run_ptr = np.asarray(run_ptr, np.int64)
    lens = np.diff(run_ptr)[perm]
    new_ptr = np.zeros(len(perm) + 1, np.int64)
    new_ptr[1:] = np.cumsum(lens)
    # item index map: for each new position, the old item index
    idx = np.concatenate(
        [np.arange(run_ptr[p], run_ptr[p + 1]) for p in perm]
    ) if len(perm) else np.zeros(0, np.int64)
    o_new = np.repeat(np.arange(len(perm), dtype=np.int64), lens)
    return (new_ptr, o_new) + tuple(np.asarray(a)[idx] for a in item_arrays)


def choose_run_order(a_ids, b_ids, run_ptr, c_row, c_col,
                     a_slots: int, b_slots: int, depth: int = 4,
                     max_panel: int = 4, sample_items: int = 100_000):
    """Pick the traversal with the fewest planned loads.

    Returns (order, perm, total_loads_per_order dict).  Planning cost is
    bounded by ``sample_items``: longer streams are judged on a prefix.
    """
    run_ptr = np.asarray(run_ptr, np.int64)
    best, best_perm, totals = None, None, {}
    for order in _RUN_ORDERS:
        perm = order_runs(c_row, c_col, order)
        # bound the judging cost BEFORE permuting: keep only the run
        # prefix covering ~sample_items items
        lens = np.diff(run_ptr)[perm]
        csum = np.cumsum(lens)
        if csum[-1] > sample_items:
            r_hi = int(np.searchsorted(csum, sample_items)) + 1
            perm_t = perm[:r_hi]
        else:
            perm_t = perm
        new_ptr, _, a_p, b_p = permute_runs(perm_t, run_ptr, a_ids, b_ids)
        pa = plan_panel_cache(a_p, new_ptr, a_slots, depth, max_panel)
        pb = plan_panel_cache(b_p, new_ptr, b_slots, depth, max_panel)
        totals[order] = pa.n_loads + pb.n_loads
        if best is None or totals[order] < totals[best]:
            best, best_perm = order, perm
    return best, best_perm, totals
