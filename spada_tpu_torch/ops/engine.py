"""Numeric phase: the block-sparse tile-product engines.

Five engines compute C tiles from a
:class:`~spada_tpu_torch.ops.worklist.WorkList`; their names are the
reference's (``SpadaConfig.engine``).  Four are hand-written CUDA kernels
for ``sm_90a``, each with its plain PyTorch version beside it:

- ``'cached'`` — :func:`tile_spgemm` (``csrc/tile_spgemm.cu``), replaces the
  Pallas kernel of :func:`spada_tpu.ops.engine.run_worklist_cached`, and is
  the auto choice for o-sorted worklists.  The kernel has no slot cache: L2
  serves tile reuse.
- ``'streaming'`` — :func:`tile_stream` (``csrc/tile_stream.cu``), replaces
  the kernel of ``run_worklist_streaming``: a block walks a group of
  ``ogroup`` C tiles through a ring of ``nbuf`` ``cp.async`` stages that
  runs on across C-tile boundaries.
- ``'panel'`` — :func:`tile_panel` (``csrc/tile_panel.cu``), replaces the
  kernel of ``run_worklist_panel``: each C tile's run is one contraction
  over k-transposed A, written as f32 or rounded once to bf16.
- ``'pallas_grid'`` — :func:`tile_grid` (``csrc/tile_grid.cu``), replaces
  the kernel of ``run_worklist_pallas`` (also ``SpadaConfig.use_pallas``):
  in any item order, each block's sums added into a zeroed C with f32
  atomics; one block per item, or on thin panels per chunk of
  :func:`grid_chunk` consecutive items.
- ``'xla'`` — :func:`run_worklist_reference`, plain PyTorch (chunked
  gather -> ``bmm`` -> ``index_add_``), the port of the reference's XLA
  engine.  Order-independent, so it also runs k-major (``op``) schedules;
  the four kernels need a row-major (o-sorted) worklist and raise on
  another.

Arithmetic.  Every engine gives f32-level results at either
``precision``, so 'highest' and 'default' run the same arithmetic here; the
tile dtype (``SpadaConfig.engine_dtype``) is what selects bf16.  In all
four kernels the wide tiles (tm and tn multiples of 128, tk of 32 f32 / 64
bf16) run on tensor cores (``csrc/tile_mma.cuh``): f32 tiles as 3xTF32
(each operand split into two TF32 parts, three products summed in f32,
small terms first), bf16 tiles as bf16 ``mma`` with f32 sums; all four
run the planner's thin row panels (tm 8-64) the same way
(``csrc/tile_mma_thin.cuh``).  :func:`tile_block` names the block a shape
runs on.  The other shapes widen bf16 and run FP32 FMAs; the plain
versions run f32 ``bmm``
(TF32 off).  On a CUDA device an engine runs its kernel or raises: none
falls back to another engine or to the CPU.  The reference's TPU reroutes
(``precision='highest'`` to XLA, large ids to streaming) and its item
splits are not copied.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from spada_tpu_torch import _build
from spada_tpu_torch.convert import item_ptr_of, tile_ptr_of
from spada_tpu_torch.utils import trace

_PRECISIONS = ("highest", "default")
_ENGINES = ("cached", "streaming", "panel", "pallas_grid", "xla")
_TILE_DTYPES = (torch.float32, torch.bfloat16)
#: the block a launch of tile_spgemm, tile_stream or tile_panel reports,
#: by its number (csrc/tile_pipe.cuh's kBlock*)
_BLOCKS = ("mma", "mma_thin", "wide_simt", "narrow_simt")
#: the kernels that run thin row panels on the thin tensor-core block
_THIN_KERNELS = ("tile_spgemm", "tile_stream", "tile_panel", "tile_grid")
#: tile_grid's thin path: the most items one block takes (G), and the
#: blocks per SM its grid keeps before G grows (the measurements behind
#: both are in csrc/tile_grid.cu's header)
GRID_CHUNK_CAP = 16
GRID_FILL = 8


def tile_block(tm: int, tk: int, tn: int, dtype,
               kernel: str = "tile_spgemm") -> str:
    """The block a tile kernel runs tm x tk x tn tiles of ``dtype`` (f32 or
    bf16, as a torch or numpy dtype or its name) on, tried in this order:

    - ``"mma"``: the tensor-core block (``csrc/tile_mma.cuh``): tm and tn
      multiples of 128, tk of 32 (f32) or 64 (bf16);
    - ``"mma_thin"``: the thin tensor-core block
      (``csrc/tile_mma_thin.cuh``): tm in {8, 16, 32} or a multiple of 64
      that ``"mma"`` does not take, tn a multiple of 128, tk of 32 / 64;
    - ``"wide_simt"``: the FP32 SIMT block (``csrc/tile_wide.cuh``): tm and
      tn multiples of 128, tk of 8;
    - ``"narrow_simt"``: FP32 SIMT blocks of min(tm, 64) rows: tm in {8, 16,
      32} or a multiple of 64, tn a multiple of 64, tk of 16.

    ``kernel`` is ``"tile_spgemm"`` (``csrc/tile_spgemm.cu``'s ``launch``),
    or ``"tile_stream"``, ``"tile_panel"`` or ``"tile_grid"``, which follow
    the same rule.  Raises ``ValueError`` for a shape no block takes."""
    bk = 64 if "bfloat16" in str(dtype) else 32
    rows = tm in (8, 16, 32) or (tm > 0 and tm % 64 == 0)
    if tm > 0 and tn > 0 and tk > 0:
        if tn % 128 == 0 and tk % bk == 0:
            if tm % 128 == 0:
                return "mma"
            if rows and kernel in _THIN_KERNELS:
                return "mma_thin"
        if tm % 128 == 0 and tn % 128 == 0 and tk % 8 == 0:
            return "wide_simt"
        if rows and tn % 64 == 0 and tk % 16 == 0:
            return "narrow_simt"
    raise ValueError(
        f"{kernel} takes tm, tn multiples of 128 and tk of 8, or tm in "
        f"{{8, 16, 32}} or a multiple of 64, tn a multiple of 64 and tk "
        f"of 16; got tm={tm} tk={tk} tn={tn}")


def grid_chunk(n_items: int, pieces: int, n_sms: int) -> int:
    """G, the consecutive items one block of ``tile_grid``'s thin path
    takes, for ``n_items`` items of ``pieces`` thin pieces each on a card
    of ``n_sms`` SMs.  1 (one block per item and piece) while the grid
    would not keep :data:`GRID_FILL` blocks on every SM at G = 2; otherwise
    the largest power of two up to :data:`GRID_CHUNK_CAP` that still does.
    Chunk c holds items ``[c * G, min((c + 1) * G, n_items))``."""
    g = 1
    while (2 * g <= GRID_CHUNK_CAP
           and -(-n_items // (2 * g)) * pieces >= GRID_FILL * n_sms):
        g *= 2
    return g


def thin_pieces(tm: int, tn: int) -> int:
    """The BM x 128 pieces of a tm x tn tile on the thin block (BM =
    min(tm, 64))."""
    return (tm // min(tm, 64)) * (tn // 128)


def select_engine(order: str = "row", use_pallas: Optional[bool] = None
                  ) -> str:
    """Auto engine: the CUDA tile kernel for o-sorted worklists, the plain
    scatter-add engine for k-major ones (which the kernels cannot run);
    ``use_pallas=True`` forces the item-per-block ``'pallas_grid'`` kernel
    and ``use_pallas=False`` the plain engine, as in the reference."""
    if use_pallas:
        return "pallas_grid"
    return "cached" if order == "row" and use_pallas is None else "xla"


def _check_precision(precision: str) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")


def run_worklist(wl, a_tiles: torch.Tensor, b_tiles: torch.Tensor,
                 precision: str = "highest",
                 engine: Optional[str] = None) -> torch.Tensor:
    """C tiles [n_c_tiles, tm, tn] f32 for either package's host
    ``WorkList``, on the tiles' device."""
    return prepare_worklist(wl, a_tiles, b_tiles, precision, engine)()


def prepare_worklist(wl, a_tiles: torch.Tensor, b_tiles: torch.Tensor,
                     precision: str = "highest",
                     engine: Optional[str] = None) -> Callable[[], torch.Tensor]:
    """The launch :func:`run_worklist` makes, as a call with no arguments:
    the worklist is checked and its ids are uploaded to the tiles' device
    once, here, so the call enqueues the engine's kernel and nothing else
    (no host-to-device copy, no wait for the device)."""
    _check_precision(precision)
    eng = select_engine(wl.order) if engine in (None, "auto") else engine
    if eng not in _ENGINES:
        raise ValueError(f"unknown engine {eng!r}")
    if eng != "xla" and wl.order != "row":
        raise ValueError(f"engine {eng!r} needs a row-major (o-sorted) "
                         f"worklist")
    args = (a_tiles, b_tiles, wl.a_tid, wl.b_tid, wl.o_tid)
    n_c = int(wl.n_c_tiles)
    if eng == "streaming":
        return _streaming_call(*args, n_c)
    if eng == "panel":
        return _panel_call(*args, n_c)
    if eng == "pallas_grid":
        return _grid_call(*args, wl.first, n_c)
    if eng == "cached":
        return prepare_cached(*args, n_c)
    ids = _on(a_tiles.device, *_host_ids(*args, n_c, row_major=False))
    return lambda: run_worklist_reference(a_tiles, b_tiles, *ids, n_c)


def prepare_cached(a_tiles: torch.Tensor, b_tiles: torch.Tensor, a_ids,
                   b_ids, o_ids, n_c_tiles: int, a_fixed: bool = True
                   ) -> Callable[..., torch.Tensor]:
    """The ``'cached'`` engine's launch (:func:`tile_spgemm`) of a row-major
    worklist given as host id arrays, as a call: the ids are checked and
    uploaded here, once.  The call takes, in place of ``b_tiles``, other B
    tiles of the same shape, dtype and device (a halo round's received
    tiles, whose values arrive later).

    On the thin block the call skips the k-slices of A that are all zero,
    where they are enough to pay: their mask (:func:`thin_slice_mask`) is
    built here, once, from A's values, and kept on the call as
    ``call.mask`` (None off the thin block), with its counts ``slices``
    and ``slices_run``.  So A's tiles
    are fixed under a prepared call.  A caller that rewrites them in place
    passes ``a_fixed=False``, and every slice then runs.  The call passes
    :func:`tile_spgemm` its five operands alone: the mask rides on the
    uploaded item ids, as ``slice_mask``."""
    a, b, o = _host_ids(a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c_tiles)
    ids = _on(a_tiles.device, a, b, tile_ptr_of(o, n_c_tiles))
    mask = (thin_slice_mask(a_tiles, ids[0], b_tiles.shape[2]) if a_fixed
            else None)
    if mask is not None:
        ids[0].slice_mask = mask

    def call(b_now=b_tiles):
        return tile_spgemm(a_tiles, b_now, *ids)

    call.mask = mask
    return call


class SliceMask(NamedTuple):
    """The k-slices of A that :func:`tile_spgemm`'s thin block runs.

    ``words`` int32 [W, tm // BM] (BM = ``min(tm, 64)``, the thin block's
    piece rows; tm = 8 takes its 8 rows): bit s of item w's word for piece
    row r is set where rows [r * BM, (r + 1) * BM) x columns [s * BK,
    (s + 1) * BK) of A's tile ``a_tid[w]`` hold a nonzero (BK = 32 for f32
    tiles, 64 for bf16; NaN and Inf count as nonzero); None where every
    slice runs.  ``slices``: the slice steps of the launch without the
    mask, W x (tk // BK) x pieces (:func:`thin_pieces`); ``slices_run``:
    the steps it runs."""
    words: Optional[torch.Tensor]
    slices: int
    slices_run: int


#: elements of A one step of :func:`thin_slice_mask` reads: its temporaries
#: stay a few MiB
_MASK_CHUNK = 1 << 22

#: the least share of a launch's slice steps the mask must skip to be used.
#: With every bit set the masked block took 1.3-6.3% longer than the
#: unmasked one (f32 tm 8 the most), and its time falls about as the steps
#: it skips (PERF.md), so below this share it would not pay.
MASK_MIN_SKIP = 1 / 16


def thin_slice_mask(a_tiles: torch.Tensor, a_tid: torch.Tensor,
                    tn: int) -> Optional[SliceMask]:
    """The :class:`SliceMask` of the items ``a_tid`` (int32 [W], on the
    tiles' device) over ``a_tiles`` [nA, tm, tk], built on the tiles'
    device with one wait for it (the count).  Its ``words`` are None, and
    every slice runs, where they would skip less than
    :data:`MASK_MIN_SKIP` of the slice steps.  None where the launch does not run on the thin block
    (:func:`tile_block`) or a word cannot hold an item's tk // BK slices
    (more than 32)."""
    tm, tk = a_tiles.shape[1], a_tiles.shape[2]
    try:
        if tile_block(tm, tk, tn, a_tiles.dtype) != "mma_thin":
            return None
    except ValueError:
        return None
    bk = 64 if a_tiles.dtype == torch.bfloat16 else 32
    k_steps, bm = tk // bk, min(tm, 64)
    if k_steps > 32:
        return None
    rows, dev = tm // bm, a_tiles.device
    bit = torch.tensor([1 << s for s in range(k_steps)], dtype=torch.int64,
                       device=dev)
    # per tile: the word of each piece row, and its set bits
    word = torch.empty((a_tiles.shape[0], rows), dtype=torch.int64,
                       device=dev)
    count = torch.empty_like(word)
    chunk = max(1, _MASK_CHUNK // (tm * tk))
    for s in range(0, a_tiles.shape[0], chunk):
        hit = (a_tiles[s:s + chunk] != 0).view(
            -1, rows, bm, k_steps, bk).any(4).any(2)
        word[s:s + chunk] = (hit * bit).sum(2)
        count[s:s + chunk] = hit.sum(2)
    # bit 31 is int32's sign bit
    word = torch.where(word >= 1 << 31, word - (1 << 32), word)
    ids = a_tid.long()
    slices = int(ids.shape[0]) * k_steps * thin_pieces(tm, tn)
    run = int(count.sum(1)[ids].sum()) * (tn // 128)
    if slices - run < MASK_MIN_SKIP * slices:
        return SliceMask(None, slices, slices)
    return SliceMask(word.to(torch.int32)[ids], slices, run)


def run_worklist_streaming(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
                           a_ids, b_ids, o_ids, n_c_tiles: int,
                           nbuf: int = 8, ogroup: int = 1,
                           precision: str = "default") -> torch.Tensor:
    """Streaming engine: C tiles [n_c_tiles, tm, tn] f32 of a row-major
    worklist given as host id arrays (the port of the reference's function
    of the same name).  ``ogroup`` C tiles per block, ``nbuf`` stages in the
    kernel's shared-memory ring (:func:`tile_stream`).  ``ogroup`` defaults
    to 1, not the reference's 8: on an H100 a group of 8 runs serially in
    one block, and on the nn pair that took 24-37% longer than one C tile per
    block (PERF.md); it changes no value of C."""
    _check_precision(precision)
    return _streaming_call(a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c_tiles,
                           nbuf, ogroup)()


def _streaming_call(a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c_tiles: int,
                    nbuf: int = 8, ogroup: int = 1):
    a, b, o = _host_ids(a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c_tiles)
    ptr = item_ptr_of(o, n_c_tiles, ogroup)
    ids = _on(a_tiles.device, a, b, o, ptr)
    return lambda: tile_stream(a_tiles, b_tiles, *ids, n_c_tiles, ogroup,
                               nbuf)


def run_worklist_panel(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
                       a_ids, b_ids, o_ids, n_c_tiles: int,
                       precision: str = "default",
                       out_dtype: torch.dtype = torch.float32,
                       a_tiles_t: Optional[torch.Tensor] = None,
                       run_order: Optional[str] = None,
                       c_rows=None, c_cols=None):
    """Panel engine; returns ``(c_tiles, None, None, run_perm)``, the
    reference's ``(c_tiles, a_plan, b_plan, run_perm)``: its two slot plans
    are VMEM machinery with no counterpart here.  ``a_tiles_t`` [nA, tk,
    tm] passes A k-transposed already; otherwise ``a_tiles`` is transposed
    once on its device.  ``out_dtype`` float32 or bfloat16 (one rounding of
    the f32 sum).

    ``run_order`` ('row' | 'col' | 'diag' | 'auto'; needs ``c_rows`` and
    ``c_cols``, the C tiles' coordinates) is the order in which the C tiles
    are computed and returned: output position p holds original C tile
    ``run_perm[p]`` (None: the identity, row order).  The relabelled o ids
    stay sorted, so the kernel runs unchanged.  'auto' takes the order with
    the fewest loads that the reference's panel planner
    (:mod:`~spada_tpu_torch.ops.panelplan`) plans under the slot counts of
    the reference's 12 MiB VMEM fit (:func:`panel_plan_slots`), so it
    chooses what the reference chooses; where the planner deadlocks at
    those counts (the reference raises there), under the reference's
    unclamped counts, 12 and 16.  Those slot counts are a planning model
    only: the CUDA kernel has no slots, and L2 serves its reuse."""
    from spada_tpu_torch.ops.panelplan import (_RUN_ORDERS, choose_run_order,
                                               order_runs, permute_runs)

    if run_order not in (None, "auto") + _RUN_ORDERS:
        raise ValueError(f"unknown run order {run_order!r}")
    _check_precision(precision)
    run_perm = None
    if run_order not in (None, "row") and len(o_ids) and n_c_tiles:
        if c_rows is None or c_cols is None:
            raise ValueError("run_order needs c_rows and c_cols")
        a_ids, b_ids, o_ids = (np.asarray(x) for x in (a_ids, b_ids, o_ids))
        run_ptr = np.searchsorted(o_ids, np.arange(n_c_tiles + 1)).astype(
            np.int64)
        if run_order == "auto":
            plan = (a_ids, b_ids, run_ptr, c_rows, c_cols)
            try:
                run_order, run_perm, _ = choose_run_order(
                    *plan, *panel_plan_slots(a_tiles.shape[1],
                                             a_tiles.shape[2],
                                             b_tiles.shape[2],
                                             a_tiles.element_size()))
            except RuntimeError as err:
                # the planner finds no safe window at the fit's slot counts
                # (long runs at T = 512, where the reference raises this
                # error): rank under the reference's unclamped counts
                if "deadlock" not in str(err):
                    raise
                run_order, run_perm, _ = choose_run_order(
                    *plan, *_PANEL_SLOTS)
        else:
            run_perm = order_runs(c_rows, c_cols, run_order)
        if run_order == "row":
            run_perm = None
        else:
            _, o_ids, a_ids, b_ids = permute_runs(run_perm, run_ptr, a_ids,
                                                  b_ids)
    c = _panel_call(a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c_tiles,
                    out_dtype, a_tiles_t)()
    return c, None, None, run_perm


#: the reference panel kernel's (a_slots, b_slots, depth, max_panel)
_PANEL_SLOTS = (12, 16, 4, 4)


def panel_plan_slots(tm: int, tk: int, tn: int, itemsize: int) -> tuple:
    """(a_slots, b_slots, depth, max_panel) of the reference's panel kernel
    for these tiles: its defaults (12, 16, 4, 4, ogroup 8) shrunk to its 12
    MiB VMEM fit (``spada_tpu/ops/engine.py:1362-1374``).  A planning model
    for ``run_order='auto'``, not a property of the CUDA kernel."""
    (a_slots, b_slots, depth, max_panel), ogroup = _PANEL_SLOTS, 8
    total = 12 * 1024 * 1024
    while ogroup > 1 and 2 * ogroup * tm * tn * 4 > total // 2:
        ogroup //= 2
    budget = total - 2 * ogroup * tm * tn * 4
    need = (a_slots * tk * tm + b_slots * tk * tn) * itemsize
    floor = max_panel + depth + 2
    if need > budget:
        scale = budget / need
        a_slots = max(floor, int(a_slots * scale))
        b_slots = max(floor, int(b_slots * scale))
    return a_slots, b_slots, depth, max_panel


def _panel_call(a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c_tiles: int,
                out_dtype: torch.dtype = torch.float32,
                a_tiles_t: Optional[torch.Tensor] = None):
    a, b, o = _host_ids(a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c_tiles)
    if a_tiles_t is None:
        a_tiles_t = a_tiles.transpose(1, 2).contiguous()
    ids = _on(b_tiles.device, a, b, tile_ptr_of(o, n_c_tiles))
    return lambda: tile_panel(a_tiles_t, b_tiles, *ids, out_dtype)


def run_worklist_pallas(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
                        a_ids, b_ids, o_ids, first, n_c_tiles: int,
                        precision: str = "highest") -> torch.Tensor:
    """Item-per-block engine (``engine='pallas_grid'``): C tiles
    [n_c_tiles, tm, tn] f32 of a row-major worklist given as host arrays.
    ``first`` must be 1 exactly where an ``o_ids`` run starts, as
    ``build_worklist`` makes it; the kernel itself does not read it."""
    _check_precision(precision)
    return _grid_call(a_tiles, b_tiles, a_ids, b_ids, o_ids, first,
                      n_c_tiles)()


def _grid_call(a_tiles, b_tiles, a_ids, b_ids, o_ids, first, n_c_tiles: int):
    a, b, o = _host_ids(a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c_tiles)
    starts = np.r_[True, o[1:] != o[:-1]] if len(o) else np.zeros(0, bool)
    if np.shape(first) != o.shape or not np.array_equal(
            np.asarray(first) != 0, starts):
        raise ValueError("first must be 1 exactly at the starts of o_ids's "
                         "runs")
    ids = _on(a_tiles.device, a, b, o)
    return lambda: tile_grid(a_tiles, b_tiles, *ids, n_c_tiles)


def _host_ids(a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c_tiles: int,
              row_major: bool = True):
    """A worklist's ids as int32 host arrays, checked.  The kernels read
    tiles and C by id unchecked (a device check would wait for the device),
    so the ids are bounded here."""
    a, b, o = (np.ascontiguousarray(x, np.int32)
               for x in (a_ids, b_ids, o_ids))
    if a.ndim != 1 or not a.shape == b.shape == o.shape:
        raise ValueError("a_ids, b_ids and o_ids must be 1-D and of one "
                         "length")
    if len(a) and (min(a.min(), b.min()) < 0
                   or int(a.max()) >= a_tiles.shape[0]
                   or int(b.max()) >= b_tiles.shape[0]):
        raise ValueError("worklist tile ids exceed the tile arrays")
    if len(o) and (o.min() < 0 or int(o.max()) >= n_c_tiles):
        raise ValueError("worklist C tile ids exceed n_c_tiles")
    if row_major and np.any(o[1:] < o[:-1]):
        raise ValueError("the tile kernels need a row-major (o-sorted) "
                         "worklist: o_ids must be nondecreasing")
    return a, b, o


def _on(dev: torch.device, *arrays):
    with trace.span("layout.upload", bytes=sum(x.nbytes for x in arrays)):
        return tuple(torch.from_numpy(x).to(dev) for x in arrays)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def run_worklist_reference(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
                           a_ids: torch.Tensor, b_ids: torch.Tensor,
                           o_ids: torch.Tensor, n_c_tiles: int,
                           chunk_bytes: int = 1 << 30) -> torch.Tensor:
    """Plain PyTorch tile engine: chunked gather -> f32 ``bmm`` ->
    ``index_add_`` (the port of the reference's ``_run_xla``).

    Order-independent, so it runs any worklist.  Chunks hold at most
    ``chunk_bytes`` of gathered f32 operands.  bf16 tiles are widened to f32
    before the product, so products are exact and only the summation order
    differs from the kernels.
    """
    tm, tk, tn = a_tiles.shape[1], a_tiles.shape[2], b_tiles.shape[2]
    c = torch.zeros((n_c_tiles, tm, tn), dtype=torch.float32,
                    device=a_tiles.device)
    W = int(a_ids.shape[0])
    if W == 0 or n_c_tiles == 0:
        return c
    a_ids, b_ids, o_ids = a_ids.long(), b_ids.long(), o_ids.long()
    chunk = max(1, chunk_bytes // ((tm * tk + tk * tn + tm * tn) * 4))
    for s in range(0, W, chunk):
        sl = slice(s, min(s + chunk, W))
        part = torch.bmm(a_tiles[a_ids[sl]].float(),
                         b_tiles[b_ids[sl]].float())
        c.index_add_(0, o_ids[sl], part)
    return c


def _run_o_ids(tile_ptr: torch.Tensor, n_items: int) -> torch.Tensor:
    """The C tile of every item of an o-sorted worklist, from its
    ``tile_ptr`` (no device wait: the length is given)."""
    n_c = int(tile_ptr.shape[0]) - 1
    return torch.repeat_interleave(
        torch.arange(n_c, device=tile_ptr.device), torch.diff(tile_ptr.long()),
        output_size=n_items)


def tile_stream_reference(a_tiles, b_tiles, a_tid, b_tid, o_tid, item_ptr,
                          n_c_tiles: int, ogroup: int, nbuf: int = 8
                          ) -> torch.Tensor:
    """Plain version of :func:`tile_stream`: the grouping changes no
    value of C."""
    return run_worklist_reference(a_tiles, b_tiles, a_tid, b_tid, o_tid,
                                  n_c_tiles)


def tile_panel_reference(a_tiles_t, b_tiles, a_tid, b_tid, tile_ptr,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain version of :func:`tile_panel`: A un-transposed, the f32 sum
    rounded once to ``out_dtype``."""
    n_c = int(tile_ptr.shape[0]) - 1
    c = run_worklist_reference(a_tiles_t.transpose(1, 2), b_tiles, a_tid,
                               b_tid, _run_o_ids(tile_ptr, a_tid.shape[0]),
                               n_c)
    return c.to(out_dtype)


def tile_grid_reference(a_tiles, b_tiles, a_tid, b_tid, o_tid,
                        n_c_tiles: int) -> torch.Tensor:
    """Plain version of :func:`tile_grid`."""
    return run_worklist_reference(a_tiles, b_tiles, a_tid, b_tid, o_tid,
                                  n_c_tiles)


# --------------------------------------------------------------------------
# Kernel wrappers: CUDA tensors launch the kernel, CPU tensors take the
# plain version.  Ids are not bounds-checked on the device (that would wait
# for it): the run_worklist* functions check them on the host.
# --------------------------------------------------------------------------

def tile_spgemm(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
                a_tid: torch.Tensor, b_tid: torch.Tensor,
                tile_ptr: torch.Tensor,
                mask: Optional[SliceMask] = None) -> torch.Tensor:
    """C tiles [nC, tm, tn] f32 of an o-sorted worklist.

    ``a_tiles`` [nA, tm, tk] and ``b_tiles`` [nB, tk, tn] (f32 or bf16),
    ``a_tid``/``b_tid`` int32 [W], ``tile_ptr`` int32 [nC + 1] (C tile c's
    items are ``tile_ptr[c]:tile_ptr[c+1]``; an empty run gives a zero
    tile).  CUDA tensors run ``csrc/tile_spgemm.cu`` on the block
    :func:`tile_block` names: wide tiles (``"mma"``) and the planner's thin
    row panels, tm 8-64 (``"mma_thin"``), on tensor cores (f32 as 3xTF32,
    bf16 as bf16 ``mma``, f32 sums); tk not a multiple of the tensor-core
    k-slice (32 f32, 64 bf16) or tn not of 128 on FP32 FMAs.  Every launch
    counts as ``"tile_spgemm"`` in ``_build.launches``, and a launch of
    the thin block also as ``"tile_spgemm_thin"``: the kernel reports the
    block it ran on, and a block other than :func:`tile_block`'s raises.

    ``mask`` (:func:`thin_slice_mask` of these A tiles and items; thin
    block only) skips the k-slices of A that are all zero where its
    ``words`` are given; None takes the
    mask :func:`prepare_cached` left on ``a_tid`` (``a_tid.slice_mask``),
    and where there is none every slice runs.  A skipped slice adds exactly
    +0 to C where B is finite, so C is the same bit for bit; where B holds
    an Inf or NaN, a skipped slice no longer turns it into NaN, as the
    sparse product would not.  The plain version ignores the mask.  The
    ``launch`` span carries the mask's ``slices`` and ``slices_run``, and
    ``macs`` (:func:`launch_macs`).
    """
    if mask is None:
        mask = getattr(a_tid, "slice_mask", None)
    t = (trace.launch("tile_spgemm", items=int(a_tid.shape[0]),
                      macs=launch_macs(a_tiles, b_tiles, a_tid, mask),
                      **({} if mask is None else
                         {"slices": mask.slices,
                          "slices_run": mask.slices_run}))
         if trace.active() else None)
    try:
        _check_tile_args("tile_spgemm", a_tiles, b_tiles, 2, a_tid=a_tid,
                         b_tid=b_tid, tile_ptr=tile_ptr)
        tm, tk, tn = a_tiles.shape[1], a_tiles.shape[2], b_tiles.shape[2]
        n_c = int(tile_ptr.shape[0]) - 1
        words = None if mask is None else mask.words
        if words is not None:
            _check_mask(words, a_tiles, a_tid, tn)
        if a_tiles.device.type == "cpu":
            if t is not None:
                t.step("launch.call", block="plain")
            return run_worklist_reference(
                a_tiles, b_tiles, a_tid, b_tid,
                _run_o_ids(tile_ptr, a_tid.shape[0]), n_c)
        block = _has_work("tile_spgemm", n_c, a_tid.shape[0], tm, tk, tn,
                          a_tiles.dtype)
        if t is not None:
            t.step("launch.alloc", block=block)
        c = torch.empty((n_c, tm, tn), dtype=torch.float32,
                        device=a_tiles.device)
        if block is None:
            return c.zero_()
        if t is not None:
            t.step("launch.call")
        lib = _build.load()
        fn = (lib.tile_spgemm_f32 if a_tiles.dtype == torch.float32
              else lib.tile_spgemm_bf16)
        _launch_reporting("tile_spgemm", block, (tm, tk, tn), a_tiles, fn,
                          a_tiles.data_ptr(), b_tiles.data_ptr(),
                          a_tid.data_ptr(), b_tid.data_ptr(),
                          tile_ptr.data_ptr(),
                          None if words is None else words.data_ptr(),
                          c.data_ptr(), n_c, tm, tk, tn)
        return c
    finally:
        if t is not None:
            t.end()


def launch_macs(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
                a_tid: torch.Tensor, mask: Optional[SliceMask] = None) -> int:
    """The multiply-adds a tile launch of the items ``a_tid`` runs: tm x tk
    x tn per item (``a_tiles`` [nA, tm, tk], or k-transposed, ``b_tiles``
    [nB, tk, tn]), scaled by the slice steps ``mask`` runs of its
    ``slices`` where it skips A's all-zero k-slices.  The ``launch`` span's
    ``macs``: the wrappers count it only while spans are recorded."""
    macs = (int(a_tid.shape[0]) * a_tiles.shape[1] * a_tiles.shape[2]
            * b_tiles.shape[2])
    if mask is not None and mask.words is not None:
        macs = macs * mask.slices_run // mask.slices
    return macs


def tile_resident_blocks(tm: int, tk: int, tn: int, dtype,
                         device=None) -> tuple:
    """(block, blocks per SM): the block :func:`tile_spgemm` runs tm x tk x
    tn tiles of ``dtype`` on (:func:`tile_block`'s name) and how many of
    it one SM of the CUDA ``device`` holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, from
    ``csrc/tile_spgemm.cu``'s ``tile_spgemm_occupancy``).  Launches
    nothing; needs a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("tile_resident_blocks: no CUDA device")
    bf16 = "bfloat16" in str(dtype)
    lib = _build.load()
    block, per_sm = ctypes.c_int(-1), ctypes.c_int(0)
    with torch.cuda.device(device if device is not None
                           else torch.cuda.current_device()):
        _build.check(lib.tile_spgemm_occupancy(
            int(bf16), tm, tk, tn, ctypes.byref(block),
            ctypes.byref(per_sm)), "tile_spgemm_occupancy")
    got = _BLOCKS[block.value]
    want = tile_block(tm, tk, tn, dtype)
    if got != want:
        raise RuntimeError(f"tile_spgemm_occupancy: tm={tm} tk={tk} tn={tn} "
                           f"names the {got} block, tile_block {want}")
    return got, per_sm.value


def tile_stream(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
                a_tid: torch.Tensor, b_tid: torch.Tensor,
                o_tid: torch.Tensor, item_ptr: torch.Tensor,
                n_c_tiles: int, ogroup: int, nbuf: int = 8) -> torch.Tensor:
    """C tiles [n_c_tiles, tm, tn] f32 of an o-sorted worklist, walked in
    groups of ``ogroup`` C tiles.

    ``a_tid``/``b_tid``/``o_tid`` int32 [W] (``o_tid`` nondecreasing),
    ``item_ptr`` int32 [ceil(n_c_tiles / ogroup) + 1]: group g's items are
    ``item_ptr[g]:item_ptr[g+1]`` (:func:`~spada_tpu_torch.convert.item_ptr_of`).
    ``nbuf`` (2..16) asks for the depth of the kernel's shared-memory
    ring: the tensor-core path runs the compiled depth ``min(nbuf, 4)``,
    the FP32 paths ``nbuf``; the thin one always rings 2 stages deep for
    f32 tiles and 3 for bf16.  ``ogroup`` changes no value of C.  A C
    tile with no items is a zero tile.  CUDA tensors run
    ``csrc/tile_stream.cu`` on the block :func:`tile_block` names, as
    :func:`tile_spgemm` (whose C it is bit for bit at ``ogroup`` 1 on the
    tensor-core blocks); a launch of the thin block also counts as
    ``"tile_stream_thin"``, from the block the kernel reports.
    """
    t = (trace.launch("tile_stream", items=int(a_tid.shape[0]),
                      macs=launch_macs(a_tiles, b_tiles, a_tid))
         if trace.active() else None)
    try:
        _check_tile_args("tile_stream", a_tiles, b_tiles, 2, a_tid=a_tid,
                         b_tid=b_tid, o_tid=o_tid, item_ptr=item_ptr)
        if ogroup < 1 or item_ptr.shape[0] != -(-n_c_tiles // ogroup) + 1:
            raise ValueError("tile_stream: item_ptr needs ceil(n_c_tiles / "
                             "ogroup) + 1 entries, ogroup >= 1")
        if not 2 <= nbuf <= 16:
            raise ValueError(f"tile_stream: nbuf must be in 2..16, got "
                             f"{nbuf}")
        tm, tk, tn = a_tiles.shape[1], a_tiles.shape[2], b_tiles.shape[2]
        if a_tiles.device.type == "cpu":
            if t is not None:
                t.step("launch.call", block="plain")
            return tile_stream_reference(a_tiles, b_tiles, a_tid, b_tid,
                                         o_tid, item_ptr, n_c_tiles, ogroup,
                                         nbuf)
        block = _has_work("tile_stream", n_c_tiles, a_tid.shape[0], tm, tk,
                          tn, a_tiles.dtype)
        if t is not None:
            t.step("launch.alloc", block=block)
        c = torch.empty((n_c_tiles, tm, tn), dtype=torch.float32,
                        device=a_tiles.device)
        if block is None:
            return c.zero_()
        if t is not None:
            t.step("launch.call")
        lib = _build.load()
        fn = (lib.tile_stream_f32 if a_tiles.dtype == torch.float32
              else lib.tile_stream_bf16)
        _launch_reporting("tile_stream", block, (tm, tk, tn), a_tiles, fn,
                          a_tiles.data_ptr(), b_tiles.data_ptr(),
                          a_tid.data_ptr(), b_tid.data_ptr(),
                          o_tid.data_ptr(), item_ptr.data_ptr(),
                          c.data_ptr(), n_c_tiles, ogroup, tm, tk, tn, nbuf)
        return c
    finally:
        if t is not None:
            t.end()


def tile_panel(a_tiles_t: torch.Tensor, b_tiles: torch.Tensor,
               a_tid: torch.Tensor, b_tid: torch.Tensor,
               tile_ptr: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C tiles [nC, tm, tn] of an o-sorted worklist, each run one
    contraction over its k-concatenated tiles.

    ``a_tiles_t`` [nA, tk, tm] is A k-transposed, ``b_tiles`` [nB, tk, tn]
    (f32 or bf16), ``tile_ptr`` int32 [nC + 1] as for :func:`tile_spgemm`.
    The f32 sum is written as ``out_dtype`` (float32, or bfloat16 rounded
    once, to nearest even).  An empty run gives a zero tile.  CUDA tensors
    run ``csrc/tile_panel.cu`` on the block :func:`tile_block` names, as
    :func:`tile_spgemm` (whose f32 C the f32 output equals bit for bit on
    the tensor-core blocks); a launch of the thin block also counts as
    ``"tile_panel_thin"``, from the block the kernel reports.
    """
    t = (trace.launch("tile_panel", items=int(a_tid.shape[0]),
                      macs=launch_macs(a_tiles_t, b_tiles, a_tid))
         if trace.active() else None)
    try:
        _check_tile_args("tile_panel", a_tiles_t, b_tiles, 1, a_tid=a_tid,
                         b_tid=b_tid, tile_ptr=tile_ptr)
        if out_dtype not in _TILE_DTYPES:
            raise TypeError(f"tile_panel: out_dtype must be float32 or "
                            f"bfloat16, got {out_dtype}")
        tk, tm, tn = (a_tiles_t.shape[1], a_tiles_t.shape[2],
                      b_tiles.shape[2])
        n_c = int(tile_ptr.shape[0]) - 1
        if a_tiles_t.device.type == "cpu":
            if t is not None:
                t.step("launch.call", block="plain")
            return tile_panel_reference(a_tiles_t, b_tiles, a_tid, b_tid,
                                        tile_ptr, out_dtype)
        block = _has_work("tile_panel", n_c, a_tid.shape[0], tm, tk, tn,
                          a_tiles_t.dtype)
        if t is not None:
            t.step("launch.alloc", block=block)
        c = torch.empty((n_c, tm, tn), dtype=out_dtype,
                        device=b_tiles.device)
        if block is None:
            return c.zero_()
        if t is not None:
            t.step("launch.call")
        lib = _build.load()
        fn = (lib.tile_panel_f32 if a_tiles_t.dtype == torch.float32
              else lib.tile_panel_bf16)
        _launch_reporting("tile_panel", block, (tm, tk, tn), b_tiles, fn,
                          a_tiles_t.data_ptr(), b_tiles.data_ptr(),
                          a_tid.data_ptr(), b_tid.data_ptr(),
                          tile_ptr.data_ptr(), c.data_ptr(), n_c, tm, tk, tn,
                          int(out_dtype == torch.bfloat16))
        return c
    finally:
        if t is not None:
            t.end()


def tile_grid(a_tiles: torch.Tensor, b_tiles: torch.Tensor,
              a_tid: torch.Tensor, b_tid: torch.Tensor, o_tid: torch.Tensor,
              n_c_tiles: int) -> torch.Tensor:
    """C tiles [n_c_tiles, tm, tn] f32: every item's product added into
    ``C[o_tid[w]]``, in any item order.  C starts zeroed, so a tile with no
    items is a zero tile.  The adds are f32 atomics whose order changes
    from run to run.  CUDA tensors run ``csrc/tile_grid.cu`` on the block
    :func:`tile_block` names, with the arithmetic of :func:`tile_spgemm`:
    wide tiles one block per item and piece, the planner's thin row panels
    (tm 8-64) one block per piece and chunk of :func:`grid_chunk`
    consecutive items, each run of a chunk (consecutive items of one C
    tile) added once, both on tensor cores; the other shapes one block per
    item and piece on FP32 FMAs.  A launch of the thin block also counts as
    ``"tile_grid_thin"``: the kernel reports the block it ran on, and a
    block other than :func:`tile_block`'s raises.
    """
    return _tile_grid_launch(a_tiles, b_tiles, a_tid, b_tid, o_tid,
                             n_c_tiles)


def _tile_grid_launch(a_tiles, b_tiles, a_tid, b_tid, o_tid, n_c_tiles: int,
                      chunk: Optional[int] = None) -> torch.Tensor:
    """:func:`tile_grid` with the thin path's G given (``chunk``; None:
    :func:`grid_chunk`'s), for the tests and the sweep that measure the
    rule."""
    t = (trace.launch("tile_grid", items=int(a_tid.shape[0]),
                      macs=launch_macs(a_tiles, b_tiles, a_tid))
         if trace.active() else None)
    try:
        _check_tile_args("tile_grid", a_tiles, b_tiles, 2, a_tid=a_tid,
                         b_tid=b_tid, o_tid=o_tid)
        tm, tk, tn = a_tiles.shape[1], a_tiles.shape[2], b_tiles.shape[2]
        if a_tiles.device.type == "cpu":
            if t is not None:
                t.step("launch.call", block="plain")
            return tile_grid_reference(a_tiles, b_tiles, a_tid, b_tid, o_tid,
                                       n_c_tiles)
        n_items = int(a_tid.shape[0])
        block = _has_work("tile_grid", n_c_tiles, n_items, tm, tk, tn,
                          a_tiles.dtype)
        if chunk is None:
            chunk = (grid_chunk(n_items, thin_pieces(tm, tn),
                                sm_count(a_tiles.device))
                     if block == "mma_thin" else 1)
        if t is not None:
            t.step("launch.alloc", block=block)
        c = torch.zeros((n_c_tiles, tm, tn), dtype=torch.float32,
                        device=a_tiles.device)
        if block is None:
            return c
        if t is not None:
            t.step("launch.call")
        lib = _build.load()
        fn = (lib.tile_grid_f32 if a_tiles.dtype == torch.float32
              else lib.tile_grid_bf16)
        _launch_reporting("tile_grid", block, (tm, tk, tn), a_tiles, fn,
                          a_tiles.data_ptr(), b_tiles.data_ptr(),
                          a_tid.data_ptr(), b_tid.data_ptr(),
                          o_tid.data_ptr(), c.data_ptr(), n_items, tm, tk,
                          tn, int(chunk))
        return c
    finally:
        if t is not None:
            t.end()


@functools.lru_cache(maxsize=None)
def sm_count(dev: torch.device) -> int:
    """The SMs of CUDA device ``dev`` (:func:`grid_chunk`'s ``n_sms``)."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _has_work(kernel: str, n_c: int, n_items: int, tm: int, tk: int,
              tn: int, dtype=torch.float32) -> Optional[str]:
    """The block a launch runs on (:func:`tile_block`), or None where no
    launch is needed; raises for tiles no block shape takes.  An empty grid
    is a launch error, and no items means zero tiles."""
    if n_c == 0 or n_items == 0 or 0 in (tm, tk, tn):
        return None
    return tile_block(tm, tk, tn, dtype, kernel)


def _launched(kernel: str, status: int) -> None:
    _build.check(status, kernel)
    _build.launches[kernel] += 1


def _launch_reporting(kernel: str, block: str, shape: tuple, like, fn,
                      *args) -> None:
    """Launch ``fn(*args, &ran, stream)``, a kernel that reports the block
    it ran on in ``ran``, on the current stream of ``like``'s device; raise
    where that block is not ``block`` (:func:`tile_block`'s), and count a
    launch of the thin block also as ``kernel + "_thin"``."""
    ran = ctypes.c_int(-1)
    _launched(kernel, fn(*args, ctypes.byref(ran),
                         _build.current_stream(like)))
    got = (_BLOCKS[ran.value] if 0 <= ran.value < len(_BLOCKS)
           else f"unknown ({ran.value})")
    if got != block:
        tm, tk, tn = shape
        raise RuntimeError(f"{kernel}: tm={tm} tk={tk} tn={tn} ran on the "
                           f"{got} block, tile_block names {block}")
    if block == "mma_thin":
        _build.launches[f"{kernel}_thin"] += 1


def _check_mask(words, a_tiles, a_tid, tn: int) -> None:
    """Raise where ``words`` is not a slice mask the thin block can read
    for these items (:class:`SliceMask`)."""
    tm, tk = a_tiles.shape[1], a_tiles.shape[2]
    if tile_block(tm, tk, tn, a_tiles.dtype) != "mma_thin":
        raise ValueError(f"tile_spgemm: a slice mask is for the thin block; "
                         f"tm={tm} tk={tk} tn={tn} does not run on it")
    want = (a_tid.shape[0], tm // min(tm, 64))
    if (words.dtype != torch.int32 or tuple(words.shape) != want
            or words.device != a_tiles.device or not words.is_contiguous()):
        raise ValueError(f"tile_spgemm: the slice mask must be contiguous "
                         f"int32 {list(want)} on {a_tiles.device}")


def _check_tile_args(kernel: str, a_tiles, b_tiles, a_k_dim: int,
                     **ids) -> None:
    """``a_k_dim``: the dimension of ``a_tiles`` that holds k (2 natural,
    1 k-transposed)."""
    if a_tiles.dim() != 3 or b_tiles.dim() != 3:
        raise ValueError(f"{kernel}: tiles must be [n, rows, cols]")
    if a_tiles.shape[a_k_dim] != b_tiles.shape[1]:
        raise ValueError(f"{kernel}: tk mismatch {tuple(a_tiles.shape)} "
                         f"@ {tuple(b_tiles.shape)}")
    if a_tiles.dtype not in _TILE_DTYPES or b_tiles.dtype != a_tiles.dtype:
        raise TypeError(f"{kernel}: tiles must both be float32 or both "
                        f"bfloat16, got {a_tiles.dtype} and {b_tiles.dtype}")
    for name, t in ids.items():
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{kernel}: {name} must be 1-D int32")
    if len({t.shape[0] for name, t in ids.items()
            if name.endswith("_tid")}) > 1:
        raise ValueError(f"{kernel}: the id arrays differ in length")
    for name in ("tile_ptr", "item_ptr"):
        if name in ids and ids[name].shape[0] < 1:
            raise ValueError(f"{kernel}: {name} needs at least one entry")
    tensors = (a_tiles, b_tiles, *ids.values())
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{kernel}: arguments on several devices {devs}")
    dev = a_tiles.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel}: arguments must be contiguous")
    if dev.type == "cuda" and (a_tiles.data_ptr() % 16
                               or b_tiles.data_ptr() % 16):
        # the kernels read tiles in 16-byte (or 8-byte bf16) pieces
        raise ValueError(f"{kernel}: tiles must start 16-byte aligned")
