"""What the planner's calibration and evaluation tools share.

- :func:`first_rows_ref` and :func:`gate`: C's first rows against scipy's
  product of the same CSR pair, as max|d| / max|ref| over those rows (the
  bench's gate, ``bench.py``), held sparse so a wide C costs no dense copy;
- :func:`tile_rows`: those rows of a tile result (C tiles on the device,
  their tile coordinates, and where each tile row starts in C);
- :func:`call_s`: the median seconds of a call, device seconds on a card
  (``utils.timing.cuda_time``, uncounted in ``_build.launches``), CPU wall
  seconds otherwise; :func:`device_s`: the same on a card, None on the
  CPU, where there is no device time;
- :func:`spawn_groups`, :func:`gloo_group` and :func:`rank_path`: gloo
  groups of spawned ranks on the CPU, each rank's result left in a file;
- :data:`ITEM_TERMS` and :func:`reference_item_terms`: the planner's three
  per-item fields, and their values in ``SpadaConfig`` (the reference's
  fit on its own chip).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np

#: the per-item fields of ``SpadaConfig`` that the card's fit replaces
ITEM_TERMS = ("engine_item_overhead_s", "engine_acc_s_per_elem",
              "engine_item_fixed_s")


def reference_item_terms() -> dict:
    """The per-item terms of ``SpadaConfig``'s defaults, a copy of the
    reference's (fitted on its chip, not on the card)."""
    from spada_tpu_torch.config import SpadaConfig

    base = SpadaConfig()
    return {f: getattr(base, f) for f in ITEM_TERMS}


def first_rows_ref(a, b, rows: int):
    """scipy CSR of (A @ B)[:rows] in f64."""
    a_sp = a.to_scipy()[:rows].astype(np.float64)
    return (a_sp @ b.to_scipy().astype(np.float64)).tocsr()


def tile_rows(c_tiles, c_tile_row, c_tile_col, tm: int, tn: int,
              shape: tuple, rows: int, bases=None):
    """scipy CSR of the first ``rows`` rows of C from its tiles
    ``c_tiles`` [nC, tm, tn] (tensor or array; only the tiles that reach
    those rows are read back).  ``bases[r]`` is the row of C where tile row
    ``r`` starts (default ``r * tm``); tiles that overlap add."""
    import scipy.sparse as sp

    tr = np.asarray(c_tile_row, np.int64)
    base = tr * tm if bases is None else np.asarray(bases, np.int64)[tr]
    keep = np.flatnonzero(base < rows)
    n_rows = min(rows, shape[0])
    if isinstance(c_tiles, np.ndarray):
        sel = c_tiles[keep]
    else:
        import torch

        sel = c_tiles[torch.from_numpy(keep).to(c_tiles.device)]
        sel = sel.float().cpu().numpy()
    t, r, c = np.indices(sel.shape).reshape(3, -1)
    g_r = base[keep][t] + r
    g_c = np.asarray(c_tile_col, np.int64)[keep][t] * tn + c
    ok = (g_r < n_rows) & (g_c < shape[1])
    return sp.csr_matrix((sel[t, r, c][ok].astype(np.float64),
                          (g_r[ok], g_c[ok])), shape=(n_rows, shape[1]))


def gate(got, ref, limit: float, label: str) -> float:
    """max|got - ref| / max|ref| of two scipy matrices of one shape; raises
    ``RuntimeError`` above ``limit``."""
    ref = ref.tocsr()
    diff = (got.tocsr() - ref).tocsr()
    top = float(np.abs(ref.data).max()) if ref.nnz else 0.0
    err = (float(np.abs(diff.data).max()) if diff.nnz else 0.0) / max(
        top, 1e-30)
    if not err <= limit:
        raise RuntimeError(f"{label}: C's first rows differ from scipy by "
                             f"{err:.3e} of max|C| (limit {limit:g})")
    return err


def call_s(call: Callable, dev, *args, warmup: int = 2,
           reps: int = 10) -> float:
    """Median seconds of ``call(*args)``: on a CUDA ``dev`` its device
    seconds (``cuda_time``), the timing's launches taken back out of
    ``_build.launches`` so that the counts stay the path's own; on the CPU
    wall seconds of ``reps`` calls after ``warmup``."""
    if dev.type == "cuda":
        from spada_tpu_torch import _build
        from spada_tpu_torch.utils.timing import cuda_time

        saved = _build.launches.copy()
        try:
            return cuda_time(call, *args, warmup=warmup, reps=reps)[0]
        finally:
            _build.launches.clear()
            _build.launches.update(saved)
    for _ in range(warmup):
        call(*args)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call(*args)
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples))


def device_s(call: Callable, dev) -> Optional[float]:
    """:func:`call_s` of ``call()`` on a CUDA ``dev``; None on the CPU."""
    return call_s(call, dev) if dev.type == "cuda" else None


def rank_path(workdir: str, rank: int) -> str:
    """The file where rank ``rank`` of a group of :func:`spawn_groups`
    leaves its result."""
    return os.path.join(workdir, f"rank{rank}.pkl")


def spawn_groups(groups: Sequence[tuple], rank_main: Callable,
                 timeout: float) -> None:
    """Run ``rank_main(rank, world, workdir)`` in a spawned process per
    rank of each group ``(world, workdir)`` of ``groups``, every group at
    once, and wait for them all.  A rank joins its group with
    :func:`gloo_group` and leaves its result in :func:`rank_path`, where
    the caller reads it.  Raises ``TimeoutError`` past ``timeout`` seconds,
    and what ``ProcessContext.join`` raises for a rank that failed before
    leaving its result; kills every process still alive."""
    import torch.multiprocessing as mp

    started = []
    try:
        for world, work in groups:
            # the inputs go through files in ``work``: spawn writes a
            # process's arguments into a pipe that the child reads only
            # after its imports, so large arguments would start the ranks
            # one after another
            started.append((mp.start_processes(
                rank_main, args=(world, work), nprocs=world, join=False,
                start_method="spawn"), world, work))
        deadline = time.monotonic() + timeout
        pending = list(started)
        while pending:
            pending = [g for g in pending if not _joined(*g)]
            if pending and time.monotonic() > deadline:
                raise TimeoutError(f"the gloo groups of "
                                   f"{[w for _, w, _ in pending]} ranks ran "
                                   f"past {timeout} s")
    finally:
        for ctx, _, _ in started:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()


def _joined(ctx, world: int, work: str) -> bool:
    import torch.multiprocessing as mp

    try:
        return ctx.join(timeout=0.2)
    except mp.ProcessExitedException:
        # a rank that left its result and then died in the gloo teardown
        # has done its work; one that died before has not
        if all(os.path.exists(rank_path(work, r)) for r in range(world)):
            return True
        raise


@contextlib.contextmanager
def gloo_group(rank: int, world: int, workdir: str, timeout_s: float):
    """Inside a rank of :func:`spawn_groups`: the default gloo group, its
    store a ``FileStore`` in ``workdir`` (no port, no network), each
    collective limited to ``timeout_s``.  On leaving without an error the
    ranks wait for each other, then destroy the group."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    yield
    # no rank tears its connections down while another still uses them
    dist.barrier()
    dist.destroy_process_group()


def card_name(dev) -> Optional[str]:
    """The card's name (``torch.cuda.get_device_name``), None on the CPU."""
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else None


def fmt_ms(s: Optional[float]) -> str:
    """Seconds as ms to 3 places, or 'not timed' (CPU)."""
    return "not timed" if s is None else f"{s * 1e3:.3f}"


def element_entry(a, b, dev, cap: int = 512,
                  max_slab_products: int = 2 ** 28) -> tuple:
    """The element side as ``spgemm_element(backend='auto')`` runs it: per
    row slab of at most ``max_slab_products`` products (one slab below
    that), one ESC plan, its stream layout, the operands uploaded once and
    one ``esc_stream_group`` launch.  Returns (calls, csr): a call per slab
    and C as one scipy CSR, each slab launched once."""
    import scipy.sparse as sp

    from spada_tpu_torch.convert import stream_operands_to_torch
    from spada_tpu_torch.ops.element import (_row_slab_bounds, _slice_rows,
                                             build_esc_plan,
                                             expansion_products)
    from spada_tpu_torch.ops.element_stream import (build_stream_layout,
                                                    stream_execute,
                                                    stream_operands,
                                                    stream_to_csr)

    m = a.shape[0]
    bounds = ([0, m] if m <= 1 or expansion_products(a, b)
              <= max_slab_products else _row_slab_bounds(a, b,
                                                         max_slab_products))
    calls, parts = [], []
    for s, t in zip(bounds[:-1], bounds[1:]):
        a_s = a if (s, t) == (0, m) else _slice_rows(a, s, t)
        plan = build_esc_plan(a_s, b, cap=cap)
        layout = build_stream_layout(plan)
        ops = stream_operands_to_torch(stream_operands(layout, plan, a_s, b),
                                       dev)
        del plan

        def call(layout=layout, ops=ops):
            return stream_execute(layout, ops)

        calls.append(call)
        parts.append(stream_to_csr(layout, call()).to_scipy())
    return calls, sp.vstack(parts).tocsr()
