"""What the planner's calibration and evaluation tools share.

- :func:`first_rows_ref` and :func:`gate`: C's first rows against scipy's
  product of the same CSR pair, as max|d| / max|ref| over those rows (the
  bench's gate, ``bench.py``), held sparse so a wide C costs no dense copy;
- :func:`tile_rows`: those rows of a tile result (C tiles on the device,
  their tile coordinates, and where each tile row starts in C);
- :func:`device_s`: the median device seconds of a call with no arguments
  (``utils.timing.cuda_time``), None on the CPU, where there is no device
  time;
- :data:`ITEM_TERMS` and :func:`reference_item_terms`: the planner's three
  per-item fields, and their values in ``SpadaConfig`` (the reference's
  fit on its own chip).
"""

from __future__ import annotations

from typing import Callable, Optional

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


def device_s(call: Callable, dev) -> Optional[float]:
    """Median device seconds of ``call()`` on a CUDA ``dev``
    (:func:`~spada_tpu_torch.utils.timing.cuda_time`); None on the CPU."""
    if dev.type != "cuda":
        return None
    from spada_tpu_torch.utils.timing import cuda_time

    return cuda_time(call)[0]


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
