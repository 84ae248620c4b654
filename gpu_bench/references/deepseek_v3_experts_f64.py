"""Plain reference of the routed experts' grouped down projection,
C = H . W2stack, and the judgement of the program's C against it.

H's rows come in groups, each group's entries within one window of columns
(one expert's rows of W2stack).  The reference finds the groups in H's
structure (runs of consecutive rows whose entries span the same columns
[lo, hi)) and multiplies, per group, its rows of H densified over [lo, hi)
by rows [lo, hi) of W2stack, in float64 with ``torch.matmul`` on the device
it is given: one expert's product at a time, so H, 32,768 x 16,384 in the
cell, is never densified whole.  Rows with no entry give C no entry.  It
takes nothing that the program made.

Each product the program returned is judged by ``spgemm_f64``'s definitions:
``max_rel_err`` (|c - c_ref| / (|H|.|W2|)_ij over C's structure),
``stray_entries`` and ``missing_entries``.
"""

from __future__ import annotations

import numpy as np
import torch

from gpu_bench.references.spgemm_f64 import _program_rows

#: elements of one block of rows' float64 temporaries
_BLOCK_ELEMENTS = 1 << 27


def groups(m):
    """[(r0, r1, lo, hi)]: the runs of rows r0:r1 of CSR ``m`` whose entries
    span columns [lo, hi) alike, in row order; rows with no entry form runs
    with lo = hi = 0."""
    indptr = np.asarray(m.indptr, np.int64)
    rows = m.shape[0]
    full = indptr[1:] > indptr[:-1]
    idx = np.asarray(m.indices, np.int64)
    lo, hi = np.zeros(rows, np.int64), np.zeros(rows, np.int64)
    if full.any():
        # each row's smallest and largest column, sorted or not
        lo[full] = np.minimum.reduceat(idx, indptr[:-1][full])
        hi[full] = np.maximum.reduceat(idx, indptr[:-1][full]) + 1
    cut = np.flatnonzero((lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])) + 1
    starts = np.concatenate(([0], cut))
    ends = np.concatenate((cut, [rows]))
    return [(int(s), int(e), int(lo[s]), int(hi[s]))
            for s, e in zip(starts, ends) if e > s]


def _window(m, r0: int, r1: int, lo: int, hi: int, values, dtype, device):
    """Rows r0:r1 of CSR ``m`` over columns [lo, hi), dense, with
    ``values`` (ones if None) added at each listed entry."""
    indptr = np.asarray(m.indptr, np.int64)
    s, e = int(indptr[r0]), int(indptr[r1])
    counts = torch.from_numpy(np.diff(indptr[r0:r1 + 1])).to(device)
    rows = torch.repeat_interleave(torch.arange(r1 - r0, device=device),
                                   counts)
    cols = torch.from_numpy(np.asarray(m.indices[s:e], np.int64) - lo).to(
        device)
    vals = (torch.ones(e - s, dtype=dtype, device=device) if values is None
            else torch.from_numpy(np.asarray(values[s:e])).to(
                device=device, dtype=dtype))
    out = torch.zeros((r1 - r0, hi - lo), dtype=dtype, device=device)
    out.index_put_((rows, cols), vals, accumulate=True)
    return out


def judge(a, b, programs, device) -> dict:
    """``{"each": [the compared numbers of each of programs], "nnz_c": the
    nonzeros of C}`` for ``programs``, results of a.b (a = H, b =
    W2stack)."""
    dev = torch.device(device)
    m, n = a.shape[0], b.shape[1]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        each = [{"max_rel_err": 0.0, "stray_entries": 0,
                 "missing_entries": 0} for _ in programs]
        nnz_c = 0
        step = max(1, _BLOCK_ELEMENTS // max(n, 1))
        for g0, g1, lo, hi in groups(a):
            if hi > lo:
                w_val = _window(b, lo, hi, 0, n, b.data, torch.float64, dev)
                w_abs = w_val.abs()
                w_pat = _window(b, lo, hi, 0, n, None, torch.float32, dev)
            for r0 in range(g0, g1, step):
                r1 = min(g1, r0 + step)
                if hi > lo:
                    h_val = _window(a, r0, r1, lo, hi, a.data, torch.float64,
                                    dev)
                    ref = h_val @ w_val
                    den = h_val.abs() @ w_abs
                    del h_val
                    pat = (_window(a, r0, r1, lo, hi, None, torch.float32,
                                   dev) @ w_pat) > 0
                else:
                    ref = den = torch.zeros((r1 - r0, n), dtype=torch.float64,
                                            device=dev)
                    pat = torch.zeros((r1 - r0, n), dtype=torch.bool,
                                      device=dev)
                nnz_c += int(pat.sum())
                for program, worst in zip(programs, each):
                    vals, count = _program_rows(program, (m, n), r0, r1, pat,
                                                dev)
                    diff = (vals - ref).abs()
                    err = torch.where(
                        den > 0, diff / den.clamp_min(1e-300),
                        torch.where(diff > 0, float("inf"), 0.0))
                    err = torch.where(pat, err, 0.0)
                    worst["max_rel_err"] = max(worst["max_rel_err"],
                                               float(err.max()) if err.numel()
                                               else 0.0)
                    worst["stray_entries"] += int(
                        count.masked_select(~pat).sum()
                        + (count - 1).clamp_min(0).masked_select(pat).sum())
                    worst["missing_entries"] += int(
                        (pat & (count == 0)).sum())
                    del vals, count, diff, err
                del ref, den, pat
        return {"each": each, "nnz_c": nnz_c}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
