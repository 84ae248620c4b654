"""Plain reference of a sparse product C = A.B, and the judgement of the
program's C against it.

The reference densifies A and B from the benchmark's own CSR inputs and
multiplies them in float64 with ``torch.matmul``, row block by row block, on
the device it is given; C's structure is the product of the two patterns.
It takes nothing that the program made.  Each product the program returned
is judged entry by entry:

- ``max_rel_err``: the largest |c - c_ref| / (|A|.|B|)_ij over C's
  structure, the error of each entry against the size of its own terms;
- ``stray_entries``: entries the program gives outside C's structure (and
  any entry it gives twice);
- ``missing_entries``: entries of C's structure that the program lacks.

A program's C is ``("csr", (indptr, indices, data))``, whose listed entries
are its structure, or ``("dense", array [m, n])``, which lists every entry:
there an entry outside C's structure is stray where it is not 0, and none is
missing (a C entry that the program left 0 reads as its value's error).
"""

from __future__ import annotations

import numpy as np
import torch

from gpu_bench.csr import Csr

#: elements of one row block's float64 temporaries
_BLOCK_ELEMENTS = 1 << 27


def _rows_dense(m, r0: int, r1: int, values, dtype, device) -> torch.Tensor:
    """Rows r0:r1 of CSR ``m`` (any object with ``shape``, ``indptr``,
    ``indices``) as a dense tensor with ``values`` (all ones if None)
    added at each listed entry."""
    indptr = np.asarray(m.indptr, np.int64)
    lo, hi = int(indptr[r0]), int(indptr[r1])
    counts = torch.from_numpy(np.diff(indptr[r0:r1 + 1])).to(device)
    rows = torch.repeat_interleave(
        torch.arange(r1 - r0, device=device), counts)
    cols = torch.from_numpy(
        np.asarray(m.indices[lo:hi], np.int64)).to(device)
    vals = (torch.ones(hi - lo, dtype=dtype, device=device) if values is None
            else torch.from_numpy(np.asarray(values[lo:hi], np.float64))
            .to(device=device, dtype=dtype))
    out = torch.zeros((r1 - r0, m.shape[1]), dtype=dtype, device=device)
    out.index_put_((rows, cols), vals, accumulate=True)
    return out


def _program_rows(program, shape, r0: int, r1: int, pattern, device):
    """(values f64, entries listed per position int32) of rows r0:r1 of a
    program's C; a dense C lists its nonzero entries outside C's structure
    and every entry inside it (``pattern``)."""
    kind, c = program
    if kind == "dense":
        vals = torch.from_numpy(np.asarray(c[r0:r1], np.float64)).to(device)
        return vals, ((vals != 0) | pattern).to(torch.int32)
    if kind != "csr":
        raise ValueError(f"unknown result kind {kind!r}")
    m = Csr(shape, *c)
    vals = _rows_dense(m, r0, r1, m.data, torch.float64, device)
    count = _rows_dense(m, r0, r1, None, torch.int32, device)
    return vals, count


def judge(a, b, programs, device) -> dict:
    """``{"each": [the compared numbers of each of programs], "nnz_c": the
    nonzeros of C}`` for ``programs``, results of a.b."""
    dev = torch.device(device)
    m, n = a.shape[0], b.shape[1]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        b_val = _rows_dense(b, 0, b.shape[0], b.data, torch.float64, dev)
        b_abs = b_val.abs()
        b_pat = _rows_dense(b, 0, b.shape[0], None, torch.float32, dev)
        each = [{"max_rel_err": 0.0, "stray_entries": 0,
                 "missing_entries": 0} for _ in programs]
        nnz_c = 0
        step = max(1, _BLOCK_ELEMENTS // max(n, b.shape[0]))
        for r0 in range(0, m, step):
            r1 = min(m, r0 + step)
            a_val = _rows_dense(a, r0, r1, a.data, torch.float64, dev)
            ref = a_val @ b_val
            den = a_val.abs() @ b_abs
            del a_val
            pat = (_rows_dense(a, r0, r1, None, torch.float32, dev)
                   @ b_pat) > 0
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
                worst["missing_entries"] += int((pat & (count == 0)).sum())
                del vals, count, diff, err
            del ref, den, pat
        return {"each": each, "nnz_c": nnz_c}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
