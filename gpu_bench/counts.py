"""The work of one product, counted from the cell's inputs, and the card's
peaks: the yardstick of ``spgemm_roofline`` and ``spgemm_gflop_s``.

Whatever implements the product (tile edge, panel heights, engine, the tile
or the element side), the same inputs count the same work here: the useful
multiply-adds, and the bytes of the inputs read once and of C written once in
CSR form (32-bit values, column indices and row pointers).
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet: dense float32 outside the tensor cores, and
#: HBM3 bandwidth.  Both assume the card's full 700 W power limit.
PEAK_F32_FLOP_S = 67e12
PEAK_HBM_BYTES_S = 3.35e12

_VALUE, _INDEX, _POINTER = 4, 4, 4


def useful_flop(a, b) -> int:
    """2 * sum_k nnz(A[:, k]) * nnz(B[k, :]): one multiply and one add per
    scalar product of C = A.B."""
    col = np.bincount(np.asarray(a.indices), minlength=a.shape[1])
    row = np.diff(np.asarray(b.indptr))
    return 2 * int(np.dot(col.astype(np.int64), row.astype(np.int64)))


def csr_bytes(rows: int, nnz: int) -> int:
    """Bytes of a CSR matrix of ``rows`` rows and ``nnz`` nonzeros."""
    return nnz * (_VALUE + _INDEX) + (rows + 1) * _POINTER


def product_bytes(a, b, nnz_c: int) -> int:
    """A and B read once (B not again where it is A), C written once."""
    read = csr_bytes(a.shape[0], a.nnz)
    if b is not a:
        read += csr_bytes(b.shape[0], b.nnz)
    return read + csr_bytes(a.shape[0], nnz_c)


def least_time(flop: int, nbytes: int) -> tuple:
    """(seconds, 'operations' | 'bytes'): the larger of the two bounds."""
    t_op, t_by = flop / PEAK_F32_FLOP_S, nbytes / PEAK_HBM_BYTES_S
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")
