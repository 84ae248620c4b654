"""The benchmark's own CSR container and seeded random streams.

Generators and references use these and nothing of the port, so that the
inputs and the judgement of a run never depend on the code under test.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass
class Csr:
    """A CSR matrix: ``indptr`` int64 [rows + 1], ``indices`` int32 [nnz]
    (sorted within each row, no duplicates), ``data`` float32 [nnz]."""

    shape: tuple
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @property
    def nnz(self) -> int:
        return int(self.indptr[-1])

    def same_structure(self, other: "Csr") -> bool:
        return (self.shape == other.shape
                and np.array_equal(self.indptr, other.indptr)
                and np.array_equal(self.indices, other.indices))


def stream(seed: int, tag: str) -> np.random.Generator:
    """An independent random stream for ``tag`` under the run's ``seed``
    (any whole number; seeds beyond 64 bits wrap)."""
    return np.random.default_rng(
        np.random.SeedSequence([seed & (2**64 - 1), zlib.crc32(tag.encode())]))


def from_sorted_coo(shape, rows: np.ndarray, cols: np.ndarray,
                    data: np.ndarray) -> Csr:
    """CSR of coordinates already sorted by (row, column), without
    duplicates."""
    counts = np.bincount(rows, minlength=shape[0]).astype(np.int64)
    indptr = np.concatenate(([0], np.cumsum(counts)))
    return Csr((int(shape[0]), int(shape[1])), indptr,
               cols.astype(np.int32), data.astype(np.float32))
