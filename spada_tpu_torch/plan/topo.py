"""Issued-block topology index.

Semantics of ``BlockTopoTracker`` (block_topo_tracker.rs:4-101): a two-level
sorted index over issued block anchors [col_s, row_s] supporting
nearest-neighbor queries ``find_left`` (nearest earlier column, scanning up
through rows) and ``find_above`` (nearest column in the previous row band).
The adaptive policies use it to locate the one-back and two-back neighbor
blocks whose measured costs drive the hill-climb.

Note on anchor convention: upstream anchors are ``[col_s, row_s]`` pairs
as produced by the scheduler (scheduler.rs:296-379); ``find_above`` walks the
*second* coordinate.  Here anchors are explicit ``(row, col)`` tuples to
avoid that trap.

Copy of :mod:`spada_tpu.plan.topo`
for spada_tpu_torch, held equal to it by ``tests/test_torch_host.py``; only
the imports differ.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


class BlockTopoTracker:
    def __init__(self):
        self._rows: List[int] = []            # sorted row anchors
        self._cols: List[List[int]] = []      # per row: sorted col anchors
        self._tokens: List[List[int]] = []

    def add_block(self, token: int, row: int, col: int) -> None:
        i = bisect.bisect_left(self._rows, row)
        if i < len(self._rows) and self._rows[i] == row:
            j = bisect.bisect_left(self._cols[i], col)
            self._cols[i].insert(j, col)
            self._tokens[i].insert(j, token)
        else:
            self._rows.insert(i, row)
            self._cols.insert(i, [col])
            self._tokens.insert(i, [token])

    def find_left(self, row: int, col: int) -> Optional[Tuple[int, int, int]]:
        """Nearest block strictly left of ``col``, scanning this row band then
        upward.  Returns (token, row, col) or None."""
        if not self._rows:
            return None
        i = bisect.bisect_left(self._rows, row)
        if i == len(self._rows) or self._rows[i] != row:
            i = min(len(self._rows) - 1, i)
        while i >= 0:
            j = bisect.bisect_left(self._cols[i], col) - 1
            if j >= 0:
                return (self._tokens[i][j], self._rows[i], self._cols[i][j])
            i -= 1
        return None

    def find_above(self, row: int, col: int) -> Optional[Tuple[int, int, int]]:
        """Nearest-column block in the previous row band. (token, row, col)."""
        if not self._rows:
            return None
        # bisect_left gives the band of `row` if present, else the insertion
        # point; either way the previous band is at i-1
        i = bisect.bisect_left(self._rows, row)
        if i == 0:
            return None
        i -= 1
        cols = self._cols[i]
        j = bisect.bisect_left(cols, col)
        if j == len(cols):
            j -= 1
        elif j > 0 and cols[j] != col:
            # pick the nearer of cols[j-1], cols[j]
            if cols[j] - col >= col - cols[j - 1]:
                j -= 1
        return (self._tokens[i][j], self._rows[i], cols[j])
