"""Row-group segmentation.

Semantics of ``parse_group`` (rowwise_adjust.rs:38-79 /
rowwise_perf_adjust.rs:36-77): scan rows top-to-bottom; empty rows never open
or close a group; a new group starts at nonzero row *r* when its length jumps
by more than ``var_factor`` in either direction relative to the previous
nonzero row.  Groups are contiguous row ranges covering the whole matrix, and
carry the average row length (integer division, as upstream).

Here the scan is vectorized over the row-length array — the planner's whole
input is ``row_lens``, not a storage object.

Copy of :mod:`spada_tpu.plan.groups`
for spada_tpu_torch, held equal to it by ``tests/test_torch_host.py``; only
the imports differ.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class GroupInfo:
    row_range: tuple        # [start, end)
    avg_row_len: int
    # cost/latency feedback per candidate panel height: height -> [num, den]
    cost_num: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class GroupTracker:
    groups: List[GroupInfo]
    rgmap: np.ndarray       # int32 [n_rows] row -> group index

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def group_of(self, row: int) -> int:
        return int(self.rgmap[row])


def parse_group(row_lens: np.ndarray, var_factor: float) -> GroupTracker:
    row_lens = np.asarray(row_lens, dtype=np.int64)
    n = len(row_lens)
    if n == 0:
        return GroupTracker([], np.zeros(0, np.int32))

    nz = np.nonzero(row_lens)[0]
    boundaries = [0]
    if len(nz) > 1:
        prev = row_lens[nz[:-1]].astype(np.float64)
        cur = row_lens[nz[1:]].astype(np.float64)
        jump = (prev * var_factor < cur) | (prev > var_factor * cur)
        boundaries.extend(int(r) for r in nz[1:][jump])
    boundaries.append(n)

    cum = np.concatenate([[0], np.cumsum(row_lens)])
    groups = []
    rgmap = np.zeros(n, dtype=np.int32)
    for gi, (s, e) in enumerate(zip(boundaries[:-1], boundaries[1:])):
        total = int(cum[e] - cum[s])
        groups.append(GroupInfo((s, e), total // (e - s)))
        rgmap[s:e] = gi
    return GroupTracker(groups, rgmap)
