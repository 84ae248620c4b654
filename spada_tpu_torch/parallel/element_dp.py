"""Distributed element-granular SpGEMM: dp row partition, on torch.distributed.

The port of :mod:`spada_tpu.parallel.element_dp`.  ``ElementDpProblem``,
:func:`partition_element` and ``ElementDpResult`` are copies of the
reference's, held equal to it by ``tests/test_torch_host.py``: each rank
owns a row slab of A and of C, balanced by expansion size E, and its own ESC
plan, whose operands were gathered on the host, so the multiply needs no
communication at all.

Per rank (:func:`element_rank`) the slab's classes run in one
``esc_stream_group`` launch through the port's stream layout and
``stream_execute`` (``backend='pallas'`` or ``'auto'``), or through the
plain tensor operations of ``esc_execute`` (``'xla'``).  The multiply
issues no collective; :func:`spgemm_element_dp` gathers the chunk values to
every rank with one ``all_gather_into_tensor``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import numpy as np
import torch

from spada_tpu_torch.convert import c_tiles_to_numpy, check_device
from spada_tpu_torch.parallel.mesh import gather, resolve_mesh
from spada_tpu_torch.sparse.csr import CsrMatrix


@dataclasses.dataclass
class ElementDpProblem:
    """Host-planned dp decomposition of an element-path SpGEMM."""

    shape: Tuple[int, int]
    n_dev: int
    row_bounds: List[int]              # [n_dev + 1] row slab boundaries
    plans: list                        # per-shard EscPlan
    classes: Tuple[int, ...]           # sorted union of bucket classes L
    # per class: stacked operands [n_dev, n_max, L] and true chunk count
    # per shard [n_dev]
    a_stacked: List[np.ndarray]
    b_stacked: List[np.ndarray]
    n_chunks: List[np.ndarray]

    @property
    def e_per_shard(self) -> np.ndarray:
        return np.array([p.n_products for p in self.plans], np.int64)


def partition_element(a: CsrMatrix, b: CsrMatrix, n_dev: int,
                      cap: int = 512,
                      dtype=np.float32) -> ElementDpProblem:
    """Balance row slabs by expansion size E and plan each shard locally."""
    from spada_tpu_torch.ops.element import (build_esc_plan, esc_operands,
                                       expansion_products)

    blen = np.diff(b.indptr).astype(np.int64)
    fan = blen[a.indices]
    cs = np.concatenate([[0], np.cumsum(fan)])
    row_e = cs[a.indptr[1:]] - cs[a.indptr[:-1]]
    total = int(row_e.sum())
    # greedy balanced split: cut where cumulative E passes k/n_dev of total;
    # matrices with fewer rows than devices leave trailing shards empty
    # (bounds may repeat — a zero-row slab plans to an empty bucket set)
    cum = np.cumsum(row_e)
    m = a.shape[0]
    bounds = [0]
    for k in range(1, n_dev):
        r = int(np.searchsorted(cum, total * k / n_dev))
        bounds.append(min(max(r, bounds[-1] + 1), m))
    bounds.append(m)

    from spada_tpu_torch.ops.element import _slice_rows

    plans, opss = [], []
    for s, t in zip(bounds[:-1], bounds[1:]):
        sub = _slice_rows(a, s, t)
        plan = build_esc_plan(sub, b, cap=cap)
        plans.append(plan)
        opss.append(esc_operands(plan, sub, b, dtype=dtype))

    classes = tuple(sorted({bk.L for p in plans for bk in p.buckets}))
    a_stacked, b_stacked, n_chunks = [], [], []
    for L in classes:
        per = []
        for p, ops in zip(plans, opss):
            hit = [(bk, op) for bk, op in zip(p.buckets, ops) if bk.L == L]
            if hit:
                per.append(hit[0][1])
            else:
                per.append((np.zeros((0, L), dtype), np.zeros((0, L), dtype)))
        n_max = max(av.shape[0] for av, _ in per)
        n_max = max(n_max, 1)
        # L=1 stacks ship flat [n_dev, n_max] (see esc_operands: a trailing
        # [.,1] dim costs a device layout-copy pass to squeeze)
        shp = (n_dev, n_max) if L == 1 else (n_dev, n_max, L)
        av_st = np.zeros(shp, dtype)
        bv_st = np.zeros(shp, dtype)
        cnt = np.zeros(n_dev, np.int64)
        for d, (av, bv) in enumerate(per):
            av_st[d, : av.shape[0]] = av if av.ndim == len(shp) - 1 \
                else av[:, 0]
            bv_st[d, : bv.shape[0]] = bv if bv.ndim == len(shp) - 1 \
                else bv[:, 0]
            cnt[d] = av.shape[0]
        a_stacked.append(av_st)
        b_stacked.append(bv_st)
        n_chunks.append(cnt)
    return ElementDpProblem((a.shape[0], b.shape[1]), n_dev, bounds, plans,
                            classes, a_stacked, b_stacked, n_chunks)


@dataclasses.dataclass
class ElementDpResult:
    problem: ElementDpProblem
    values: list      # per class: [n_dev, n_max] chunk values (padded)

    def to_csr(self) -> CsrMatrix:
        """Assemble per-shard ESC chunk values into the global CSR."""
        p = self.problem
        csrs = []
        for d, plan in enumerate(p.plans):
            # re-interleave this shard's per-class chunk values back into
            # the plan's esc (bucket-concatenated) order
            parts = []
            for bk in plan.buckets:
                ci = p.classes.index(bk.L)
                nd = bk.a_gidx.shape[0]
                parts.append(np.asarray(self.values[ci][d][:nd]))
            vals = (np.concatenate(parts) if parts
                    else np.zeros(0, np.float32))
            data = np.zeros(plan.nnz_c, np.float64)
            np.add.at(data, plan.esc_to_csr, vals.astype(np.float64))
            csrs.append(CsrMatrix(plan.shape, plan.indptr, plan.indices,
                                  data.astype(np.float32)))
        from spada_tpu_torch.ops.element import concat_row_slabs

        return concat_row_slabs(p.shape, csrs)

    def todense(self) -> np.ndarray:
        return self.to_csr().todense()


def _class_widths(problem: ElementDpProblem) -> List[int]:
    """Each class's stacked width: its chunks on the busiest rank."""
    return [int(av.shape[1]) for av in problem.a_stacked]


def element_rank(problem: ElementDpProblem, rank: int, device,
                 backend: str = "auto") -> Callable[[], torch.Tensor]:
    """``rank``'s body: a call giving its chunk values as one flat f32
    tensor on ``device``, the classes of ``problem.classes`` one after
    another, each padded with zeros to its stacked width.  The operands are
    laid out and uploaded here, once; the call launches one
    ``esc_stream_group`` over the rank's classes (``'pallas'``, ``'auto'``)
    or runs ``esc_execute`` (``'xla'``).  No collective."""
    from spada_tpu_torch.ops.element import (esc_execute, esc_transfer,
                                             resolve_element_backend)
    from spada_tpu_torch.ops.element_stream import (build_stream_layout,
                                                    stream_execute)

    dev = check_device(device)
    backend = resolve_element_backend(backend)
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown element backend {backend!r}")
    p = problem
    plan = p.plans[rank]
    widths = _class_widths(p)
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
    # each of the plan's buckets: its slice of the flat output, and its
    # operands, read from the stacked arrays ([n] for L = 1, else [n, L])
    place, host = [], []
    for bk in plan.buckets:
        ci = p.classes.index(bk.L)
        n = bk.a_gidx.shape[0]
        place.append((int(offs[ci]), n))
        host.append((p.a_stacked[ci][rank][:n], p.b_stacked[ci][rank][:n]))
    total = int(offs[-1])

    if backend == "pallas":
        layout = build_stream_layout(plan)
        ops = []
        for c, (av, bv) in zip(layout.classes, host):
            ops.append(tuple(_stream_operand(c, x, dev) for x in (av, bv)))

        def run_classes():
            return stream_execute(layout, tuple(ops))
    else:
        ops = esc_transfer(host, dev)

        def run_classes():
            return esc_execute(ops)

    def body() -> torch.Tensor:
        out = torch.zeros(total, dtype=torch.float32, device=dev)
        for (off, n), v in zip(place, run_classes()):
            out[off:off + n] = v.reshape(-1)[:n]
        return out

    return body


def _stream_operand(c: dict, x: np.ndarray, dev) -> torch.Tensor:
    """One class's operand in the stream layout
    (``ops.element_stream.stream_operands``): L = 1 zero-padded to
    [rows, 1024], L >= 2 transposed and zero-padded to [L, n_pad]."""
    n, L = c["n"], c["L"]
    if L == 1:
        out = np.zeros(c["n_pad"], np.float32)
        out[:n] = x.reshape(-1)
        out = out.reshape(c["rows"], -1)
    else:
        out = np.zeros((L, c["n_pad"]), np.float32)
        out[:, :n] = x.T
    return torch.from_numpy(out).to(dev)


def spgemm_element_dp(problem: ElementDpProblem, mesh=None, device="cuda",
                      backend: str = "auto") -> ElementDpResult:
    """Execute, this process being one rank of the 1-D ``('dp',)`` mesh
    (None: that mesh over the default process group, of world size
    ``n_dev``); every rank returns the whole result.  The multiply is
    communication-free; one ``all_gather_into_tensor`` collects the chunk
    values."""
    p = problem
    dev = check_device(device)
    mesh = resolve_mesh(mesh, (p.n_dev,), ("dp",), dev, "spgemm_element_dp")
    (rank,) = mesh.get_coordinate()
    vals = c_tiles_to_numpy(gather(element_rank(p, rank, dev, backend)(),
                                   mesh))
    widths = _class_widths(p)
    cuts = np.cumsum(widths)[:-1]
    return ElementDpResult(p, list(np.split(vals, cuts, axis=1)))
