"""Element-granular (ESC) SpGEMM path for scattered structure: the host plan,
the fused-elementwise executor and the one-call entry point.

The host half is a mirror of :mod:`spada_tpu.ops.element`
(``EscBucket``/``EscPlan``/``build_esc_plan``/``expansion_products``,
``esc_operands``, the row-slab helpers ``_row_slab_bounds``/``_slice_rows``/
``concat_row_slabs`` and ``EscSlabbedResult``), kept array-for-array equal to
it by ``tests/test_torch_element.py``.  The C++ planner is the port's copy,
:func:`spada_tpu_torch.native.esc_plan`.  :func:`esc_execute` is the port of
the reference's jitted ``'xla'`` executor: plain tensor operations, as that
one is plain XLA outside any Pallas kernel.

The host expands every scalar product a[i,k]*b[k,j], sorts the products by
output element and buckets the output chunks by product count L (a power
of two up to ``cap``; longer segments split into cap-wide chunks whose
partial sums share one CSR position).  The device then needs no indexed
operation at all: per class it multiplies two operand streams and sums
fixed-width groups (:mod:`spada_tpu_torch.ops.element_stream`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from spada_tpu_torch.sparse.csr import CsrMatrix
from spada_tpu_torch.utils import trace


@dataclasses.dataclass
class EscBucket:
    """Operand gather maps for all output chunks of one length class."""

    L: int                  # padded product count per output chunk
    a_gidx: np.ndarray      # [n, L] int32 into a.data (sentinel nnzA = 0.0)
    b_gidx: np.ndarray      # [n, L] int32 into b.data


@dataclasses.dataclass
class EscPlan:
    """Host-side symbolic phase result: C structure + operand layout maps."""

    shape: Tuple[int, int]
    indptr: np.ndarray          # [m+1] int64 — CSR structure of C
    indices: np.ndarray         # [nnzC] int32
    esc_to_csr: np.ndarray      # [n_chunks] int32: CSR position per chunk
    buckets: List[EscBucket]
    n_products: int             # exact scalar multiply count (E)
    n_padded: int               # padded product slots actually streamed

    @property
    def nnz_c(self) -> int:
        return int(len(self.indices))

    def operand_bytes(self, itemsize: int = 4, out_itemsize: int = 4) -> int:
        """Device bytes one execution streams (operands + output)."""
        return (2 * self.n_padded * itemsize
                + len(self.esc_to_csr) * out_itemsize)


def _ceil_pow2(x: np.ndarray) -> np.ndarray:
    """Elementwise next power of two (>=1) for positive ints."""
    x = np.maximum(x.astype(np.int64), 1)
    return (1 << np.ceil(np.log2(x)).astype(np.int64)).astype(np.int64)


def expansion_products(a: CsrMatrix, b: CsrMatrix) -> int:
    """Closed-form E = Σ_k nnz(A[:,k]) · nnz(B[k,:]) (cheap, pre-plan)."""
    acol = np.bincount(a.indices, minlength=a.shape[1]).astype(np.int64)
    return int(np.dot(acol, np.diff(b.indptr).astype(np.int64)))


@trace.spanned("layout.structure")
def build_esc_plan(a: CsrMatrix, b: CsrMatrix, cap: int = 512,
                   backend: str = "auto") -> EscPlan:
    """Symbolic phase: expand, sort (host), and bucket the product schedule.

    ``backend``: 'auto' prefers the C++ planner
    (``spada_tpu_torch.native``) and falls back to NumPy where it cannot
    build or does not apply; 'python' forces the NumPy implementation.
    """
    if backend not in ("auto", "python"):
        raise ValueError(f"unknown ESC plan backend {backend!r}")
    if backend == "auto":
        plan = _build_esc_plan_native(a, b, cap)
        if plan is not None:
            return plan
    return _build_esc_plan_numpy(a, b, cap)


def _build_esc_plan_native(a: CsrMatrix, b: CsrMatrix,
                           cap: int) -> Optional[EscPlan]:
    from spada_tpu_torch import native

    m, n_cols = a.shape[0], b.shape[1]
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    E = expansion_products(a, b)
    if E == 0 or E >= 2**31 or cap & (cap - 1):
        return None
    out = native.esc_plan(a.indptr, a.indices, b.indptr, b.indices,
                          b.shape[0], cap, E)
    if out is None:
        return None
    counts, c_indices, c_row_counts, class_L, class_n, esc_to_csr, ag, bg = out
    nnz_c, total_chunks, n_padded, n_classes = (int(counts[0]),
                                                int(counts[1]),
                                                int(counts[2]),
                                                int(counts[3]))
    indptr = np.zeros(m + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(c_row_counts[:m].astype(np.int64))
    buckets: List[EscBucket] = []
    base = 0
    for i in range(n_classes):
        L, n = int(class_L[i]), int(class_n[i])
        buckets.append(EscBucket(
            L,
            ag[base : base + n * L].reshape(n, L),
            bg[base : base + n * L].reshape(n, L),
        ))
        base += n * L
    return EscPlan((m, n_cols), indptr, c_indices[:nnz_c].copy(),
                   esc_to_csr[:total_chunks].copy(), buckets,
                   n_products=E, n_padded=n_padded)


def _build_esc_plan_numpy(a: CsrMatrix, b: CsrMatrix, cap: int) -> EscPlan:
    m, n_cols = a.shape[0], b.shape[1]
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    nnz_a, nnz_b = a.nnz, b.nnz
    b_lens = np.diff(b.indptr)
    fan = b_lens[a.indices]                       # products per A nonzero
    E = int(fan.sum())
    if E >= 2**31:
        # int32 gather indices overflow, and the host arrays here take ~20
        # bytes per product
        raise ValueError(
            f"ESC plan expansion E={E} exceeds the single-plan range "
            f"(2^31 products); slab the rows of A")
    if E == 0:
        return EscPlan((m, n_cols), np.zeros(m + 1, np.int64),
                       np.zeros(0, np.int32), np.zeros(0, np.int32), [], 0, 0)
    # float64 keys are exact below 2^53 and avoid slow int64 multiplies
    if float(m) * n_cols >= 2**53:
        raise ValueError("matrix too large for exact float64 merge keys")

    # --- expansion (the scheduler's window expansion, flattened) ---
    a_eidx = np.repeat(np.arange(nnz_a, dtype=np.int32), fan)
    ofs = np.cumsum(fan) - fan                    # int64 [nnzA]
    base = b.indptr[a.indices] - ofs              # int64 [nnzA]
    b_eidx = (np.repeat(base, fan)
              + np.arange(E, dtype=np.int64)).astype(np.int32)
    del base, ofs
    a_rows = np.repeat(
        np.arange(m, dtype=np.float64), np.diff(a.indptr)
    )[a_eidx]
    key = a_rows * float(n_cols) + b.indices[b_eidx]
    del a_rows

    # --- plan-time merge: sort products by output element ---
    perm = np.argsort(key, kind="stable")
    ks = key[perm]
    del key
    a_eidx, b_eidx = a_eidx[perm], b_eidx[perm]
    del perm
    newseg = np.empty(E, dtype=bool)
    newseg[0] = True
    np.not_equal(ks[1:], ks[:-1], out=newseg[1:])
    seg_starts = np.nonzero(newseg)[0]
    nnz_c = len(seg_starts)
    seg_len = np.diff(np.append(seg_starts, E))
    c_keys = ks[seg_starts]
    del ks, newseg
    c_rows = np.floor(c_keys / n_cols)
    indices = (c_keys - c_rows * n_cols).astype(np.int32)
    indptr = np.zeros(m + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(
        c_rows.astype(np.int64), minlength=m
    ))

    # --- split oversized segments into cap-wide chunks ---
    if cap & (cap - 1):
        raise ValueError("cap must be a power of two")
    log_cap = cap.bit_length() - 1
    n_chunks_per_seg = (seg_len + cap - 1) >> log_cap
    total_chunks = int(n_chunks_per_seg.sum())
    chunk_seg = np.repeat(
        np.arange(nnz_c, dtype=np.int64), n_chunks_per_seg
    )
    chunk_in_seg = (
        np.arange(total_chunks, dtype=np.int64)
        - np.repeat(np.cumsum(n_chunks_per_seg) - n_chunks_per_seg,
                    n_chunks_per_seg)
    )
    chunk_start = seg_starts[chunk_seg] + (chunk_in_seg << log_cap)
    chunk_len = np.minimum(
        seg_len[chunk_seg] - (chunk_in_seg << log_cap), cap
    )
    del chunk_in_seg, n_chunks_per_seg, seg_starts, seg_len

    # --- bucket chunks by power-of-two length class ---
    cls = _ceil_pow2(chunk_len)
    buckets: List[EscBucket] = []
    esc_parts: List[np.ndarray] = []
    n_padded = 0
    for L in np.unique(cls):
        L = int(L)
        mem = np.nonzero(cls == L)[0]
        starts_L = chunk_start[mem]
        lens_L = chunk_len[mem]
        lane = np.arange(L, dtype=np.int64)
        idx2 = starts_L[:, None] + lane[None, :]
        valid = lane[None, :] < lens_L[:, None]
        np.minimum(idx2, E - 1, out=idx2)
        ag = np.where(valid, a_eidx[idx2], nnz_a).astype(np.int32)
        bg = np.where(valid, b_eidx[idx2], nnz_b).astype(np.int32)
        del idx2, valid
        buckets.append(EscBucket(L, ag, bg))
        esc_parts.append(chunk_seg[mem].astype(np.int32))
        n_padded += len(mem) * L

    esc_to_csr = (np.concatenate(esc_parts) if esc_parts
                  else np.zeros(0, np.int32))
    return EscPlan((m, n_cols), indptr, indices, esc_to_csr, buckets,
                   n_products=E, n_padded=n_padded)


def esc_operands(plan: EscPlan, a: CsrMatrix, b: CsrMatrix,
                 dtype=np.float32) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Numeric layout: gather operand values into the plan's buckets.

    This is the per-value-refresh half: a pure host gather by the fixed
    plan indices (the analog of re-filling the fiber cache for new data).
    """
    a_ext = np.append(a.data, 0.0).astype(dtype)
    b_ext = np.append(b.data, 0.0).astype(dtype)
    # the L=1 class ships FLAT [n] (not [n,1]): its chunk values are the
    # products themselves, and an [n,1]->[n] reshape on the device would be
    # one more pass over the class
    return [(a_ext[bk.a_gidx[:, 0]], b_ext[bk.b_gidx[:, 0]]) if bk.L == 1
            else (a_ext[bk.a_gidx], b_ext[bk.b_gidx])
            for bk in plan.buckets]


def _to_tensor(x: np.ndarray, dev):
    import torch

    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":   # ml_dtypes: torch.from_numpy has none
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(x).to(dev)


def esc_transfer(operands, device) -> tuple:
    """Move operand buckets to ``device`` (once per value set)."""
    from spada_tpu_torch.convert import check_device

    dev = check_device(device)
    return tuple((_to_tensor(av, dev), _to_tensor(bv, dev))
                 for av, bv in operands)


def esc_execute(operands, out_dtype=None) -> tuple:
    """Device numeric phase of the ``'xla'`` backend: products and
    fixed-width merges as plain tensor operations, no indexed operation.

    ``operands``: per-class tensor pairs from :func:`esc_transfer`, flat
    ``[n]`` for L = 1 and ``[n, L]`` otherwise.  Products and sums are f32;
    ``out_dtype`` (f32 by default, or ``torch.bfloat16``) narrows the store
    of the chunk values.  Returns a tuple of per-class tensors in esc
    (bucket) order, not one concatenated tensor: a device concatenate would
    stream the whole output once more.
    """
    import torch

    out_dtype = out_dtype or torch.float32
    outs = []
    for av, bv in operands:
        prod = (av * bv).to(torch.float32)
        if prod.dim() == 1:
            outs.append(prod.to(out_dtype))
        elif prod.shape[1] == 1:
            outs.append(prod.reshape(-1).to(out_dtype))
        else:
            outs.append(prod.sum(dim=1).to(out_dtype))
    return tuple(outs)


def esc_values_host(values) -> np.ndarray:
    """Flatten per-class device chunk values to one host f32 array in esc
    (bucket-concatenated) order."""
    from spada_tpu_torch.convert import c_tiles_to_numpy

    parts = [c_tiles_to_numpy(v) for v in values]
    return (np.concatenate(parts) if parts else np.zeros(0, np.float32))


@dataclasses.dataclass
class EscResult:
    """Element-path result: C structure (host) + chunk values (device)."""

    plan: EscPlan
    values: object    # tuple of per-class tensors, esc (bucket) order
    elapsed_s: Optional[float] = None

    def to_csr(self) -> CsrMatrix:
        data = np.zeros(self.plan.nnz_c, np.float64)
        # oversized segments contributed several partial chunks at the same
        # CSR position; add-at combines them (the final psum merge)
        np.add.at(data, self.plan.esc_to_csr,
                  esc_values_host(self.values).astype(np.float64))
        return CsrMatrix(self.plan.shape, self.plan.indptr,
                         self.plan.indices, data.astype(np.float32))

    def todense(self) -> np.ndarray:
        return self.to_csr().todense()


@dataclasses.dataclass
class EscSlabbedResult:
    """Row-slab-streamed element result (nnz(C) and E beyond one plan).

    Rows are split so each slab's expansion fits the planner range and the
    host/device operand memory budget; slabs plan+execute independently
    (the ESC plan is per-row separable) and concatenate exactly.  ``parts``
    are ``EscResult`` or ``StreamResult`` objects, by the backend.
    """

    shape: Tuple[int, int]
    parts: list
    elapsed_s: float

    @property
    def n_products(self) -> int:
        return sum(p.plan.n_products for p in self.parts)

    @property
    def n_padded(self) -> int:
        return sum(p.plan.n_padded for p in self.parts)

    @property
    def nnz_c(self) -> int:
        return sum(p.plan.nnz_c for p in self.parts)

    @property
    def n_chunks(self) -> int:
        return sum(len(p.plan.esc_to_csr) for p in self.parts)

    def operand_bytes(self, itemsize: int = 4, out_itemsize: int = 4) -> int:
        return sum(p.plan.operand_bytes(itemsize, out_itemsize)
                   for p in self.parts)

    def to_csr(self) -> CsrMatrix:
        return concat_row_slabs(self.shape,
                                [p.to_csr() for p in self.parts])

    def todense(self) -> np.ndarray:
        return self.to_csr().todense()


def concat_row_slabs(shape, csrs) -> CsrMatrix:
    """Stack row-slab CSRs vertically into one matrix (exact: slabs
    partition the row space)."""
    if not csrs:
        return CsrMatrix(shape, np.zeros(shape[0] + 1, np.int64), [], [])
    offs = np.cumsum([0] + [c.nnz for c in csrs])[:-1]
    indptr = np.concatenate(
        [[0]] + [c.indptr[1:] + off for c, off in zip(csrs, offs)]
    ).astype(np.int64)
    return CsrMatrix(
        shape, indptr,
        np.concatenate([c.indices for c in csrs]),
        np.concatenate([c.data for c in csrs]),
    )


def _slice_rows(m: CsrMatrix, s: int, t: int) -> CsrMatrix:
    lo, hi = int(m.indptr[s]), int(m.indptr[t])
    return CsrMatrix((t - s, m.shape[1]), m.indptr[s : t + 1] - lo,
                     m.indices[lo:hi], m.data[lo:hi])


def _row_slab_bounds(a: CsrMatrix, b: CsrMatrix, max_products: int):
    """Row boundaries such that each slab's expansion <= max_products
    (a single row over the limit gets its own slab — its plan must still
    fit the 2^31 range or the planner raises loudly).  Vectorized: repeated
    searchsorted on the cumulative expansion instead of a per-row Python
    loop (the path only triggers for huge matrices)."""
    blen = np.diff(b.indptr).astype(np.int64)
    fan = blen[a.indices]
    cs = np.concatenate([[0], np.cumsum(fan)])
    row_e_cum = cs[a.indptr]          # [m+1] cumulative E at row starts
    bounds = [0]
    m = a.shape[0]
    while bounds[-1] < m:
        start = bounds[-1]
        # furthest row end whose slab expansion stays under the budget
        r = int(np.searchsorted(row_e_cum, row_e_cum[start] + max_products,
                                side="right")) - 1
        bounds.append(max(min(r, m), start + 1))
    return bounds


def resolve_element_backend(backend: str) -> str:
    """'auto' -> 'pallas': in this package both names mean the hand-written
    stream kernels of ``csrc/esc_stream.cu`` (measured faster than the
    fused elementwise passes on an H100, ``PERF.md``).  Unlike the
    reference, 'auto' does not look at the machine: an entry point runs on
    the device it is given, and a machine without a card gets an error from
    that device, not another executor."""
    return "pallas" if backend == "auto" else backend


def spgemm_element(a: CsrMatrix, b: CsrMatrix, device, cap: int = 512,
                   plan: Optional[EscPlan] = None, dtype=np.float32,
                   max_slab_products: int = 2**28, backend: str = "auto"):
    """One-call element-granular SpGEMM on ``device`` (plan + operands +
    execute).

    ``elapsed_s`` times the second, warm execution only (planning and the
    host-to-device transfer are a one-time format cost, like shipping BSR
    tiles).  Expansions larger than ``max_slab_products`` (default 2^28,
    about 2.1 GB of f32 operands) stream through row slabs and return an
    :class:`EscSlabbedResult`; a given ``plan`` is used as it is, without
    the slab split.  ``backend`` picks the numeric executor: 'auto' and
    'pallas' the hand-written stream kernels
    (:mod:`spada_tpu_torch.ops.element_stream`, one grouped launch; returns
    a ``StreamResult``), 'xla' the fused elementwise operations of
    :func:`esc_execute` (returns an :class:`EscResult`).  ``dtype`` is the
    operands' type: the stream kernels take float32 only.
    """
    from spada_tpu_torch.convert import (check_device,
                                         stream_operands_to_torch,
                                         synchronize)

    dev = check_device(device)
    backend = resolve_element_backend(backend)
    if backend not in ("pallas", "xla"):
        raise ValueError(f"unknown element backend {backend!r}")
    if backend == "pallas" and np.dtype(dtype) != np.float32:
        raise TypeError(
            f"element backend 'pallas': the stream kernels take float32 "
            f"operands, got dtype {np.dtype(dtype).name}; use backend='xla'")
    if (plan is None and a.shape[0] > 1
            and expansion_products(a, b) > max_slab_products):
        bounds = _row_slab_bounds(a, b, max_slab_products)
        parts = []
        elapsed = 0.0
        for s, t in zip(bounds[:-1], bounds[1:]):
            part = spgemm_element(_slice_rows(a, s, t), b, dev, cap=cap,
                                  dtype=dtype,
                                  max_slab_products=max_slab_products,
                                  backend=backend)
            parts.append(part)
            elapsed += part.elapsed_s or 0.0
        return EscSlabbedResult((a.shape[0], b.shape[1]), parts, elapsed)
    plan = plan or build_esc_plan(a, b, cap=cap)

    if backend == "pallas":
        from spada_tpu_torch.ops.element_stream import (StreamResult,
                                                        build_stream_layout,
                                                        stream_execute,
                                                        stream_operands)

        layout = build_stream_layout(plan)
        ops = stream_operands_to_torch(stream_operands(layout, plan, a, b),
                                       dev)

        def run():
            return stream_execute(layout, ops)
    else:
        ops = esc_transfer(esc_operands(plan, a, b, dtype=dtype), dev)

        def run():
            return esc_execute(ops)

    run()  # warm: the first use builds and loads the kernels
    synchronize(dev)
    t0 = time.perf_counter()
    vals = run()
    synchronize(dev)
    elapsed = time.perf_counter() - t0
    if backend == "pallas":
        return StreamResult(plan, layout, vals, elapsed_s=elapsed)
    return EscResult(plan, vals, elapsed_s=elapsed)
