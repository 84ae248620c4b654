"""Element-granular (ESC) SpGEMM path for scattered structure: the host plan.

A mirror of the plan half of :mod:`spada_tpu.ops.element`
(``EscBucket``/``EscPlan``/``build_esc_plan``/``expansion_products``), kept
array-for-array equal to it by ``tests/test_torch_element.py``.  The C++
planner is the port's copy, :func:`spada_tpu_torch.native.esc_plan`.

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


def spgemm_element(a: CsrMatrix, b: CsrMatrix, device, cap: int = 512,
                   max_slab_products: int = 2**28):
    """One-call element-granular SpGEMM on ``device``: plan, stream layout,
    operand transfer, one launch per class.

    ``elapsed_s`` times the second, warm execution only (planning and the
    host-to-device transfer are a one-time format cost, like shipping BSR
    tiles).  Expansions above ``max_slab_products`` need the row-slab
    streaming of the JAX package, which is not ported yet.
    """
    from spada_tpu_torch.convert import (check_device,
                                         stream_operands_to_torch,
                                         synchronize)
    from spada_tpu_torch.ops.element_stream import (StreamResult,
                                                    build_stream_layout,
                                                    stream_execute,
                                                    stream_operands)

    dev = check_device(device)
    if a.shape[0] > 1 and expansion_products(a, b) > max_slab_products:
        raise NotImplementedError(
            f"element path: E > {max_slab_products} products needs row-slab "
            f"streaming, which spada_tpu_torch does not have yet")
    plan = build_esc_plan(a, b, cap=cap)
    layout = build_stream_layout(plan)
    ops = stream_operands_to_torch(stream_operands(layout, plan, a, b), dev)
    stream_execute(layout, ops)  # first use builds and loads the kernels
    synchronize(dev)
    t0 = time.perf_counter()
    vals = stream_execute(layout, ops)
    synchronize(dev)
    return StreamResult(plan, layout, vals,
                        elapsed_s=time.perf_counter() - t0)
