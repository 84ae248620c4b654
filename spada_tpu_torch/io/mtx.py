"""MatrixMarket (.mtx) reader.

Replaces the reference's embedded-Python scipy bridge (``load_mm_mat``,
py2rust.rs:62-97, which shells into ``scipy.io.mmread(...).tocsr()`` through
pyo3).  Here the parser is a first-class component: a NumPy fast path that
handles the coordinate format with real/integer/pattern fields and
general/symmetric/skew-symmetric symmetry, verified against ``scipy.io.mmread``
in tests.

Copy of :mod:`spada_tpu.io.mtx`
for spada_tpu_torch, held equal to it by ``tests/test_torch_host.py``; only
the imports differ.
"""

from __future__ import annotations

import io
import os

import numpy as np

from spada_tpu_torch.sparse.csr import CsrMatrix


def load_mtx(path: str) -> CsrMatrix:
    """Parse a MatrixMarket file into CSR."""
    with open(path, "rb") as f:
        header = f.readline().decode().strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket":
            raise ValueError(f"{path}: not a MatrixMarket file")
        _, obj, fmt, field, symmetry = header[:5]
        if obj != "matrix":
            raise ValueError(f"{path}: unsupported object {obj}")
        # skip comments, find the size line
        while True:
            pos = f.tell()
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: truncated header")
            s = line.decode().strip()
            if s and not s.startswith("%"):
                break
        size_parts = s.split()
        if fmt == "coordinate":
            nrows, ncols, nnz = (int(x) for x in size_parts[:3])
            body = f.read()
            return _parse_coordinate(body, nrows, ncols, nnz, field, symmetry)
        elif fmt == "array":
            nrows, ncols = (int(x) for x in size_parts[:2])
            vals = _tokens_to_floats(f.read())
            dense = vals.reshape((ncols, nrows)).T  # column-major per spec
            if symmetry == "symmetric":
                dense = np.tril(dense) + np.tril(dense, -1).T
            return CsrMatrix.from_dense(dense)
        else:
            raise ValueError(f"{path}: unsupported format {fmt}")


def _tokens_to_floats(body: bytes) -> np.ndarray:
    """Whitespace-token text -> float64 array (np.fromstring is gone in np2)."""
    return np.array(body.split(), dtype=np.float64)


def _parse_coordinate(body: bytes, nrows: int, ncols: int, nnz: int,
                      field: str, symmetry: str) -> CsrMatrix:
    if field == "pattern":
        cols_per_entry = 2
    elif field in ("real", "integer", "double"):
        cols_per_entry = 3
    elif field == "complex":
        cols_per_entry = 4
    else:
        raise ValueError(f"unsupported field {field}")

    # native single-pass tokenizer (spada_tpu.native); falls through to the
    # NumPy path on any failure
    if field != "complex":
        from spada_tpu_torch import native

        parsed = native.mtx_parse_body(body, nnz, field == "pattern")
        if parsed is not None:
            rows, cols, vals = parsed
            return _assemble_coo(rows, cols, vals, nrows, ncols, field,
                                 symmetry)

    flat = _tokens_to_floats(body)
    if flat.size != nnz * cols_per_entry:
        # tolerate trailing garbage / ragged whitespace via slower loadtxt
        arr = np.loadtxt(io.BytesIO(body), ndmin=2)
        if arr.size == 0:
            arr = arr.reshape(0, cols_per_entry)
        flat = arr[:nnz].ravel()
    table = flat.reshape(nnz, cols_per_entry) if nnz else np.zeros((0, cols_per_entry))

    rows = table[:, 0].astype(np.int64) - 1
    cols = table[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.ones(nnz, dtype=np.float64)
    elif field == "complex":
        vals = table[:, 2]  # real part only (matches scipy .real usage upstream)
    else:
        vals = table[:, 2]
    return _assemble_coo(rows, cols, vals, nrows, ncols, field, symmetry)


def _assemble_coo(rows, cols, vals, nrows: int, ncols: int, field: str,
                  symmetry: str) -> CsrMatrix:
    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = rows != cols
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        rows_sym = np.concatenate([rows, cols[off]])
        cols_sym = np.concatenate([cols, rows[off]])
        vals = np.concatenate([vals, sign * vals[off]])
        rows, cols = rows_sym, cols_sym
    elif symmetry != "general":
        raise ValueError(f"unsupported symmetry {symmetry}")

    return CsrMatrix.from_coo((nrows, ncols), rows, cols, vals)


def load_mtx_scipy(path: str) -> CsrMatrix:
    """scipy fallback/oracle (exactly what the reference's bridge called)."""
    import scipy.io

    return CsrMatrix.from_scipy(scipy.io.mmread(path).tocsr())


def save_mtx(m: CsrMatrix, path: str, comment: str = "") -> None:
    """Write MatrixMarket coordinate/real/general (the reference's input
    format, py2rust.rs:62-97) — lets generated workloads ship as committed
    .mtx files loadable by name through the CLI's SS category."""
    coo = m.to_scipy().tocoo()
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{m.shape[0]} {m.shape[1]} {len(coo.data)}\n")
        for r, c, v in zip(coo.row, coo.col, coo.data):
            f.write(f"{r + 1} {c + 1} {v:.17g}\n")


def resolve_workload_path(ss_filepath: str, name: str) -> str:
    """``<ss_filepath>/<name>.mtx`` with tolerance for a full path as name."""
    if os.path.exists(name):
        return name
    cand = os.path.join(ss_filepath, f"{name}.mtx")
    if os.path.exists(cand):
        return cand
    cand2 = os.path.join(ss_filepath, name, f"{name}.mtx")
    if os.path.exists(cand2):
        return cand2
    raise FileNotFoundError(f"workload {name!r} not found under {ss_filepath}")
