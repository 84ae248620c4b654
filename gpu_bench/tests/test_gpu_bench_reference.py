"""The plain reference and its judgement against scipy at a tiny size."""

import numpy as np
import pytest
import scipy.sparse as sp

from gpu_bench.cells import load_part
from gpu_bench.csr import Csr

ref = load_part("references", "spgemm_f64")


def _pair(seed):
    rng = np.random.default_rng(seed)
    a = sp.random(40, 60, density=0.1, random_state=rng, format="csr",
                  dtype=np.float32)
    b = sp.random(60, 50, density=0.1, random_state=rng, format="csr",
                  dtype=np.float32)
    a.data -= 0.5

    def mine(m):
        m.sort_indices()
        return Csr(m.shape, m.indptr.astype(np.int64),
                   m.indices.astype(np.int32), m.data.astype(np.float32))

    return mine(a), mine(b), (a.astype(np.float64) @ b.astype(np.float64))


def _as_csr(c):
    c = c.tocsr()
    c.sort_indices()
    return "csr", (c.indptr.astype(np.int64), c.indices, c.data)


@pytest.mark.parametrize("seed", range(3))
def test_scipys_product_is_judged_exact(seed):
    a, b, c = _pair(seed)
    pattern = (abs(sp.csr_matrix((np.ones(a.nnz), a.indices, a.indptr),
                                 a.shape))
               @ sp.csr_matrix((np.ones(b.nnz), b.indices, b.indptr),
                               b.shape))
    got = ref.judge(a, b, [_as_csr(c), ("dense", c.toarray())], "cpu")
    assert got["nnz_c"] == pattern.nnz
    for each in got["each"]:
        assert each["max_rel_err"] < 1e-12
        assert each["stray_entries"] == 0
        assert each["missing_entries"] == 0


def test_faults_are_judged():
    a, b, c = _pair(4)
    c = c.tocsr()
    c.sort_indices()
    altered = c.copy()
    altered.data[3] *= 1.01
    missing = c.copy()
    missing.data[5] = 0
    missing.eliminate_zeros()
    stray = c.tolil()
    r, col = next((i, j) for i in range(c.shape[0]) for j in range(c.shape[1])
                  if c[i, j] == 0)
    stray[r, col] = 1.0
    rounded = c.copy()
    rounded.data = rounded.data.astype(np.float32).astype(np.float64) * (
        1 + 2.0**-9)
    got = ref.judge(a, b, [_as_csr(altered), _as_csr(missing),
                           _as_csr(stray.tocsr()),
                           ("dense", rounded.toarray())], "cpu")["each"]
    assert got[0]["max_rel_err"] > 1e-3
    assert got[1]["missing_entries"] == 1 and got[1]["max_rel_err"] > 0.1
    assert got[2]["stray_entries"] == 1
    assert got[3]["max_rel_err"] > 1e-3
