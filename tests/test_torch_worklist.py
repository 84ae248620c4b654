"""spada_tpu_torch.ops.worklist is a mirror of spada_tpu.ops.worklist: the two
must build the same worklist, array by array."""

import numpy as np
import pytest

from spada_tpu.io.workloads import (block_sparse_csr, localized_powerlaw_csr,
                                    random_csr)
from spada_tpu.ops.worklist import build_worklist as jax_build_worklist
from spada_tpu.sparse.bsr import BsrMatrix
from spada_tpu_torch.convert import from_reference as P
from spada_tpu_torch.ops.worklist import build_worklist

_FIELDS = ("a_tid", "b_tid", "o_tid", "first", "c_tile_row", "c_tile_col")


def _pairs(cari_workload):
    return {
        "cari": (cari_workload.a, cari_workload.b),
        "random": (random_csr(300, 260, 0.05, seed=11, dtype=np.float32),
                   random_csr(260, 340, 0.05, seed=12, dtype=np.float32)),
        "locpl": (localized_powerlaw_csr(512, 512, 10.0, seed=13,
                                         dtype=np.float32),
                  localized_powerlaw_csr(512, 512, 10.0, seed=14,
                                         dtype=np.float32)),
        "block": (block_sparse_csr(512, 512, 64, 0.3, seed=15),
                  block_sparse_csr(512, 384, 64, 0.4, seed=16)),
    }


@pytest.mark.parametrize("order", ["row", "k"])
@pytest.mark.parametrize("name", ["cari", "random", "locpl", "block"])
@pytest.mark.parametrize("tm,tk,tn", [(8, 128, 128), (64, 64, 128),
                                      (128, 256, 256)])
def test_worklist_matches_reference(cari_workload, name, order, tm, tk, tn):
    a, b = _pairs(cari_workload)[name]
    a_bsr = BsrMatrix.from_csr(a, tm, tk, dtype=np.float32)
    b_bsr = BsrMatrix.from_csr(b, tk, tn, dtype=np.float32)
    ref = jax_build_worklist(a_bsr, b_bsr, order=order)
    got = build_worklist(P(a_bsr), P(b_bsr), order=order)
    assert got.n_items == ref.n_items > 0
    assert got.n_c_tiles == ref.n_c_tiles
    assert got.order == ref.order
    for f in _FIELDS:
        g, r = getattr(got, f), getattr(ref, f)
        assert g.dtype == r.dtype, f
        np.testing.assert_array_equal(g, r, err_msg=f)


def test_worklist_empty_and_mismatch():
    z = random_csr(64, 64, 0.0, seed=1, dtype=np.float32)
    a_bsr = BsrMatrix.from_csr(z, 8, 64)
    b_bsr = BsrMatrix.from_csr(z, 64, 64)
    got = build_worklist(P(a_bsr), P(b_bsr))
    ref = jax_build_worklist(a_bsr, b_bsr)
    # an empty matrix still carries one explicit zero tile (BsrValueMap)
    assert got.n_items == ref.n_items
    assert got.n_c_tiles == ref.n_c_tiles
    with pytest.raises(ValueError, match="tile-K mismatch"):
        build_worklist(P(a_bsr), P(BsrMatrix.from_csr(z, 32, 64)))
    with pytest.raises(ValueError, match="unknown order"):
        build_worklist(P(BsrMatrix.from_csr(
            random_csr(64, 64, 0.2, seed=2, dtype=np.float32), 8, 64)),
            P(BsrMatrix.from_csr(
                random_csr(64, 64, 0.2, seed=3, dtype=np.float32), 64, 64)),
            order="diag")
