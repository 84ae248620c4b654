"""The frozen generators against the properties their sources state."""

import numpy as np
import pytest

from gpu_bench.generators import ffn_block_pruned as ffn
from gpu_bench.generators import graph500_kronecker as g500

GRAPH = {"scale": 10, "edgefactor": 16, "A": 0.57, "B": 0.19, "C": 0.19,
         "assumed": {"edge_list_seed": 500}}
FFN = {"hidden_size": 256, "ffn_dim": 512,
       "assumed": {"weight_block": 32, "weight_block_density": 0.1,
                   "weight_mask_seed": 1301, "activation_density": 0.1}}


def _dense(m):
    d = np.zeros(m.shape, np.float64)
    rows = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
    np.add.at(d, (rows, m.indices), m.data)
    return d


@pytest.mark.parametrize("seed", [0, 7, 2**40 + 3])
def test_graph500_is_undirected_simple_and_weighted(seed):
    pairs = g500.generate(GRAPH, {"product": "A.A"}, seed, 2)
    a, b = pairs[0]
    assert a is b
    d = _dense(a)
    assert np.array_equal(d, d.T)
    assert not np.any(np.diag(d))
    for r in range(a.shape[0]):
        cols = a.indices[a.indptr[r]:a.indptr[r + 1]]
        assert np.all(np.diff(cols) > 0)
    assert np.all((a.data >= 0) & (a.data < 1))
    a1 = pairs[1][0]
    assert a1.same_structure(a)
    assert not np.array_equal(a1.data, a.data)


def test_graph500_quadrant_shares():
    rng = np.random.default_rng(3)
    i, j = g500.kronecker_edges(12, 16, 0.57, 0.19, 0.19, rng)
    top_i, top_j = i >> 11, j >> 11
    m = len(i)
    for (bi, bj), share in (((0, 0), 0.57), ((0, 1), 0.19), ((1, 0), 0.19),
                            ((1, 1), 0.05)):
        got = np.count_nonzero((top_i == bi) & (top_j == bj)) / m
        assert abs(got - share) < 0.01, (bi, bj, got)


def test_graph500_seeds_permute_one_graph():
    a = g500.generate(GRAPH, {"product": "A.A"}, 1, 1)[0][0]
    b = g500.generate(GRAPH, {"product": "A.A"}, 2, 1)[0][0]
    assert a.nnz == b.nnz
    da, db = np.diff(a.indptr), np.diff(b.indptr)
    assert np.array_equal(np.sort(da), np.sort(db))
    assert not np.array_equal(da, db)


def test_graph500_rejects_another_product():
    with pytest.raises(ValueError):
        g500.generate(GRAPH, {"product": "A.B"}, 1, 1)


@pytest.mark.parametrize("seed", [0, 11, 2**33])
def test_ffn_block_and_activation_densities(seed):
    pairs = ffn.generate(FFN, {"tokens": 2048}, seed, 2)
    (w, h0), (w1, h1) = pairs
    assert w is w1
    blk = 32
    dw = _dense(w) != 0
    blocks = dw.reshape(256 // blk, blk, 512 // blk, blk).any(axis=(1, 3))
    full = dw.reshape(256 // blk, blk, 512 // blk, blk).all(axis=(1, 3))
    assert blocks.sum() == int(blocks.size * 0.1)
    assert np.array_equal(blocks, full)
    assert abs(h0.nnz / (512 * 2048) - 0.1) < 0.005
    assert np.all((h0.data > 0) & (h0.data <= 1))
    assert h1.same_structure(h0) and not np.array_equal(h1.data, h0.data)
    assert np.all((w.data >= -0.5) & (w.data < 0.5))


def test_ffn_mask_is_the_models_values_are_the_seeds():
    w_a = ffn.generate(FFN, {"tokens": 256}, 1, 1)[0][0]
    w_b = ffn.generate(FFN, {"tokens": 256}, 2, 1)[0][0]
    assert w_a.same_structure(w_b)
    assert not np.array_equal(w_a.data, w_b.data)
    again = ffn.generate(FFN, {"tokens": 256}, 1, 1)[0]
    assert np.array_equal(again[0].data, w_a.data)
