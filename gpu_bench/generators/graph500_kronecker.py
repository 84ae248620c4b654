"""The Graph500 graph: the specification's Kronecker generator
(``kronecker_generator.m`` of its reference code: R-MAT initiator a, b, c,
d = 1 - a - b - c, N = 2^scale vertices, edgefactor * N edges), with the
vertex labels randomly permuted, made undirected (A + A^T), self-loops
dropped and duplicate edges merged; weights uniform in [0, 1) per undirected
edge, as in the specification's SSSP kernel.

The edge list comes from the configuration's ``edge_list_seed`` and is the
same in every run; the run's seed draws the vertex permutation, which the
specification's generator applies anyway, and the weights of each value set.
Every seed then gives the same products in another order.  The traffic's
``product`` says which product of the graph is taken; ``"A.A"``, the two-hop
product, is the one supported.
"""

from __future__ import annotations

import numpy as np

from gpu_bench.csr import Csr, from_sorted_coo, stream


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float,
                    c: float, rng: np.random.Generator):
    """(i, j) int64 [edgefactor * 2^scale]: the reference generator's edge
    list before its permutations, labels from 0."""
    m = edgefactor * (1 << scale)
    ab = a + b
    c_norm = c / (1 - ab)
    a_norm = a / ab
    i = np.zeros(m, np.int64)
    j = np.zeros(m, np.int64)
    for level in range(scale):
        i_bit = rng.random(m) > ab
        j_bit = rng.random(m) > np.where(i_bit, c_norm, a_norm)
        i += i_bit.astype(np.int64) << level
        j += j_bit.astype(np.int64) << level
    return i, j


def undirected_structure(n: int, i: np.ndarray, j: np.ndarray):
    """(lo, hi): each undirected edge once with lo < hi, sorted; self-loops
    dropped, duplicates merged."""
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    keep = lo != hi
    key = np.unique(lo[keep] * n + hi[keep])
    return key // n, key % n


def generate(config: dict, traffic: dict, seed: int, value_sets: int):
    """[(A_s, A_s)] for s < ``value_sets``: one graph, weights differing."""
    if traffic["product"] != "A.A":
        raise ValueError(f"graph500_kronecker: unknown product "
                         f"{traffic['product']!r}")
    n = 1 << config["scale"]
    i, j = kronecker_edges(config["scale"], config["edgefactor"], config["A"],
                           config["B"], config["C"],
                           np.random.default_rng(
                               config["assumed"]["edge_list_seed"]))
    perm = stream(seed, "vertex.permutation").permutation(n)
    lo, hi = undirected_structure(n, perm[i], perm[j])
    rows = np.concatenate((lo, hi))
    cols = np.concatenate((hi, lo))
    order = np.lexsort((cols, rows))
    pairs = []
    for s in range(value_sets):
        w = stream(seed, f"weights.{s}").random(len(lo), dtype=np.float32)
        g = from_sorted_coo((n, n), rows[order], cols[order],
                            np.concatenate((w, w))[order])
        pairs.append((g, g))
    return pairs
