"""One FFN output projection of a transformer with a block-pruned weight:
C[hidden x tokens] = W2[hidden x ffn] . H[ffn x tokens], H the ReLU output
of the first projection.

The structures are frozen copies of ``spada_tpu_torch.io.workloads``'
``block_sparse_csr`` (dense blocks, ``fill`` 1) and ``relu_activation_csr``,
split into structure and values.  W2's pruning mask is part of the model, so
it comes from the configuration's ``weight_mask_seed`` and is the same in
every run: every seed then gives the kernels the same tiles to multiply.  The
run's seed draws W2's values (uniform in [-0.5, 0.5)), H's ReLU pattern
(each entry nonzero with ``activation_density``) and, per value set, H's
values (uniform in (0, 1], as a ReLU's positive outputs).
"""

from __future__ import annotations

import numpy as np

from gpu_bench.csr import Csr, stream


def block_sparse_structure(m: int, n: int, block: int, block_density: float,
                           rng: np.random.Generator):
    """(indptr, indices) of an m x n matrix in which a random
    ``block_density`` share of the (block, block) tiles is dense."""
    pr, pc = -(-m // block), -(-n // block)
    nz = max(1, int(pr * pc * block_density))
    sel = np.sort(rng.choice(pr * pc, size=nz, replace=False))
    br, bc = sel // pc, sel % pc
    bw = np.minimum(block, n - bc * block).astype(np.int64)
    within = (np.arange(int(bw.sum()), dtype=np.int32)
              - np.repeat((np.cumsum(bw) - bw).astype(np.int32), bw))
    cols_once = np.repeat((bc * block).astype(np.int32), bw) + within
    seg_len = np.zeros(pr, np.int64)
    np.add.at(seg_len, br, bw)
    seg_start = np.concatenate(([0], np.cumsum(seg_len)[:-1]))
    row_h = np.minimum(block, m - np.arange(pr, dtype=np.int64) * block)
    indptr = np.concatenate(([0], np.cumsum(np.repeat(seg_len, row_h))))
    parts = [np.tile(cols_once[seg_start[g]:seg_start[g] + seg_len[g]],
                     int(row_h[g]))
             for g in range(pr) if seg_len[g]]
    indices = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    return indptr.astype(np.int64), indices.astype(np.int32)


def relu_activation_structure(m: int, n: int, density: float,
                              rng: np.random.Generator):
    """(indptr, indices) of an m x n matrix whose entries are nonzero
    independently with probability ``density``."""
    mask = rng.random((m, n), dtype=np.float32) < density
    row_len = mask.sum(axis=1, dtype=np.int64)
    indptr = np.concatenate(([0], np.cumsum(row_len)))
    indices = (np.flatnonzero(mask.reshape(-1)) % n).astype(np.int32)
    return indptr, indices


def generate(config: dict, traffic: dict, seed: int, value_sets: int):
    """[(W2, H_s)] for s < ``value_sets``: one W2, H's values differing."""
    asm = config["assumed"]
    hidden, ffn, tokens = (config["hidden_size"], config["ffn_dim"],
                           traffic["tokens"])
    w_ptr, w_idx = block_sparse_structure(
        hidden, ffn, asm["weight_block"], asm["weight_block_density"],
        np.random.default_rng(asm["weight_mask_seed"]))
    w = Csr((hidden, ffn), w_ptr, w_idx,
            stream(seed, "w2").random(len(w_idx), dtype=np.float32) - 0.5)
    h_ptr, h_idx = relu_activation_structure(
        ffn, tokens, asm["activation_density"], stream(seed, "h.pattern"))
    return [(w, Csr((ffn, tokens), h_ptr, h_idx,
                    1 - stream(seed, f"h.values.{s}").random(
                        len(h_idx), dtype=np.float32)))
            for s in range(value_sets)]
