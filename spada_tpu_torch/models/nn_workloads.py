"""Sparse neural-net GEMM workload generation (the "NN" category).

The reference consumes a pre-pickled ``{name: (A, B)}`` of sparse DNN layer
GEMMs (py2rust.rs:5-60) but ships no generator.  This module creates that
pickle from standard pruned-layer shapes so the NN category is reproducible
end-to-end: magnitude-pruned fully-connected and attention-projection GEMMs
at configurable sparsity, in the exact format ``load_pickled_gemms`` reads.

Copy of :mod:`spada_tpu.models.nn_workloads`
for spada_tpu_torch, held equal to it by ``tests/test_torch_host.py``; only
the imports differ.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Tuple

import numpy as np


# (name, (out, in), batch/sequence columns) — classic pruned-DNN layer GEMMs
STOCK_LAYERS = {
    "alexnet_fc6": ((4096, 9216), 64),
    "alexnet_fc7": ((4096, 4096), 64),
    "resnet50_fc": ((1000, 2048), 256),
    "bert_qproj": ((768, 768), 512),
    "bert_ffn1": ((3072, 768), 512),
}


def pruned_weight(shape: Tuple[int, int], density: float, seed: int = 0,
                  structured_block: Optional[int] = None) -> "np.ndarray":
    """Magnitude-pruned dense weight -> sparse (smallest |w| dropped).

    ``structured_block``: if set, prune whole (b, b) blocks by block norm —
    the block-sparse regime the tile engine is designed for.
    """
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float64)
    if structured_block:
        b = structured_block
        pr = -(-shape[0] // b)
        pc = -(-shape[1] // b)
        pad = np.zeros((pr * b, pc * b))
        pad[: shape[0], : shape[1]] = w
        norms = np.linalg.norm(
            pad.reshape(pr, b, pc, b).transpose(0, 2, 1, 3), axis=(2, 3)
        )
        k = max(1, int(norms.size * density))
        thresh = np.partition(norms.ravel(), -k)[-k]
        mask_blocks = norms >= thresh
        mask = np.repeat(np.repeat(mask_blocks, b, axis=0), b, axis=1)
        w = (pad * mask)[: shape[0], : shape[1]]
    else:
        k = max(1, int(w.size * density))
        thresh = np.partition(np.abs(w).ravel(), -k)[-k]
        w = w * (np.abs(w) >= thresh)
    return w


def make_nn_gemms(
    density: float = 0.1,
    act_density: float = 0.35,
    structured_block: Optional[int] = None,
    seed: int = 0,
    layers: Optional[Dict] = None,
) -> Dict:
    """Build ``{name: (A_sparse_weight, B_sparse_activation)}`` (scipy CSR).

    Activations are ReLU-sparse (act_density fraction nonzero) — the
    sparse-times-sparse regime the reference's NN category targets.
    """
    import scipy.sparse as sp

    layers = layers or STOCK_LAYERS
    rng = np.random.default_rng(seed + 1)
    gemms = {}
    for i, (name, ((out_dim, in_dim), cols)) in enumerate(layers.items()):
        w = pruned_weight((out_dim, in_dim), density, seed=seed + i,
                          structured_block=structured_block)
        acts = rng.standard_normal((in_dim, cols))
        acts *= rng.random((in_dim, cols)) < act_density
        gemms[name] = (sp.csr_matrix(w), sp.csr_matrix(acts))
    return gemms


def write_nn_pickle(path: str, **kwargs) -> Dict:
    gemms = make_nn_gemms(**kwargs)
    with open(path, "wb") as f:
        pickle.dump(gemms, f)
    return gemms
