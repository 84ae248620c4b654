"""The down projection of the routed experts one card holds, as one grouped
product: C[M x hidden] = H[M x E * inter] . W2stack[E * inter x hidden].

The step's tokens are routed over all ``n_routed_experts`` by the published
rule (sigmoid scores, the ``n_group`` groups ranked by the sum of their two
best scores, the ``topk_group`` best kept, the ``num_experts_per_tok`` best
experts in them), here in NumPy, apart from the port.  The copies routed to
the E held experts (``experts_held`` from ``experts_held_first``) are sorted
by expert: expert e owns a run of N_e rows of H, nonzero only in columns
[e * inter, (e + 1) * inter) (the m-grouped contiguous layout of MoE grouped
GEMMs).  W2stack stacks the held experts' down weights, each inter x hidden,
dense.

The routing logits are N(0, 1), drawn once from the configuration's
``routing_seed``, so every run multiplies the same groups.  The run's seed
draws W2stack's values (N(0, 1) / sqrt(inter)) and, per value set, H's
(silu(g) * u, g and u N(0, 1): SwiGLU outputs, signed).
"""

from __future__ import annotations

import numpy as np

from gpu_bench.csr import Csr, stream


def route(logits: np.ndarray, n_group: int, topk_group: int,
          top_k: int) -> np.ndarray:
    """int64 [T, top_k]: the experts each token's row of ``logits`` [T, E]
    chooses (bias 0): sigmoid scores; the groups of E / n_group experts
    ranked by the sum of their two best scores, the ``topk_group`` best
    kept; the ``top_k`` best experts of the kept groups."""
    t, e = logits.shape
    scores = 1 / (1 + np.exp(-logits))
    grouped = scores.reshape(t, n_group, e // n_group)
    group_score = np.sort(grouped, axis=2)[:, :, -2:].sum(axis=2)
    kept = np.argpartition(-group_score, topk_group - 1,
                           axis=1)[:, :topk_group]
    mask = np.zeros((t, n_group), bool)
    mask[np.arange(t)[:, None], kept] = True
    masked = np.where(np.repeat(mask, e // n_group, axis=1), scores, -np.inf)
    return np.argpartition(-masked, top_k - 1, axis=1)[:, :top_k]


def group_sizes(config: dict, tokens: int) -> np.ndarray:
    """int64 [E]: the copies each held expert receives of the step's
    ``tokens``, routed from the configuration's fixed logits."""
    n = config["n_routed_experts"]
    logits = np.random.default_rng(
        config["assumed"]["routing_seed"]).standard_normal(
            (tokens, n), dtype=np.float32)
    chosen = route(logits, config["n_group"], config["topk_group"],
                   config["num_experts_per_tok"])
    lo = config["experts_held_first"]
    held = chosen[(chosen >= lo) & (chosen < lo + config["experts_held"])]
    return np.bincount(held - lo, minlength=config["experts_held"])


def grouped_structure(sizes: np.ndarray, width: int):
    """(indptr, indices) of the grouped rows: sizes[e] rows, each dense in
    columns [e * width, (e + 1) * width)."""
    m = int(sizes.sum())
    group = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    indptr = np.arange(m + 1, dtype=np.int64) * width
    indices = (group[:, None] * width
               + np.arange(width, dtype=np.int32)).reshape(-1)
    return indptr, indices


def dense_structure(rows: int, cols: int):
    """(indptr, indices) of a dense rows x cols matrix."""
    return (np.arange(rows + 1, dtype=np.int64) * cols,
            np.tile(np.arange(cols, dtype=np.int32), rows))


def generate(config: dict, traffic: dict, seed: int, value_sets: int):
    """[(H_s, W2stack)] for s < ``value_sets``: one W2stack, H's values
    differing."""
    inter, hidden = config["moe_intermediate_size"], config["hidden_size"]
    held = config["experts_held"]
    sizes = group_sizes(config, traffic["tokens"])
    h_ptr, h_idx = grouped_structure(sizes, inter)
    w_ptr, w_idx = dense_structure(held * inter, hidden)
    w2 = Csr((held * inter, hidden), w_ptr, w_idx,
             stream(seed, "w2").standard_normal(len(w_idx), dtype=np.float32)
             * np.float32(inter ** -0.5))
    pairs = []
    for s in range(value_sets):
        rng = stream(seed, f"h.values.{s}")
        g = rng.standard_normal(len(h_idx), dtype=np.float32)
        u = rng.standard_normal(len(h_idx), dtype=np.float32)
        h = Csr((int(sizes.sum()), held * inter), h_ptr, h_idx,
                g / (1 + np.exp(-g)) * u)
        pairs.append((h, w2))
    return pairs
