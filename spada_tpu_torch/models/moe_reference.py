"""Plain reference of DeepSeek-V3's MoE layer, or of the part of it that
one card of an expert-parallel deployment computes: plain torch in f32,
TF32 off, no module of the port.

The published layer (``modeling_deepseek.py``'s ``MoEGate`` and
``DeepseekV3MoE``; ``inference/model.py``'s ``Gate`` and ``MoE``): scores
s = sigmoid(x . Wg^T); choice scores s + ``e_score_correction_bias``; the
``n_group`` groups of experts ranked by the sum of their two best choice
scores, the ``topk_group`` best kept, the others masked out; the
``num_experts_per_tok`` best experts of the kept groups; gates the chosen
experts' s, normalised to sum 1 (``norm_topk_prob``), times
``routed_scaling_factor``; each routed copy through its expert, SwiGLU
w_down . (silu(w_gate . x) * (w_up . x)), times its gate, summed per token;
plus the shared expert, SwiGLU of width ``n_shared_experts *
moe_intermediate_size``, with no gate.

Departures, as for the program: only the experts ``held`` contribute, and
the shared expert only where ``shared`` (one card's share of an
expert-parallel layer: what the other cards' experts add is left out); no
redundant replicas of hot experts (DeepSeek's EPLB); no exchange between
cards; the bias is zero unless given (it is learned, not in
``config.json``).
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch


def route(logits: torch.Tensor, bias: torch.Tensor, config: Mapping):
    """(experts int64 [T, k], gates [T, k]) of ``logits`` [T, E]."""
    scores = logits.sigmoid()
    choice = scores + bias
    t, e = choice.shape
    n_group = config["n_group"]
    group_scores = choice.view(t, n_group, -1).topk(2, dim=-1)[0].sum(dim=-1)
    group_idx = group_scores.topk(config["topk_group"], dim=-1)[1]
    group_mask = torch.zeros_like(group_scores).scatter_(1, group_idx, 1)
    score_mask = group_mask.unsqueeze(-1).expand(
        t, n_group, e // n_group).reshape(t, e)
    choice = choice.masked_fill(~score_mask.bool(), float("-inf"))
    experts = choice.topk(config["num_experts_per_tok"], dim=-1)[1]
    gates = scores.gather(1, experts)
    if config.get("norm_topk_prob", True):
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return experts, gates * config.get("routed_scaling_factor", 1.0)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """One expert: w_down . (silu(w_gate . x) * (w_up . x)), rows of x."""
    return (torch.nn.functional.silu(x @ w_gate.t()) * (x @ w_up.t())) @ \
        w_down.t()


def expert_layer(x: torch.Tensor, weights: Mapping, config: Mapping,
                 held: Sequence[int], shared: bool,
                 logits: Optional[torch.Tensor] = None,
                 block: int = 1 << 14) -> torch.Tensor:
    """The layer's output for the tokens ``x`` [T, hidden] that the experts
    ``held`` give, plus the shared expert's where ``shared``.  ``weights``:
    ``router`` [E, hidden], ``bias`` [E], ``experts`` {e: (w_gate [inter,
    hidden], w_up, w_down [hidden, inter])}, ``shared`` (the same, width
    ``n_shared_experts * inter``) or None.  ``logits``: x . Wg^T where the
    caller has it.  Tokens go through in blocks of ``block``."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = torch.zeros_like(x)
        for t0 in range(0, x.shape[0], block):
            xb = x[t0:t0 + block]
            lb = (xb @ weights["router"].t() if logits is None
                  else logits[t0:t0 + block])
            experts, gates = route(lb.float(), weights["bias"], config)
            yb = out[t0:t0 + block]
            for e in held:
                tok, k = (experts == e).nonzero(as_tuple=True)
                if tok.numel():
                    y = swiglu(xb[tok], *weights["experts"][e])
                    yb.index_add_(0, tok, y * gates[tok, k, None])
            if shared and weights.get("shared") is not None:
                yb += swiglu(xb, *weights["shared"])
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
