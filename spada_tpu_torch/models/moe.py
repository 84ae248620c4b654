"""The routed experts of a mixture-of-experts layer, as one card of an
expert-parallel deployment holds them: DeepSeek-V3's MoE layer
(``config.json``'s ``n_routed_experts``, ``num_experts_per_tok``,
``n_group``, ``topk_group``, ``norm_topk_prob``, ``routed_scaling_factor``,
``n_shared_experts``; SwiGLU experts of width ``moe_intermediate_size``).

:class:`ExpertShard` holds the router, over all experts, and the weights of
the experts it holds.  Its forward routes every token by the published rule
and computes the part of the layer's output that its experts give (plus the
shared expert's, on the card that counts it), in four steps, each a span of
:mod:`spada_tpu_torch.utils.trace`:

- ``moe.route``: scores s = sigmoid(x . Wg^T); choice scores s + bias; the
  groups of experts ranked by the sum of their two best choice scores, the
  ``topk_group`` best kept; the ``num_experts_per_tok`` best experts of the
  kept groups; their gates s, normalised to sum 1, times
  ``routed_scaling_factor``.  Attributes ``tokens``, ``copies_held`` and the
  held experts' ``load_max`` and ``load_mean``;
- ``moe.dispatch``: the copies routed to held experts, sorted by expert
  (MegaBlocks' grouped rows: expert e owns a run of N_e rows), as a CSR
  whose rows of group e are nonzero only in expert e's columns;
- ``moe.experts``: the gate/up projection X_g[M x E * hidden] .
  W13stack[E * hidden x 2 * inter], SwiGLU, then the down projection H[M x
  E * inter] . W2stack[E * inter x hidden], each one sparse product through
  the port's main path (``cli.run_spada``: dispatch, tile edge, panel plan,
  the planned tile kernels), whose ``plan``, ``layout.*`` and ``launch``
  spans fall inside this one;
- ``moe.combine``: each copy's output times its gate, added into its token.

The shared expert (intermediate ``n_shared_experts * inter``) is SwiGLU
and so separable along its intermediate width: it runs as
``n_shared_experts`` more groups of width ``inter`` that every token joins
with gate 1.  Router, SwiGLU and combine are plain torch in f32, with TF32
off.  :mod:`spada_tpu_torch.models.moe_reference` is the plain layer the
tests hold this one to.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from spada_tpu_torch.convert import check_device
from spada_tpu_torch.sparse.csr import CsrMatrix
from spada_tpu_torch.utils import trace


@contextlib.contextmanager
def no_tf32():
    """f32 matrix products in f32 within the block (TF32 off)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def route(logits: torch.Tensor, bias: torch.Tensor, n_group: int,
          topk_group: int, top_k: int, scale: float, norm: bool = True):
    """(experts int64 [T, top_k], gates f32 [T, top_k]) of ``logits`` [T,
    E] under DeepSeek-V3's group-limited rule (``noaux_tc``): see the
    module's ``moe.route``."""
    scores = logits.sigmoid()
    choice = scores + bias
    t, e = choice.shape
    group = choice.view(t, n_group, e // n_group).topk(2, dim=-1).values
    kept = group.sum(-1).topk(topk_group, dim=-1).indices
    mask = torch.zeros((t, n_group), dtype=torch.bool, device=logits.device)
    mask.scatter_(1, kept, True)
    choice = choice.masked_fill(
        ~mask.repeat_interleave(e // n_group, dim=1), float("-inf"))
    experts = choice.topk(top_k, dim=-1).indices
    gates = scores.gather(1, experts)
    if norm:
        gates = gates / gates.sum(-1, keepdim=True)
    return experts, gates * scale


def grouped_csr(values: torch.Tensor, group: np.ndarray,
                n_groups: int) -> CsrMatrix:
    """The grouped rows as a CSR of shape [M, n_groups * w]: row r (of
    ``values`` [M, w]) holds its w values in columns [group[r] * w,
    (group[r] + 1) * w), ``group`` int [M] nondecreasing.  Index arithmetic
    over all rows at once."""
    m, w = values.shape
    indices = (np.asarray(group, np.int32)[:, None] * np.int32(w)
               + np.arange(w, dtype=np.int32)).reshape(-1)
    return CsrMatrix((m, n_groups * w), np.arange(m + 1, dtype=np.int64) * w,
                     indices, values.detach().cpu().numpy().reshape(-1),
                     check=False)


def stacked_csr(blocks: Sequence[torch.Tensor]) -> CsrMatrix:
    """The dense blocks [rows_e, n] stacked along their rows, as a CSR of
    every entry (weights: their zeros are values, not structure)."""
    stack = torch.cat([b.detach().cpu() for b in blocks]).numpy()
    rows, n = stack.shape
    return CsrMatrix((rows, n), np.arange(rows + 1, dtype=np.int64) * n,
                     np.tile(np.arange(n, dtype=np.int32), rows),
                     stack.reshape(-1), check=False)


def _normal(shape, std: float, seed: int, tag: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed((seed * 1_000_003 + tag) % 2**63)
    return torch.randn(shape, generator=gen) * std


class ExpertShard:
    """The router over all experts and the weights of the experts ``held``
    (and, where ``shared``, the shared expert's), on ``device``.

    ``config``: the model's ``config.json`` keys (``hidden_size``,
    ``moe_intermediate_size``, ``n_routed_experts``,
    ``num_experts_per_tok``, ``n_group``, ``topk_group``,
    ``norm_topk_prob``, ``routed_scaling_factor``, ``n_shared_experts``).
    Weights are seeded random, N(0, 1 / fan-in): expert e's from its own
    stream of ``seed``, so that shards of one seed hold one model's
    experts.  ``e_score_correction_bias`` is learned and not in
    ``config.json``: zero here, settable.  ``spada_config``: the port's
    configuration the products plan under (``h100_config`` of the card,
    f32 tiles, by default)."""

    def __init__(self, config: Mapping, held: Sequence[int] = range(8),
                 shared: bool = True, device="cuda", seed: int = 0,
                 spada_config=None):
        self.device = check_device(device)
        h, w = config["hidden_size"], config["moe_intermediate_size"]
        self.n_experts = config["n_routed_experts"]
        self.top_k = config["num_experts_per_tok"]
        self.n_group, self.topk_group = config["n_group"], config["topk_group"]
        self.norm = bool(config.get("norm_topk_prob", True))
        self.scale = float(config.get("routed_scaling_factor", 1.0))
        self.hidden, self.inter = h, w
        self.held = [int(e) for e in held]
        if len(set(self.held)) != len(self.held) or not all(
                0 <= e < self.n_experts for e in self.held):
            raise ValueError(f"held experts {self.held} are not distinct "
                             f"experts of {self.n_experts}")
        dev = self.device
        self.router = _normal((self.n_experts, h), h ** -0.5, seed, -1).to(dev)
        self.bias = torch.zeros(self.n_experts, device=dev)
        self.experts = {e: (_normal((w, h), h ** -0.5, seed, 3 * e).to(dev),
                            _normal((w, h), h ** -0.5, seed, 3 * e + 1).to(dev),
                            _normal((h, w), w ** -0.5, seed, 3 * e + 2).to(dev))
                        for e in self.held}
        n_sh = int(config.get("n_shared_experts") or 0)
        self.shared = None
        if shared and n_sh:
            ws = w * n_sh
            self.shared = (_normal((ws, h), h ** -0.5, seed, -2).to(dev),
                           _normal((ws, h), h ** -0.5, seed, -3).to(dev),
                           _normal((h, ws), ws ** -0.5, seed, -4).to(dev))
        if spada_config is None:
            from spada_tpu_torch.config import h100_config

            spada_config = h100_config(
                torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else None, engine_dtype="float32")
        self.spada_config = spada_config
        self._stacks = None

    def weights(self) -> dict:
        """The weights as :func:`~spada_tpu_torch.models.moe_reference.
        expert_layer` takes them."""
        return {"router": self.router, "bias": self.bias,
                "experts": self.experts, "shared": self.shared}

    def _groups(self) -> list:
        """(w_gate, w_up, w_down) of each group: the held experts, then the
        shared expert's slices of width ``inter``."""
        out = [self.experts[e] for e in self.held]
        if self.shared is not None:
            wg, wu, wd = self.shared
            w = self.inter
            out += [(wg[s:s + w], wu[s:s + w], wd[:, s:s + w])
                    for s in range(0, wg.shape[0], w)]
        return out

    def stacks(self):
        """(W13stack, W2stack) as CSR: group g's rows of W13stack are
        [w_gate^T | w_up^T], its rows of W2stack w_down^T.  Built once."""
        if self._stacks is None:
            groups = self._groups()
            self._stacks = (
                stacked_csr([torch.cat([g.t(), u.t()], dim=1)
                             for g, u, _ in groups]),
                stacked_csr([d.t() for _, _, d in groups]))
        return self._stacks

    def _product(self, a: CsrMatrix, b: CsrMatrix) -> torch.Tensor:
        """a . b, dense on the device, through the port's main path."""
        from spada_tpu_torch.cli import run_spada

        run = run_spada(a, b, self.spada_config, device=self.device,
                        log=lambda msg: None)
        return torch.from_numpy(run.result.todense()).to(self.device)

    def forward(self, x: torch.Tensor,
                logits: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The held experts' part of the layer's output for the tokens ``x``
        [T, hidden] (f32), plus the shared expert's where it is held.
        ``logits`` [T, n_routed_experts]: the router's x . Wg^T where the
        caller has it."""
        x = x.to(self.device, torch.float32)
        n_held = len(self.held)
        with no_tf32():
            with trace.span("moe.route", tokens=int(x.shape[0])) as attrs:
                if logits is None:
                    logits = x @ self.router.t()
                experts, gates = route(logits.float(), self.bias,
                                       self.n_group, self.topk_group,
                                       self.top_k, self.scale, self.norm)
                local = torch.full((self.n_experts,), -1, dtype=torch.int64,
                                   device=self.device)
                local[torch.tensor(self.held, dtype=torch.int64,
                                   device=self.device)] = (
                    torch.arange(n_held, device=self.device))
                slot = local[experts]
                tok, k = (slot >= 0).nonzero(as_tuple=True)
                group, gate = slot[tok, k], gates[tok, k]
                load = torch.bincount(group, minlength=n_held)
                attrs.update(copies_held=int(group.shape[0]),
                             load_max=int(load.max()) if n_held else 0,
                             load_mean=float(load.float().mean())
                             if n_held else 0.0)
            n_groups = len(self._groups())
            out = torch.zeros_like(x)
            with trace.span("moe.dispatch") as attrs:
                # every token joins each slice of the shared expert, gate 1
                every = torch.arange(x.shape[0], device=self.device)
                shared = range(n_held, n_groups)
                tok = torch.cat([tok] + [every for _ in shared])
                group = torch.cat([group] + [torch.full_like(every, g)
                                             for g in shared])
                gate = torch.cat([gate] + [torch.ones_like(x[:, 0])
                                           for _ in shared])
                order = torch.argsort(group, stable=True)
                tok, gate = tok[order], gate[order]
                group = group[order].cpu().numpy()
                attrs["copies"] = int(tok.numel())
                if not tok.numel():
                    return out
                xg = grouped_csr(x[tok], group, n_groups)
            with trace.span("moe.experts", groups=n_groups):
                w13, w2 = self.stacks()
                c1 = self._product(xg, w13)
                del xg
                h = (torch.nn.functional.silu(c1[:, :self.inter])
                     * c1[:, self.inter:])
                del c1
                y = self._product(grouped_csr(h, group, n_groups), w2)
            with trace.span("moe.combine"):
                out.index_add_(0, tok, y * gate[:, None])
        return out

    __call__ = forward
