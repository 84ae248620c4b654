"""Densify's layout scorer on the card's tile model, and the one resolver
every densify caller of the port goes through.

The reference's scorer (``plan.densify.choose_densify``, the copy) prices
each candidate layout as ``W * (flops / peak + engine_item_overhead)``
against the unique tiles' bytes, at the one panel height it is given.  On
the card a plan pays its launch, the larger of its bytes with L2 reuse, its
items' throughput time and its blocks' latency (``plan.card_model``), and
the height that is cheapest differs from layout to layout.
:func:`card_choose_densify` keeps the reference's candidates, its 3% rule
in favour of the identity and its :class:`DensifyPlan`, and prices each
candidate as one uniform segment over all rows under the card's model, at
the height given or at the cheapest of the heights the planner then tries.
It counts from the permuted index arrays and builds no transformed matrix
for a candidate it does not pick, and it prices no candidate whose lower
bound already costs more than the cheapest priced before it.

:func:`densify_for` picks the scorer by config class, as
``card_model.planner_for`` picks the planner: the card's scorer under a
``CardConfig``, the copy's under a ``SpadaConfig``; a ``CardConfig`` in the
reference's form (no item table) scores as the copy does.
:func:`densify_workload` is the copy's ``GemmWorkload.preprocess_densified``
with the config's scorer.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from spada_tpu_torch.config import CardConfig
from spada_tpu_torch.io.workloads import GemmWorkload
from spada_tpu_torch.plan.card_model import (BTiles, _itemsize,
                                             cheapest_uniform, tile_heights)
from spada_tpu_torch.plan.densify import (DensifyPlan, apply_densify,
                                          choose_densify, degree_perm)
from spada_tpu_torch.sparse.csr import CsrMatrix


def card_choose_densify(a: CsrMatrix, b: CsrMatrix, T: int, config=None,
                        tm: Optional[int] = None,
                        allow_row_perm: bool = True,
                        tn: Optional[int] = None) -> DensifyPlan:
    """``choose_densify``'s candidates (the k anchors 0, T/4, T/2, 3T/4;
    ``ksort``; ``ksort+rowsort`` where ``allow_row_perm``) scored on the
    card's model: each the cheapest plan of one uniform segment over all
    rows at ``tm``, or without it at the heights ``tile_heights(config,
    T)``, tk = tn = T (``card_model.cheapest_uniform``).  A candidate whose
    every height's lower bound is at least the cheapest price found before
    it is not priced: it cannot win.  The cheapest wins unless it saves
    less than 3% on the identity, as in the reference.  ``modeled`` holds
    the pick's ``tm``, ``w`` (W) and ``t_est``, ``all`` ({candidate: t_est
    ms}, as the reference's; a lower bound for a candidate not priced) and
    ``candidates`` ({candidate: (tm, W, t_est s)}, W None where not
    priced).  Without the card's item table (a ``SpadaConfig``, or a
    ``CardConfig`` in the reference's form), where it has no point at T,
    or where ``tn`` differs from T, it is ``choose_densify(a, b, tm or T,
    T, tn or T, config, allow_row_perm=allow_row_perm)``."""
    config = config or CardConfig()
    tn = tn or T
    item = getattr(config, "tile_item_s", ())
    if tn != T or T not in {t for _, t, _ in item}:
        return choose_densify(a, b, tm or T, T, tn, config,
                              allow_row_perm=allow_row_perm)
    heights = [tm] if tm else tile_heights(config, T)
    itemsize = _itemsize(config)
    ar = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    ac = a.indices.astype(np.int64)
    br = np.repeat(np.arange(b.shape[0]), np.diff(b.indptr))
    bc = b.indices.astype(np.int64)
    cands = []

    def price(rows, a_cols, b_rows, k_dim, name, plan):
        bt = BTiles.of_arrays(b_rows, bc, (k_dim, b.shape[1]), T)
        best = min((t for t, *_ in cands), default=None)
        got = cheapest_uniform(rows, a_cols, bt, heights, itemsize, config,
                               cutoff=best)
        w = None if got.get("bound") else got["span"]["work"]
        plan.modeled = {"w": w, "tm": got["tm"], "t_est": got["t_est"]}
        cands.append((got["t_est"], name, plan))

    # in the reference's order: the sort below keeps it among equal prices
    for s in (0, T // 4, T // 2, 3 * T // 4):
        price(ar, ac + s, br + s, b.shape[0] + s, f"anchor{s}",
              DensifyPlan(k_anchor=s, candidate=f"anchor{s}"))
    acol = np.bincount(a.indices, minlength=a.shape[1]).astype(np.int64)
    blen = np.diff(b.indptr).astype(np.int64)
    kp = degree_perm(acol + blen)
    price(ar, kp[ac], kp[br], b.shape[0], "ksort",
          DensifyPlan(k_perm=kp, candidate="ksort"))
    if allow_row_perm:
        rp = degree_perm(np.diff(a.indptr).astype(np.int64))
        price(rp[ar], kp[ac], kp[br], b.shape[0], "ksort+rowsort",
              DensifyPlan(k_perm=kp, row_perm=rp,
                          candidate="ksort+rowsort"))

    cands.sort(key=lambda c: c[0])
    every = {name: round(t * 1e3, 4) for t, name, _ in cands}
    table = {name: (p.modeled["tm"], p.modeled["w"], t)
             for t, name, p in cands}
    best = cands[0][2]
    # the reference's rule: the identity unless the win is over 3%
    ident_t = next(t for t, name, _ in cands if name == "anchor0")
    if cands[0][0] > 0.97 * ident_t and best.candidate != "anchor0":
        best = next(p for t, name, p in cands if name == "anchor0")
    best.modeled.update(all=every, candidates=table)
    return best


def densify_for(config) -> Callable[..., DensifyPlan]:
    """The layout scorer for ``config``, called as ``(a, b, T, config,
    tm=None, allow_row_perm=True, tn=None)``: :func:`card_choose_densify`
    under a ``CardConfig``, the copy's ``choose_densify`` (at ``tm`` or T,
    tk = T, tn or T) under a ``SpadaConfig``."""
    if isinstance(config, CardConfig):
        return card_choose_densify
    return _reference_scorer


def _reference_scorer(a: CsrMatrix, b: CsrMatrix, T: int, config=None,
                      tm: Optional[int] = None, allow_row_perm: bool = True,
                      tn: Optional[int] = None) -> DensifyPlan:
    return choose_densify(a, b, tm or T, T, tn or T, config,
                          allow_row_perm=allow_row_perm)


def densify_workload(workload: GemmWorkload, config, T: int,
                     plan: Optional[DensifyPlan] = None) -> tuple:
    """``(workload, plan)``: the copy's ``GemmWorkload.preprocess_densified``
    at tile edge T (tm = tk = tn = T there) with the layout
    :func:`densify_for`'s scorer picks (or ``plan``, already picked):
    applied, and any row permutation folded into ``row_remap`` so that
    ``restore_row_order`` undoes it.  The identity returns ``workload``
    itself."""
    if plan is None:
        plan = densify_for(config)(workload.a, workload.b, T, config)
    if plan.is_identity:
        return workload, plan
    a2, b2 = apply_densify(workload.a, workload.b, plan)
    remap = workload.row_remap
    if plan.row_perm is not None:
        # densify's row_perm[old] = new; remap wants remap[new] = old
        d_remap = np.empty_like(plan.row_perm)
        d_remap[plan.row_perm] = np.arange(len(plan.row_perm))
        remap = d_remap if remap is None else remap[d_remap]
    return GemmWorkload(workload.name, a2, b2, remap), plan
