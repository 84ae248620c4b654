"""Densify's layout scorer on the card's model
(``spada_tpu_torch.plan.card_densify``), the lower bound the card's model
prunes its pricing with, and the card's recorded resident blocks.

Under a ``SpadaConfig``, and under a ``CardConfig`` in the reference's form
(``config.REFERENCE_TILE_TERMS``), ``densify_for``'s scorer is the JAX
package's ``choose_densify``: the same pick, anchor, permutations and
modelled times.  Under the card's terms each candidate is priced from its
permuted index arrays as ``card_plan_cost`` prices the transformed pair (or
not priced, where its lower bound shows it cannot win), the pick is the
one the full prices give, and the layouts it picks run to scipy's C.
"""

import dataclasses

import numpy as np
import pytest

from spada_tpu.plan.densify import choose_densify as ref_choose_densify
from spada_tpu_torch import cli
from spada_tpu_torch.config import (_TILE_RESIDENT, _TILE_SMS,
                                    REFERENCE_TILE_TERMS, CardConfig,
                                    SpadaConfig, h100_config)
from spada_tpu_torch.convert import from_reference as P
from spada_tpu_torch.io.workloads import GemmWorkload
from spada_tpu_torch.ops.spgemm import spgemm
from spada_tpu_torch.plan.card_densify import (card_choose_densify,
                                               densify_for, densify_workload)
from spada_tpu_torch.plan.card_model import (BTiles, _floor, card_plan_cost,
                                             card_span_cost, card_tile_size,
                                             plan_spgemm_card, planner_for,
                                             tile_heights)
from spada_tpu_torch.plan.densify import (DensifyPlan, apply_densify,
                                          choose_densify, degree_perm)
from spada_tpu_torch.plan.estimator import BTileStructure
from spada_tpu_torch.tools import eval_adaptive
from test_fuzz import _random_case
from test_torch_card_model import EVAL_N, _ref_config, _ref_csr

NAMES = ["cari", "banded", "loc-powerlaw", "uni-powerlaw", "mixed",
         "banded-offset", "rmat", "nn-bert-ffn1", "nn-bert-ffn1-blk32",
         f"fem-graded-{eval_adaptive.fem_edges(EVAL_N)}"]
#: the two configs that score as the reference does
KINDS = ("SpadaConfig", "reference form")


@pytest.fixture(scope="module")
def eval_pairs():
    return eval_adaptive.workloads(EVAL_N)


def _pair(name, cari_workload, eval_pairs):
    """(reference CSR A, B) of ``name``."""
    if name == "cari":
        return cari_workload.a, cari_workload.b
    a, b = eval_pairs[name]
    return _ref_csr(a), _ref_csr(b)


def _config(kind: str, dtype: str = "float32"):
    if kind == "SpadaConfig":
        return SpadaConfig(engine_dtype=dtype)
    return h100_config(engine_dtype=dtype, **REFERENCE_TILE_TERMS)


def _same_pick(got, ref):
    assert got.candidate == ref.candidate
    assert got.k_anchor == ref.k_anchor
    for g, r in ((got.k_perm, ref.k_perm), (got.row_perm, ref.row_perm)):
        assert (g is None) == (r is None)
        if r is not None:
            np.testing.assert_array_equal(g, r)
    assert got.modeled["all"] == ref.modeled["all"]


def _check_reference_kind(a, b, kind):
    """densify_for's scorer against the JAX package's choose_densify: the
    CLI's call (tm = T, row permutations allowed) and the uniform path's
    (the config's height, tk = tn = T, no row permutation)."""
    cfg = _config(kind)
    scorer = densify_for(cfg)
    ref_cfg = _ref_config(cfg)
    T = cfg.tile_k
    _same_pick(scorer(P(a), P(b), T, cfg),
               ref_choose_densify(a, b, T, T, T, ref_cfg))
    tm = cfg.default_tm if cfg.default_tm <= T else T
    _same_pick(scorer(P(a), P(b), T, cfg, tm=32, allow_row_perm=False),
               ref_choose_densify(a, b, 32, T, T, ref_cfg,
                                  allow_row_perm=False))
    _same_pick(scorer(P(a), P(b), T, cfg, tm=tm, allow_row_perm=False,
                      tn=cfg.tile_n),
               ref_choose_densify(a, b, tm, T, cfg.tile_n, ref_cfg,
                                  allow_row_perm=False))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", NAMES)
def test_reference_kinds_score_as_the_reference(cari_workload, eval_pairs,
                                                name, kind):
    """cari and the eval's pairs at n = 1024: under a ``SpadaConfig`` and a
    ``CardConfig`` in the reference's form the pick, anchor, permutations
    and ``modeled['all']`` are the JAX package's ``choose_densify``'s."""
    _check_reference_kind(*_pair(name, cari_workload, eval_pairs), kind)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", range(20))
def test_reference_kinds_score_fuzz_cases_as_the_reference(seed, kind):
    """``tests/test_fuzz.py``'s random cases, seeds 0-19."""
    _, a, b = _random_case(seed)
    _check_reference_kind(a, b, kind)


def test_densify_for_resolves_by_config_kind():
    """The card's scorer under a ``CardConfig`` (the copy's scorer inside
    it in the reference's form), the copy's under a ``SpadaConfig``."""
    assert densify_for(h100_config()) is card_choose_densify
    assert densify_for(CardConfig()) is card_choose_densify
    assert densify_for(SpadaConfig()) is not card_choose_densify
    assert planner_for(h100_config())[1] is plan_spgemm_card


def _candidate_plans(a, b, T, allow_row_perm=True):
    """The DensifyPlan of every candidate choose_densify scores."""
    plans = {f"anchor{s}": DensifyPlan(k_anchor=s)
             for s in (0, T // 4, T // 2, 3 * T // 4)}
    kp = degree_perm(np.bincount(a.indices, minlength=a.shape[1])
                     + np.diff(b.indptr))
    plans["ksort"] = DensifyPlan(k_perm=kp)
    if allow_row_perm:
        plans["ksort+rowsort"] = DensifyPlan(
            k_perm=kp, row_perm=degree_perm(np.diff(a.indptr)))
    return plans


def _reference_rule(prices: dict) -> str:
    """The candidate ``choose_densify``'s rule picks from full prices in
    the candidates' order: the cheapest (the first among equals) unless it
    saves less than 3% on the identity."""
    best = min(prices, key=lambda c: prices[c])
    return best if prices[best] <= 0.97 * prices["anchor0"] else "anchor0"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["banded-offset", "rmat", "banded",
                                  "nn-bert-ffn1-blk32", "cari"])
def test_each_candidate_is_priced_as_its_transformed_pair(
        cari_workload, eval_pairs, name, dtype):
    """Each candidate's (tm, W, t_est) from the permuted index arrays is
    ``card_plan_cost`` of one uniform span of ``apply_densify``'s
    transformed pair at that tm, the cheapest of the heights tried; its B
    tiles are ``BTileStructure`` of the transformed B.  A candidate not
    priced (W None) has a lower bound of its price at least the pick's,
    and the pick is the one the full prices give."""
    a, b = (P(m) for m in _pair(name, cari_workload, eval_pairs))
    cfg = h100_config(engine_dtype=dtype)
    T, isz = 128, 2 if dtype == "bfloat16" else 4
    got = card_choose_densify(a, b, T, cfg)
    table = got.modeled["candidates"]
    plans = _candidate_plans(a, b, T)
    assert set(table) == set(plans)
    full = {}
    for cand in plans:
        tm, W, t = table[cand]
        a2, b2 = apply_densify(a, b, plans[cand])
        bt = BTileStructure(b2, T, T)
        mine = BTiles.of_csr(b2, T)
        for f in ("tk", "tn", "n_k_tiles", "n_tile_cols", "tile_k",
                  "tile_j", "rowptr"):
            np.testing.assert_array_equal(getattr(mine, f), getattr(bt, f))
        prices = {h: card_plan_cost([card_span_cost(
            a2, 0, a2.shape[0], h, bt, isz, cfg)], cfg)[0]
            for h in tile_heights(cfg, T)}
        full[cand] = min(prices.values())
        if W is None:
            assert got.modeled["t_est"] <= t <= full[cand]
            continue
        assert t == pytest.approx(prices[tm], rel=1e-12)
        assert t == pytest.approx(full[cand], rel=1e-12)
        assert W == card_span_cost(a2, 0, a2.shape[0], tm, bt, isz,
                                   cfg)["work"]
    assert got.candidate == _reference_rule(full)
    # at a given height every candidate is priced at it
    at = card_choose_densify(a, b, T, cfg, tm=32, allow_row_perm=False)
    assert {tm for tm, _, _ in at.modeled["candidates"].values()} == {32}
    assert "ksort+rowsort" not in at.modeled["candidates"]


def _no_l2(cfg):
    """``cfg`` with no L2 reuse: every read from HBM."""
    return dataclasses.replace(cfg, tile_l2_bytes_per_s=0.0,
                               tile_l2_bytes=0)


@pytest.mark.parametrize("l2", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["cari", "banded", "loc-powerlaw", "rmat",
                                  "mixed", "nn-bert-ffn1"])
def test_floor_bounds_every_price(cari_workload, eval_pairs, name, dtype,
                                  l2):
    """The lower bound the card's model prunes with is at most the price of
    every height at every T, with L2 reuse and without; and
    ``card_tile_size``, which prices past it, gives each T the cheapest
    height's price."""
    a, b = (P(m) for m in _pair(name, cari_workload, eval_pairs))
    cfg = h100_config(engine_dtype=dtype)
    if not l2:
        cfg = _no_l2(cfg)
    isz = 2 if dtype == "bfloat16" else 4
    rows = np.repeat(np.arange(a.shape[0]), np.diff(a.indptr))
    _, det = card_tile_size(a, b, cfg)
    for T in (128, 256, 384, 512):
        bt = BTiles.of_csr(b, T)
        prices = {}
        for tm in tile_heights(cfg, T):
            tiles = np.unique((rows // tm) * bt.n_k_tiles + a.indices // T)
            sp = card_span_cost(a, 0, a.shape[0], tm, bt, isz, cfg)
            prices[tm] = card_plan_cost([sp], cfg)[0]
            assert _floor(tiles // bt.n_k_tiles, tiles % bt.n_k_tiles, bt,
                          tm, isz, cfg) <= prices[tm]
        tm = min(prices, key=lambda h: (prices[h], h))
        assert det[T]["tm"] == tm
        assert det[T]["t_est"] == pytest.approx(prices[tm], rel=1e-12)


def test_blk32_picks_under_both_scorers(eval_pairs):
    """nn-bert-ffn1-blk32 (a fixed-size pair), T = 128, bf16 tiles: the
    reference's scorer picks ``ksort+rowsort``; the card's model picks the
    identity (a tm-32 plan against ``ksort+rowsort``'s tm 64)."""
    a, b = eval_pairs["nn-bert-ffn1-blk32"]
    cfg = h100_config(engine_dtype="bfloat16")
    parent = eval_adaptive.parent_config(cfg)
    ref = densify_for(parent)(a, b, 128, parent)
    assert ref.candidate == "ksort+rowsort"
    assert choose_densify(a, b, 128, 128, 128, cfg).candidate == \
        "ksort+rowsort"
    got = densify_for(cfg)(a, b, 128, cfg)
    assert got.is_identity
    assert got.modeled["tm"] == 32 and got.modeled["w"] == 784
    # ksort+rowsort's own plan: tm 64, W 800, dearer than the identity's
    # (its bound alone shows that, so the scorer does not price it)
    a2, b2 = apply_densify(a, b, ref)
    _, det = card_tile_size(a2, b2, cfg, candidates=(128,))
    assert (det[128]["tm"], det[128]["W"]) == (64, 800)
    bound = got.modeled["candidates"]["ksort+rowsort"][2]
    assert got.modeled["t_est"] < bound <= det[128]["t_est"]


def test_card_scorer_runs_to_scipy_and_the_reference():
    """Under the card's scorer the uniform path (R-MAT 2048^2: ``ksort``
    at tm 128) and ``cli.run_spada(densify=True)`` (``ksort+rowsort`` at
    its T = 128, the rows put back through ``row_remap``) give scipy's C
    and the JAX package's ``spgemm``'s, within the f32 gate."""
    import importlib

    from spada_tpu.io.workloads import rmat_csr

    jax_spgemm = importlib.import_module("spada_tpu.ops.spgemm")
    ra = rmat_csr(2048, 12.0, seed=8, dtype=np.float32)
    rb = rmat_csr(2048, 12.0, seed=9, dtype=np.float32)
    a, b = P(ra), P(rb)
    cfg = dataclasses.replace(h100_config(), element_dispatch="never")
    oracle = np.asarray((a.to_scipy() @ b.to_scipy()).todense())
    ref = jax_spgemm.spgemm(ra, rb, _ref_config(cfg),
                            dataflow="spada").todense()

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(want).max(), 1.0))

    pick = densify_for(cfg)(a, b, cfg.tile_k, cfg, tm=cfg.default_tm,
                            allow_row_perm=False)
    assert pick.candidate == "ksort"
    res = spgemm(a, b, cfg, dataflow="spada", device="cpu")
    close(res.todense(), oracle)
    close(res.todense(), ref)

    lines = []
    run = cli.run_spada(a, b, cfg, "cpu", densify=True, log=lines.append)
    assert "densify: ksort+rowsort" in lines
    got = np.empty_like(oracle)
    got[run.row_remap] = run.result.todense()
    close(got, oracle)
    close(got, ref)


def test_densify_workload_is_preprocess_densified_with_the_scorer(
        eval_pairs):
    """With the reference's scorer ``densify_workload`` is the copy's
    ``preprocess_densified`` at tm = tk = tn = T: the same pair, plan and
    ``row_remap``, on an already reordered workload too."""
    a, b = eval_pairs["rmat"]
    cfg = SpadaConfig()
    w = GemmWorkload("rmat", a, b).preprocess_sorted()
    got, dplan = densify_workload(w, cfg, 128)
    want, ref = w.preprocess_densified(cfg, tm=128, tk=128, tn=128)
    assert dplan.candidate == ref.candidate == "ksort+rowsort"
    np.testing.assert_array_equal(got.row_remap, want.row_remap)
    for x, y in ((got.a, want.a), (got.b, want.b)):
        np.testing.assert_array_equal(x.indptr, y.indptr)
        np.testing.assert_array_equal(x.indices, y.indices)
    ident, p = densify_workload(w, cfg, 128, DensifyPlan())
    assert ident is w and p.is_identity


# ---- the card's resident blocks, a record ------------------------------------

def test_h100_resident_table_covers_the_planner():
    """The recorded table names the card's SM count and a count for every
    item shape the planner can pick; no config carries it (the term that
    priced from it failed its rule on the card)."""
    assert _TILE_SMS == 132
    for dt in ("float32", "bfloat16"):
        assert not hasattr(h100_config(engine_dtype=dt),
                           "tile_resident_blocks")
        for T in (128, 256, 384, 512):
            for tm in tile_heights(eval_adaptive.bf16_config(None, T), T):
                assert _TILE_RESIDENT[dt][(tm, T)] >= 1
        # tensor-core blocks of 128 rows fill an SM; the thin ones share
        assert _TILE_RESIDENT[dt][(128, 128)] == 1
        assert _TILE_RESIDENT[dt][(8, 128)] == 4


def test_resident_query_needs_a_card():
    """The resident-block query reads the card; without one it raises and
    ``run_resident`` reports nothing measured."""
    import torch

    from spada_tpu_torch.ops.engine import tile_resident_blocks
    from spada_tpu_torch.tools.probe_item_overhead import run_resident

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tile_resident_blocks(8, 128, 128, "float32")
    lines = []
    assert run_resident(device="cpu", log=lines.append) is None
    assert lines == ["resident blocks: not measured (no card)"]
