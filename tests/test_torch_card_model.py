"""The tile side's card model (``spada_tpu_torch.plan.card_model``).

In the reference's form (``config.REFERENCE_TILE_TERMS``) its planner and
tile-edge choice are the JAX package's ``plan_spgemm`` and
``choose_tile_size``: the same panels, the same T, the same costs to 1e-12.
With the card's terms set, built cases show each term: one block's run of
items, the launch each plan segment pays, and the L2 reuse of B tiles.
"""

import dataclasses

import numpy as np
import pytest

from spada_tpu.config import SpadaConfig as RefConfig
from spada_tpu.plan.estimator import BTileStructure as RefBTiles
from spada_tpu.plan.estimator import panel_cost_model
from spada_tpu.plan.planner import choose_tile_size, plan_spgemm
from spada_tpu.sparse.csr import CsrMatrix as RefCsr
from spada_tpu_torch.config import (_TILE_FIT_SOURCE, _TILE_ITEM,
                                    _TILE_LATENCY, REFERENCE_TILE_TERMS,
                                    CardConfig, card_config, h100_config,
                                    tile_terms)
from spada_tpu_torch.convert import from_reference as P
from spada_tpu_torch.plan.card_model import (block_pieces, card_plan_cost,
                                             card_span_cost, card_tile_size,
                                             plan_spgemm_card, planner_for,
                                             shape_time)
from spada_tpu_torch.plan.estimator import BTileStructure
from spada_tpu_torch.plan.planner import choose_tile_size as port_choose
from spada_tpu_torch.plan.planner import plan_spgemm as port_plan
from spada_tpu_torch.sparse.csr import CsrMatrix
from spada_tpu_torch.tools import eval_adaptive
from test_fuzz import _random_case

DTYPES = ("float32", "bfloat16")
#: the eval's workloads at the size the parity cases take
EVAL_N = 1024


def _reference_form(dtype: str) -> CardConfig:
    return h100_config(engine_dtype=dtype, **REFERENCE_TILE_TERMS)


def _ref_config(cfg) -> RefConfig:
    return RefConfig(**{f.name: getattr(cfg, f.name)
                        for f in dataclasses.fields(RefConfig)})


def _ref_csr(m: CsrMatrix) -> RefCsr:
    return RefCsr(m.shape, m.indptr, m.indices, m.data)


@pytest.fixture(scope="module")
def eval_pairs():
    return eval_adaptive.workloads(EVAL_N)


def _case(name, cari_workload, eval_pairs):
    if name == "cari":
        return cari_workload.a, cari_workload.b
    a, b = eval_pairs[name]
    return _ref_csr(a), _ref_csr(b)


def _close(got, want):
    assert got == pytest.approx(want, rel=1e-12, abs=1e-30)


def _same_plan(got, ref):
    assert [(p.row_start, p.row_end, p.tm) for p in got.panels] == \
        [(p.row_start, p.row_end, p.tm) for p in ref.panels]
    assert (got.tile_k, got.tile_n) == (ref.tile_k, ref.tile_n)
    assert got.meta["n_groups"] == ref.meta["n_groups"]
    assert len(got.meta["group_costs"]) == len(ref.meta["group_costs"])
    for g, r in zip(got.meta["group_costs"], ref.meta["group_costs"]):
        assert g.keys() == r.keys()
        for tm in r:
            _close(g[tm], r[tm])


def _check_parity(a, b, dtype):
    cfg = _reference_form(dtype)
    ref_cfg = _ref_config(cfg)
    pa, pb = P(a), P(b)
    T, det = card_tile_size(pa, pb, cfg)
    r_T, r_det = choose_tile_size(a, b, ref_cfg)
    assert T == r_T and det.keys() == r_det.keys()
    for t in r_det:
        assert det[t]["W"] == r_det[t]["W"]
        assert det[t]["bytes"] == r_det[t]["bytes"]
        _close(det[t]["t_est"], r_det[t]["t_est"])
    got = plan_spgemm_card(pa, pb, cfg)
    ref = plan_spgemm(a, b, ref_cfg)
    _same_plan(got, ref)
    # the plan's t_est in the reference's form: the reference's estimator
    # summed over the plan's panels
    bt = RefBTiles(b, cfg.tile_k, cfg.tile_n)
    isz = 2 if dtype == "bfloat16" else 4
    want = sum(panel_cost_model(a, p.row_start, p.row_end, p.tm, bt,
                                itemsize=isz, config=ref_cfg)["cost"]
               for p in ref.panels)
    _close(got.meta["t_est"], want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", [
    "cari", "banded", "loc-powerlaw", "uni-powerlaw", "mixed",
    "banded-offset", "rmat", "nn-bert-ffn1", "nn-bert-ffn1-blk32",
    f"fem-graded-{eval_adaptive.fem_edges(EVAL_N)}"])
def test_reference_form_plans_as_the_reference(cari_workload, eval_pairs,
                                               name, dtype):
    """(a) cari and the eval's workloads at n = 1024: under the reference's
    form the card's planner and tile edge are the JAX package's."""
    _check_parity(*_case(name, cari_workload, eval_pairs), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", range(20))
def test_reference_form_plans_fuzz_cases_as_the_reference(seed, dtype):
    """(a) ``tests/test_fuzz.py``'s random cases, seeds 0-19."""
    _, a, b = _random_case(seed)
    _check_parity(a, b, dtype)


@pytest.mark.parametrize("tm", [8, 32, 128])
def test_reference_form_span_is_panel_cost_model(cari_workload, tm):
    """In the reference's form a span's cost, work, C tiles, bytes and
    flops are ``panel_cost_model``'s, bit for bit."""
    a, b = cari_workload.a, cari_workload.b
    cfg = _reference_form("float32")
    got = card_span_cost(P(a), 0, a.shape[0], tm, BTileStructure(P(b)),
                         4, cfg)
    want = panel_cost_model(a, 0, a.shape[0], tm, RefBTiles(b), 4,
                            _ref_config(cfg))
    for k, v in want.items():
        assert got[k] == v, k


def _terms(**over) -> CardConfig:
    """A card config with round terms: items 10 ns, one block's item 1 us,
    at every tm of T = 128."""
    base = dict(tile_item_s=tuple((tm, 128, 1e-8) for tm in (8, 16, 32, 64,
                                                             128)),
                tile_item_latency_s=tuple((tm, 128, 1e-6)
                                          for tm in (8, 16, 32, 64, 128)),
                tile_l2_bytes_per_s=0.0, tile_l2_bytes=0, tile_launch_s=0.0)
    return CardConfig(**{**base, **over})


def _csr(shape, rows, cols) -> CsrMatrix:
    rows, cols = np.asarray(rows), np.asarray(cols)
    return CsrMatrix.from_coo(shape, rows, cols,
                              np.ones(len(rows), np.float32))


def test_one_run_costs_its_latency():
    """(b) One C tile with a run of k items costs k one-block latencies;
    200 C tiles of one item each cost W times the throughput time."""
    T, tm, k = 128, 32, 12
    a = _csr((tm, k * T), [0] * k, np.arange(k) * T)
    b = _csr((k * T, T), np.arange(k) * T, [0] * k)
    cfg = _terms()
    sp = card_span_cost(a, 0, tm, tm, BTileStructure(b, T, T), 4, cfg)
    assert (sp["work"], sp["c_tiles"], sp["longest"]) == (k, 1, k)
    assert sp["blocks"] == block_pieces(tm, T, T, 4) == 1
    # the throughput term: the items, then the C tile's f32 write
    c_write = tm * T * 4 / cfg.hbm_bytes_per_s
    assert sp["t_lat"] == k * 1e-6 and sp["t_thr"] == k * 1e-8 + c_write
    assert sp["cost"] == k * 1e-6
    assert card_plan_cost([sp], cfg) == (k * 1e-6, {tm: k * 1e-6})
    n = 200
    a = _csr((n * tm, T), np.arange(n) * tm, [0] * n)
    b = _csr((T, T), [0], [0])
    sp = card_span_cost(a, 0, n * tm, tm, BTileStructure(b, T, T), 4,
                        _terms(tile_item_s=((tm, T, 1e-6),),
                               tile_item_latency_s=((tm, T, 1e-5),)))
    assert (sp["work"], sp["c_tiles"], sp["longest"]) == (n, n, 1)
    assert sp["t_lat"] == 1e-5
    assert sp["cost"] == sp["t_thr"] == n * 1e-6 + n * c_write > \
        sp["t_bytes"]


def test_two_heights_pay_two_launches():
    """(c) A plan of two panel heights pays two launches; with a launch
    that costs more than the mixed plan saves, the uniform check takes
    one height, as blk32 needs.  The pair is the eval's
    nn-bert-ffn1-blk32, whose reference plan mixes heights."""
    a, b = eval_adaptive.workloads(EVAL_N)["nn-bert-ffn1-blk32"]
    cfg = _reference_form("bfloat16")
    mixed = plan_spgemm_card(a, b, cfg)
    assert len(mixed.meta["segments"]) >= 2
    launch = 1e-3
    with_launch = dataclasses.replace(cfg, tile_launch_s=launch)
    bt = BTileStructure(b, cfg.tile_k, cfg.tile_n)
    spans = [card_span_cost(a, p.row_start, p.row_end, p.tm, bt, 2, cfg)
             for p in mixed.panels]
    t0, seg0 = card_plan_cost(spans, cfg)
    t1, seg1 = card_plan_cost(spans, with_launch)
    assert seg1.keys() == seg0.keys()
    _close(t1, t0 + launch * len(seg0))
    uniform = plan_spgemm_card(a, b, with_launch)
    assert len(uniform.panels) == 1
    assert uniform.panels[0].row_start == 0
    assert uniform.panels[0].row_end == a.shape[0]
    assert len(uniform.meta["segments"]) == 1
    assert uniform.meta["t_est"] < t1
    # at no launch the card's planner keeps the reference's mixed plan
    assert [(p.row_start, p.row_end, p.tm) for p in mixed.panels] == \
        [(p.row_start, p.row_end, p.tm) for p in port_plan(a, b, cfg).panels]


def test_l2_reuse_of_b_tiles():
    """(d) Many panels reading one B tile read it once from HBM and again
    from L2; when L2 cannot hold the reads between two uses every read
    comes from HBM, as in the reference's byte term; a B tile read again
    only far down the rows comes from HBM again, while its neighbours'
    reuse stays in L2."""
    T, tm, n = 128, 16, 64
    a = _csr((n * tm, T), np.arange(n) * tm, [0] * n)
    b = _csr((T, T), [0], [0])
    bt = BTileStructure(b, T, T)
    a_b, b_b, c_b = tm * T * 4, T * T * 4, tm * T * 4
    rate = 10e12
    cfg = _terms(tile_l2_bytes_per_s=rate, tile_l2_bytes=50 << 20)
    sp = card_span_cost(a, 0, n * tm, tm, bt, 4, cfg)
    assert (sp["work"], sp["a_unique"], sp["b_unique"]) == (n, n, 1)
    assert sp["hbm_bytes"] == n * a_b + b_b + n * c_b
    assert sp["l2_bytes"] == (n - 1) * b_b
    assert sp["t_bytes"] == pytest.approx(
        sp["hbm_bytes"] / cfg.hbm_bytes_per_s + (n - 1) * b_b / rate,
        rel=1e-12)
    # no L2 room: each item's B tile from HBM again
    small = _terms(tile_l2_bytes_per_s=rate, tile_l2_bytes=0)
    sp = card_span_cost(a, 0, n * tm, tm, bt, 4, small)
    assert sp["l2_bytes"] == 0.0
    assert sp["hbm_bytes"] == sp["bytes"] == n * (a_b + b_b) + n * c_b
    # B tile 0 read by panels 0..31 (one panel apart), B tile 1 by panels
    # 0 and 63 alone: with L2 holding about 8 panels' reads only tile 0's
    # re-reads are hits
    rows = list(np.arange(32) * tm) + [0, 63 * tm]
    cols = [0] * 32 + [T, T]
    a = _csr((n * tm, 2 * T), rows, cols)
    b = _csr((2 * T, T), [0, T], [0, 0])
    bt = BTileStructure(b, T, T)
    sp0 = card_span_cost(a, 0, n * tm, tm, bt, 4, cfg)
    per_panel = (sp0["work"] * b_b + sp0["a_unique"] * a_b) / 33
    mid = _terms(tile_l2_bytes_per_s=rate, tile_l2_bytes=int(8 * per_panel))
    sp = card_span_cost(a, 0, n * tm, tm, bt, 4, mid)
    assert (sp["work"], sp["b_unique"]) == (34, 2)
    assert sp["l2_bytes"] == 31 * b_b
    assert sp["hbm_bytes"] == sp["a_unique"] * a_b + 3 * b_b + \
        sp["c_tiles"] * c_b
    assert sp0["l2_bytes"] == 32 * b_b


def test_h100_tables_name_their_card():
    """(e) ``h100_config``'s tile terms come from tables that carry the
    card's name, its power limit, the date and the tool, and cover every
    item shape the planner can pick at T = 128..512."""
    assert _TILE_FIT_SOURCE["card"] == "NVIDIA H100 80GB HBM3"
    assert _TILE_FIT_SOURCE["power_limit"] == "700.00 W"
    assert _TILE_FIT_SOURCE["date"] and "probe_item_overhead" in \
        _TILE_FIT_SOURCE["tool"]
    from spada_tpu_torch.tools.probe_item_overhead import card_shapes

    for dt in DTYPES:
        cfg = h100_config(engine_dtype=dt)
        assert {k: getattr(cfg, k) for k in REFERENCE_TILE_TERMS} == \
            tile_terms(dt)
        for table in (_TILE_ITEM[dt], _TILE_LATENCY[dt]):
            assert set(card_shapes()) <= set(table)
            assert all(s > 0 for s in table.values())
        for tm, T in card_shapes():
            assert shape_time(cfg.tile_item_s, tm, T, T) == \
                _TILE_ITEM[dt][(tm, T)]
        assert cfg.tile_launch_s > 0 and cfg.tile_l2_bytes_per_s > 0
        assert cfg.tile_l2_bytes > 0


def assert_card_tile_side(a, b, cfg, det):
    """``dispatch_dataflow``'s tile side under a card config: each tile
    edge ``card_tile_size`` prices in full is its entry; the others are
    bounds at least the element side's worst case and at most the full
    price, so the choice is the one the full prices give."""
    from spada_tpu_torch.ops.element import expansion_products
    from spada_tpu_torch.ops.spgemm import element_bounds

    T, full = card_tile_size(a, b, cfg)
    worst = element_bounds(expansion_products(a, b), cfg)[1]
    for t, v in det["tile"].items():
        if v.get("bound"):
            assert worst <= v["t_est"] <= full[t]["t_est"]
            assert full[t]["t_est"] > det["element"]["t_est"]
        else:
            assert v == full[t]
    if not any(v.get("bound") for v in det["tile"].values()):
        assert det["tile_T"] == T


def test_dispatch_prices_the_tile_side_only_as_needed():
    """On a scattered pair the element side's worst case is below every
    tile edge's items alone: dispatch bounds the tile side there, and
    chooses what the full prices choose."""
    from spada_tpu_torch.io.workloads import localized_powerlaw_csr
    from spada_tpu_torch.ops.spgemm import dispatch_dataflow

    a = localized_powerlaw_csr(2048, 2048, 32.0, seed=1, dtype=np.float32)
    b = localized_powerlaw_csr(2048, 2048, 32.0, seed=2, dtype=np.float32)
    for dt in DTYPES:
        cfg = h100_config(engine_dtype=dt)
        choice, det = dispatch_dataflow(a, b, cfg)
        assert choice == "element"
        assert all(v.get("bound") for v in det["tile"].values())
        assert_card_tile_side(a, b, cfg, det)


def test_planner_for_resolves_by_config_kind():
    """The card's pair under a ``CardConfig``, the copies under a
    ``SpadaConfig``; ``card_config`` carries the card's terms."""
    from spada_tpu_torch.config import SpadaConfig

    assert planner_for(h100_config()) == (card_tile_size, plan_spgemm_card)
    assert planner_for(SpadaConfig()) == (port_choose, port_plan)
    card = card_config(SpadaConfig(engine_dtype="bfloat16"))
    assert {k: getattr(card, k) for k in REFERENCE_TILE_TERMS} == \
        tile_terms("bfloat16")


def test_tables_round_trip_through_json(tmp_path):
    """A ``CardConfig``'s tables come back from JSON as tuples."""
    cfg = h100_config()
    path = str(tmp_path / "card.json")
    cfg.to_json(path)
    got = CardConfig.from_json(path)
    for k in REFERENCE_TILE_TERMS:
        assert getattr(got, k) == getattr(cfg, k), k
