"""The planner's calibration and evaluation tools of the port
(``spada_tpu_torch.tools``: ``probe_item_overhead``,
``probe_dispatch_crossover``, ``eval_adaptive``, ``bench_value_refresh``)
on the CPU, held to the JAX package and to the reference tools of
``tools/``: the same inputs, the same fit, the same planner decisions, the
same refreshed payloads; and each tool's entry point runs with ``--device
cpu`` at a small size.  On the card the tools are driven by
``chip_smoke.py`` phase 10."""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spada_tpu.io.workloads as ref_workloads
from spada_tpu.models.nn_workloads import make_nn_gemms as ref_make_nn_gemms
from spada_tpu.ops.element import build_esc_plan as ref_build_esc_plan
from spada_tpu.ops.element_stream import (
    build_stream_layout as ref_build_stream_layout,
    stream_operands as ref_stream_operands)
from spada_tpu.plan.planner import choose_tile_size as ref_choose_tile_size
from spada_tpu.sparse.bsr import BsrValueMap as RefValueMap
from spada_tpu.sparse.csr import CsrMatrix as RefCsr
from spada_tpu_torch.config import (_ELEMENT_FIT, _THIN_FIT,
                                    REFERENCE_ELEMENT_FIXED_S,
                                    REFERENCE_TILE_TERMS, SpadaConfig,
                                    datasheet_peaks, element_fit,
                                    fit_element_fixed, fit_item_terms,
                                    h100_config)
from spada_tpu_torch.convert import from_reference as P
from spada_tpu_torch.ops.element import spgemm_element
from spada_tpu_torch.ops.spgemm import (dispatch_dataflow,
                                        estimate_element_time)
from test_torch_card_model import assert_card_tile_side
from spada_tpu_torch.plan.planner import choose_tile_size
from spada_tpu_torch.sparse.bsr import BsrMatrix
from spada_tpu_torch.tools import (bench_value_refresh, eval_adaptive,
                                   harness, probe_dispatch_crossover,
                                   probe_item_overhead)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ref_spgemm = importlib.import_module("spada_tpu.ops.spgemm")


def _reference_tool(name: str):
    """A module of ``tools/`` loaded from its file; its module scope
    imports the standard library and numpy only."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_csr(got, ref):
    for field in ("indptr", "indices", "data"):
        g, r = np.asarray(getattr(got, field)), np.asarray(getattr(ref,
                                                                   field))
        assert g.dtype == r.dtype and np.array_equal(g, r), field
    assert tuple(got.shape) == tuple(ref.shape)


@pytest.mark.parametrize("n,fill,seed", [(4096, 192, 192), (4096, 12, 13),
                                         (1000, 48, 7)])
def test_banded_fill_csr_equals_the_reference_tools(n, fill, seed):
    ref = _reference_tool("probe_dispatch_crossover").banded_fill_csr(
        n, 384, fill, seed)
    _same_csr(probe_dispatch_crossover.banded_fill_csr(n, 384, fill, seed),
              ref)


def _reference_eval_workloads(n):
    """The workload dict of ``tools/eval_adaptive.py``'s ``main``, built
    as it builds it."""
    w = ref_workloads
    f32 = np.float32
    mixed_a = RefCsr.from_scipy(sp.vstack([
        w.banded_csr(n // 2, n, 192, seed=10, dtype=f32).to_scipy(),
        w.localized_powerlaw_csr(n // 2, n, 32.0, window_frac=0.01,
                                 hub_frac=0.02, seed=11,
                                 dtype=f32).to_scipy(),
    ]).tocsr())
    out = {
        "banded": (w.banded_csr(n, n, 192, seed=0, dtype=f32),
                   w.banded_csr(n, n, 192, seed=1, dtype=f32)),
        "loc-powerlaw": (
            w.localized_powerlaw_csr(n, n, 32.0, window_frac=0.01,
                                     hub_frac=0.02, seed=2, dtype=f32),
            w.localized_powerlaw_csr(n, n, 32.0, window_frac=0.01,
                                     hub_frac=0.02, seed=3, dtype=f32)),
        "uni-powerlaw": (w.powerlaw_csr(n, n, 16.0, seed=4, dtype=f32),
                         w.powerlaw_csr(n, n, 16.0, seed=5, dtype=f32)),
        "mixed": (mixed_a, w.localized_powerlaw_csr(
            n, n, 24.0, window_frac=0.01, hub_frac=0.02, seed=12,
            dtype=f32)),
        "banded-offset": (w.banded_offset_csr(n, n, 192, 96, seed=6,
                                              dtype=f32),
                          w.banded_offset_csr(n, n, 192, 96, seed=7,
                                              dtype=f32)),
        "rmat": (w.rmat_csr(n, 12.0, seed=8, dtype=f32),
                 w.rmat_csr(n, 12.0, seed=9, dtype=f32)),
    }
    for label, blk in (("nn-bert-ffn1", None), ("nn-bert-ffn1-blk32", 32)):
        g = ref_make_nn_gemms(density=0.1, structured_block=blk,
                              layers={"bert_ffn1": ((3072, 768), 512)})
        wa, wb = g["bert_ffn1"]
        out[label] = (RefCsr.from_scipy(wa.astype(f32)),
                      RefCsr.from_scipy(wb.astype(f32)))
    return out


def test_eval_workloads_equal_the_reference_generators():
    n = 1024
    got = eval_adaptive.workloads(n)
    ref = _reference_eval_workloads(n)
    fem = ref_workloads.fem_q1_graded_csr(33, 33, dtype=np.float32)
    ref["fem-graded-33"] = (fem, fem)
    assert list(got) == list(ref)
    for name in ref:
        for g, r in zip(got[name], ref[name]):
            _same_csr(g, r)


def test_fem_row_set_sizes():
    """129 elements a side at n = 16384 and 92 at 8192, as the eval runs
    them (16,384 and 8,281 interior nodes)."""
    assert eval_adaptive.fem_edges(16384) == 129
    assert eval_adaptive.fem_edges(8192) == 92
    assert ref_workloads.fem_q1_graded_csr(10, 10).shape == (81, 81)
    assert ref_workloads.fem_q1_graded_csr(129, 129).shape == (16384, 16384)


def test_fit_equals_the_reference_lstsq():
    rng = np.random.default_rng(0)
    pts = {T: float(o) for T, o in zip((128, 256, 384, 512),
                                       rng.uniform(1e-8, 6e-6, 4))}
    acc, fixed, res = probe_item_overhead.fit_overhead(list(pts),
                                                       list(pts.values()))
    # the reference tool's lines, on the same points
    Ts = np.array(list(pts), dtype=np.float64)
    ov = np.array(list(pts.values()), dtype=np.float64)
    A = np.stack([Ts**2, np.ones_like(Ts)], axis=1)
    (r_acc, r_fixed), *_ = np.linalg.lstsq(A, ov, rcond=None)
    assert acc == pytest.approx(r_acc, rel=1e-12)
    assert fixed == pytest.approx(r_fixed, rel=1e-12)
    np.testing.assert_allclose(res, ov - (r_acc * Ts**2 + r_fixed),
                               rtol=1e-12, atol=1e-24)
    # the config takes the same fit with both terms held >= 0
    terms = probe_item_overhead.fitted_terms(pts)
    assert terms["engine_item_overhead_s"] == pts
    assert (terms["engine_acc_s_per_elem"],
            terms["engine_item_fixed_s"]) == fit_item_terms(pts)


@pytest.mark.parametrize("seed", range(6))
def test_non_negative_fit_equals_nnls(seed):
    """``fit_item_terms`` is scipy's non-negative least squares of
    ``acc * T^2 + fixed``, and the reference's lstsq where that is >= 0."""
    from scipy.optimize import nnls

    rng = np.random.default_rng(seed)
    Ts = np.array((128, 256, 384, 512), dtype=np.float64)
    # seeds 0-2: T^3-like growth (lstsq's fixed < 0); 3-5: near-linear
    # points, where lstsq itself is feasible
    ov = (rng.uniform(1e-8, 6e-6) * (Ts / 512) ** 3 if seed < 3
          else rng.uniform(1e-7, 1e-6) + Ts ** 2 * rng.uniform(1e-13, 1e-11))
    ov = ov * rng.uniform(0.8, 1.2, 4)
    pts = dict(zip((128, 256, 384, 512), map(float, ov)))
    A = np.stack([Ts ** 2, np.ones_like(Ts)], axis=1)
    (n_acc, n_fixed), _ = nnls(A, ov)
    acc, fixed = fit_item_terms(pts)
    assert acc >= 0 and fixed >= 0
    assert acc == pytest.approx(n_acc, rel=1e-9, abs=1e-30)
    assert fixed == pytest.approx(n_fixed, rel=1e-9, abs=1e-20)
    (l_acc, l_fixed), *_ = np.linalg.lstsq(A, ov, rcond=None)
    if l_fixed >= 0 and l_acc >= 0:
        assert (acc, fixed) == pytest.approx((l_acc, l_fixed), rel=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_config_fit_rewards_no_thin_item(dtype):
    """The config's per-item cost ``acc * tm * tn + fixed`` is positive at
    every panel height the planner tries, where the lstsq fit of the same
    points is negative below tm * tn of about 27,000.  The recorded thin
    points sit below the estimator's own term at tm <= 32 (f32) and tm <=
    64 (bf16), so their constrained fit, relative to each item's time,
    shows no fixed term on the card."""
    cfg = h100_config(engine_dtype=dtype)
    pts = cfg.engine_item_overhead_s
    assert (cfg.engine_acc_s_per_elem,
            cfg.engine_item_fixed_s) == fit_item_terms(pts)
    l_acc, l_fixed, _ = probe_item_overhead.fit_overhead(list(pts),
                                                         list(pts.values()))
    assert l_fixed < 0
    for tm in cfg.tm_choices:
        assert (cfg.engine_acc_s_per_elem * tm * cfg.tile_n
                + cfg.engine_item_fixed_s) > 0
    assert l_acc * 8 * 128 + l_fixed < 0
    thin = _THIN_FIT[dtype]
    assert sorted(thin) == [(tm, 128) for tm in (8, 16, 32, 64, 128)]
    assert thin[(8, 128)][0] < 0 and thin[(32, 128)][0] < 0
    assert all(s > 0 and s > o for o, s in thin.values())
    fit = probe_item_overhead.union_fit(thin)
    assert (fit["acc"], fit["fixed"]) == fit_item_terms(
        {k: o for k, (o, _) in thin.items()},
        {k: s for k, (_, s) in thin.items()})
    assert fit["fixed"] == 0.0
    assert fit["acc"] == pytest.approx(
        {"float32": 6.6562807e-14, "bfloat16": 0.0}[dtype], rel=1e-7)
    assert fit["acc"] < cfg.engine_acc_s_per_elem
    for k, (o, s, r) in fit["points"].items():
        assert (o, s) == thin[k]
        assert r == pytest.approx(o - (fit["acc"] * k[0] * k[1]
                                       + fit["fixed"]), rel=1e-12, abs=1e-24)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("relative", [False, True])
def test_item_fit_on_panel_shapes_equals_nnls(seed, relative):
    """``fit_item_terms`` on (tm, tn) and T points together is scipy's
    non-negative least squares of the rows (tm * tn, 1), each row over its
    item's time where one is given."""
    from scipy.optimize import nnls

    rng = np.random.default_rng(seed)
    shapes = [128, 256, 384, 512] + [(tm, 128) for tm in (8, 16, 32, 64,
                                                           128)]
    x = np.array([t * t if isinstance(t, int) else t[0] * t[1]
                  for t in shapes], np.float64)
    acc, fixed = rng.uniform(1e-13, 2e-11), rng.uniform(0, 1e-8)
    # odd seeds: overheads below zero on the thinnest items
    ov = acc * x + fixed * (1 if seed % 2 == 0 else -1)
    ov = ov * rng.uniform(0.7, 1.3, len(x))
    item = np.abs(ov) + rng.uniform(5e-9, 5e-8, len(x))
    pts, items = dict(zip(shapes, map(float, ov))), dict(zip(shapes,
                                                             map(float,
                                                                 item)))
    w = 1 / item if relative else np.ones_like(item)
    A = np.stack([x, np.ones_like(x)], axis=1) * w[:, None]
    (n_acc, n_fixed), _ = nnls(A, ov * w)
    got = fit_item_terms(pts, items if relative else None)
    assert got[0] >= 0 and got[1] >= 0
    assert got[0] == pytest.approx(n_acc, rel=1e-7, abs=1e-30)
    assert got[1] == pytest.approx(n_fixed, rel=1e-7, abs=1e-20)
    if not relative:
        # T keys and (T, T) keys are the same points
        sq = {(t, t): pts[t] for t in (128, 256, 384, 512)}
        assert fit_item_terms(sq) == fit_item_terms(
            {t: pts[t] for t in (128, 256, 384, 512)})


def test_element_fixed_term_is_the_fit_of_the_recorded_points():
    """``element_fixed_s`` is ``fit_element_fixed`` of the card's points at
    the datasheet byte rate of the card they were measured on (an H100
    SXM): the weighted mean of t - bytes / hbm with weights 1 / t^2, held
    >= 0; every other card takes that one value until it is measured."""
    cfg = h100_config()
    bw = datasheet_peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"]
    assert bw == cfg.hbm_bytes_per_s == 3.35e12
    assert len(_ELEMENT_FIT) == 12
    assert cfg.element_fixed_s == fit_element_fixed(_ELEMENT_FIT, bw)
    b, t = (np.array(v, np.float64) for v in zip(*_ELEMENT_FIT.values()))
    w = 1 / t ** 2
    want = float(np.sum(w * (t - b / bw)) / np.sum(w))
    assert cfg.element_fixed_s == pytest.approx(want, rel=1e-12)
    for other in ("NVIDIA H100 PCIe", "NVIDIA H200", "NVIDIA H100 NVL"):
        card = h100_config(other)
        assert card.hbm_bytes_per_s != bw
        assert card.element_fixed_s == cfg.element_fixed_s == \
            element_fit()["element_fixed_s"]
    assert 0 < cfg.element_fixed_s < REFERENCE_ELEMENT_FIXED_S
    # points all under their byte term fit no negative time
    assert fit_element_fixed({"x": (1e9, 1e-4)}, 3.35e12) == 0.0
    assert fit_element_fixed({"x": (0, 2e-6), "y": (3.35e6, 3e-6)},
                             3.35e12) == pytest.approx(2e-6, rel=1e-9)


@pytest.mark.parametrize("edges", [92, 129])
def test_card_terms_send_the_graded_fem_to_the_element_side(edges):
    """Under the card's bf16 profile the graded FEM (the eval's --quick and
    full sizes) dispatches to the element side (measured on the card:
    0.009 ms against 0.045 ms for the tile side at 129 edges), where the
    reference's 30 us kept it on tiles."""
    a = P(ref_workloads.fem_q1_graded_csr(edges, edges, dtype=np.float32))
    cfg = eval_adaptive.bf16_config(None)
    choice, det = dispatch_dataflow(a, a, cfg)
    assert choice == "element"
    assert det["tile_T"] == 128
    ref_choice, _ = dispatch_dataflow(a, a, dataclasses.replace(
        cfg, element_fixed_s=REFERENCE_ELEMENT_FIXED_S,
        **REFERENCE_TILE_TERMS))
    assert ref_choice == "tile"


@pytest.mark.parametrize("name,square", [
    ("banded", {64}), ("rmat", {32}), ("loc-powerlaw", {32}),
    ("nn-bert-ffn1", {128}), ("nn-bert-ffn1-blk32", {32, 64})])
def test_card_terms_plan_the_eval_row_sets(name, square):
    """The per-row-group plans the eval's row sets take at n = 8192 (T =
    128) under the card's bf16 terms, fitted on square tiles."""
    from spada_tpu_torch.plan.planner import plan_spgemm

    a, b = eval_adaptive.workloads(8192)[name]
    T, _ = choose_tile_size(a, b, eval_adaptive.bf16_config(None))
    assert T == 128
    plan = plan_spgemm(a, b, eval_adaptive.bf16_config(None, T))
    assert set(plan.tm_histogram()) == square


def test_card_terms_keep_the_nn_plan():
    """The nn pair's dense rows make W about proportional to 1 / tm, so
    acc cancels between heights and the byte term keeps one tm-128
    segment at T = 128 under the card's f32 terms (a cut of the bench's
    pair: 4096^2 weight, 384-blocks at density 0.2, times 4096 x 1024
    ReLU activations)."""
    from spada_tpu_torch.plan.planner import plan_spgemm

    a = P(ref_workloads.block_sparse_csr(4096, 4096, 384, 0.2, seed=5,
                                         dtype=np.float32))
    b = P(ref_workloads.relu_activation_csr(4096, 1024, 0.35, seed=6,
                                            dtype=np.float32))
    cfg = h100_config()
    choice, det = dispatch_dataflow(a, b, cfg)
    assert choice == "tile" and det["tile_T"] == 128
    plan = plan_spgemm(a, b, cfg)
    assert plan.tm_histogram() == {128: 4096}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fitted_terms_make_the_model_reproduce_the_measurement(dtype):
    """The overhead is (elapsed - the model's own term) / W, so under the
    fitted dict ``choose_tile_size``'s t_est is the measured time, in the
    port and in the reference."""
    a = P(ref_workloads.banded_csr(1024, 1024, 100, seed=0,
                                   dtype=np.float32))
    b = P(ref_workloads.banded_csr(1024, 1024, 100, seed=1,
                                   dtype=np.float32))
    cfg = h100_config(engine_dtype=dtype)
    model = probe_item_overhead.model_terms(a, b, cfg)
    rng = np.random.default_rng(1)
    measured = {T: m + W * float(rng.uniform(1e-8, 5e-6))
                for T, (W, m) in model.items()}
    pts = {T: (measured[T] - m) / W for T, (W, m) in model.items()}
    fitted = dataclasses.replace(
        cfg, **probe_item_overhead.fitted_terms(pts))
    _, det = choose_tile_size(a, b, fitted)
    _, ref_det = ref_choose_tile_size(a, b, fitted)
    for T, m in measured.items():
        assert det[T]["t_est"] == pytest.approx(m, rel=1e-12)
        assert ref_det[T] == det[T]


def test_crossover_configs():
    """The crossover models dispatch under the reference's per-item terms
    and under the card's fit, both on bf16 tiles."""
    cfgs = probe_dispatch_crossover.configs(None)
    base = SpadaConfig()
    for f in harness.ITEM_TERMS:
        assert getattr(cfgs["v5e"], f) == getattr(base, f)
        assert getattr(cfgs["fit"], f) == getattr(
            h100_config(engine_dtype="bfloat16"), f)
    assert {c.engine_dtype for c in cfgs.values()} == {"bfloat16"}
    assert cfgs["v5e"].hbm_bytes_per_s == cfgs["fit"].hbm_bytes_per_s
    # the element model: the reference's 30 us, and the card's fit
    assert cfgs["v5e"].element_fixed_s == REFERENCE_ELEMENT_FIXED_S
    assert cfgs["fit"].element_fixed_s == h100_config().element_fixed_s


@pytest.mark.parametrize("fill", [96, 24, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_under_the_fit_equals_reference(fill, dtype):
    """Under ``h100_config`` with the card's fit, both packages take the
    same tile/element decision and tile edge, with the same details."""
    n = 4096
    a = probe_dispatch_crossover.banded_fill_csr(n, 384, fill, seed=fill)
    b = probe_dispatch_crossover.banded_fill_csr(n, 384, fill,
                                                 seed=fill + 1)
    ra = _reference_tool("probe_dispatch_crossover").banded_fill_csr(
        n, 384, fill, seed=fill)
    rb = _reference_tool("probe_dispatch_crossover").banded_fill_csr(
        n, 384, fill, seed=fill + 1)
    cfg = h100_config(engine_dtype=dtype)
    # the reference's schema: the card's per-item fit, its own element term
    ref_cfg = SpadaConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(SpadaConfig)})
    choice, det = dispatch_dataflow(a, b, ref_cfg)
    r_choice, r_det = ref_spgemm.dispatch_dataflow(ra, rb, ref_cfg)
    assert choice == r_choice
    assert det == r_det
    assert choose_tile_size(a, b, cfg) == ref_choose_tile_size(ra, rb,
                                                                ref_cfg)
    # under the card's profile the tile side is the card's model, and the
    # element side charges the card's fixed time
    card_choice, card_det = dispatch_dataflow(a, b, cfg)
    assert_card_tile_side(a, b, cfg, card_det)
    t_tile = min(v["t_est"] for v in card_det["tile"].values())
    assert card_det["element"] == estimate_element_time(a, b, cfg, t_tile)
    assert card_choice == ("element" if card_det["element"]["t_est"]
                           < t_tile else "tile")


def _nn_pair(scale=32):
    n = 16384 // scale
    a = ref_workloads.block_sparse_csr(n, n, 128, 0.2, seed=5,
                                       dtype=np.float32)
    b = ref_workloads.relu_activation_csr(n, 4096 // scale, 0.35, seed=6,
                                          dtype=np.float32)
    return a, b


def test_tile_refresh_equals_rebuild_reference_and_scipy():
    ra, rb = _nn_pair()
    a, b = P(ra), P(rb)
    T = 128
    loop = bench_value_refresh.TileRefresh(a, b, T, torch.device("cpu"),
                                           torch.float32)
    rng = np.random.default_rng(3)
    new_a = rng.standard_normal(a.nnz).astype(np.float32)
    new_b = np.abs(rng.standard_normal(b.nnz)).astype(np.float32)
    at, bt = loop.fill(new_a, new_b)
    a2 = bench_value_refresh.refreshed(a, new_a)
    b2 = bench_value_refresh.refreshed(b, new_b)
    for got, m, new, rm in ((at, a2, new_a, ra), (bt, b2, new_b, rb)):
        assert np.array_equal(got, BsrMatrix.from_csr(m, T, T).tiles)
        assert np.array_equal(got,
                              RefValueMap.from_structure(rm, T, T).fill(new))
    loop.upload(at, bt)
    c = loop.launch()
    got = loop.first_rows(c, (a.shape[0], b.shape[1]), a.shape[0])
    ref = (a2.to_scipy().astype(np.float64) @ b2.to_scipy()).tocsr()
    assert harness.gate(got, ref, 1e-5, "refresh") <= 1e-5


def test_element_refresh_gathers_the_reference_operands():
    m = 512
    ra = ref_workloads.localized_powerlaw_csr(m, m, 16.0, seed=1,
                                              dtype=np.float32)
    rb = ref_workloads.localized_powerlaw_csr(m, m, 16.0, seed=2,
                                              dtype=np.float32)
    a, b = P(ra), P(rb)
    loop = bench_value_refresh.ElementRefresh(a, b, torch.device("cpu"))
    rng = np.random.default_rng(4)
    new_a = rng.standard_normal(a.nnz).astype(np.float32)
    new_b = rng.standard_normal(b.nnz).astype(np.float32)
    host = loop.gather(new_a, new_b)
    r_plan = ref_build_esc_plan(ra, rb)
    r_ops = ref_stream_operands(
        ref_build_stream_layout(r_plan), r_plan,
        RefCsr(ra.shape, ra.indptr, ra.indices, new_a),
        RefCsr(rb.shape, rb.indptr, rb.indices, new_b))
    assert len(host) == len(r_ops)
    for (ga, gb), (xa, xb) in zip(host, r_ops):
        assert np.array_equal(ga, xa) and np.array_equal(gb, xb)
    loop.upload(host)
    got = loop.to_csr(loop.launch())
    ref = (bench_value_refresh.refreshed(a, new_a).to_scipy().astype(
        np.float64) @ bench_value_refresh.refreshed(b, new_b).to_scipy())
    assert harness.gate(got, ref, 1e-5, "element refresh") <= 1e-5


def test_tile_rows_and_gate():
    """``tile_rows`` puts tiles where their bases say, adds overlaps, and
    ``gate`` raises above its limit."""
    tiles = np.arange(2 * 2 * 3, dtype=np.float32).reshape(2, 2, 3) + 1
    got = harness.tile_rows(tiles, [0, 1], [1, 0], 2, 3, (5, 6), 4,
                            bases=[0, 1]).toarray()
    want = np.zeros((4, 6))
    want[0:2, 3:6] += tiles[0]
    want[1:3, 0:3] += tiles[1]
    np.testing.assert_array_equal(got, want)
    ref = sp.csr_matrix(want)
    assert harness.gate(sp.csr_matrix(want), ref, 0.0, "same") == 0.0
    with pytest.raises(RuntimeError, match="limit"):
        harness.gate(sp.csr_matrix(want * 1.01), ref, 1e-3, "off")


def test_element_entry_slabs_equal_one_plan():
    """Above ``max_slab_products`` the element entry runs row slabs, as
    ``spgemm_element`` does, and gives the same C."""
    m = 256
    a = P(ref_workloads.localized_powerlaw_csr(m, m, 8.0, seed=1,
                                               dtype=np.float32))
    b = P(ref_workloads.localized_powerlaw_csr(m, m, 8.0, seed=2,
                                               dtype=np.float32))
    dev = torch.device("cpu")
    one_calls, one = harness.element_entry(a, b, dev)
    calls, slabs = harness.element_entry(a, b, dev, max_slab_products=2000)
    assert len(one_calls) == 1 and len(calls) >= 3
    ref = (a.to_scipy().astype(np.float64) @ b.to_scipy()).tocsr()
    assert harness.gate(one, ref, 1e-6, "one plan") <= 1e-6
    assert harness.gate(slabs, ref, 1e-6, "slabs") <= 1e-6
    # the same C as spgemm_element's, one plan or the same row slabs
    for got, kw in ((one, {}), (slabs, {"max_slab_products": 2000})):
        want = spgemm_element(a, b, "cpu", backend="auto", **kw).to_csr()
        assert harness.gate(got, want.to_scipy(), 0.0, "entry") == 0.0


@pytest.mark.parametrize("tool", ["probe_item_overhead",
                                  "probe_dispatch_crossover",
                                  "eval_adaptive", "bench_value_refresh",
                                  "probe_op", "eval_scaling"])
def test_tools_need_a_card_unless_told_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"spada_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])


@pytest.mark.parametrize("argv,expect", [
    (["probe_item_overhead", "--n", "1024", "--band", "64"],
     "overhead not timed"),
    (["probe_item_overhead", "--thin", "--n", "1024", "--thin-n", "1024",
      "--band", "64"], "| bfloat16 | 128 | mma | tile_spgemm |"),
    (["probe_item_overhead", "--latency", "--items", "--thin-n", "1024",
      "--band", "64"], "bfloat16 128 x 128: W="),
    (["probe_dispatch_crossover", "--n", "1024", "--fills", "48,12"],
     "| verdict |"),
    (["probe_dispatch_crossover", "--element-fit", "--fills", "48,12"],
     "| fem-graded-33 |"),
    (["probe_item_overhead", "--waves"], "bfloat16  64 x 256"),
    (["eval_adaptive", "--n", "512"], "## fem-graded-24"),
    (["eval_adaptive", "--n", "512"],
     "nn-bert-ffn1-blk32 densify: the card's scorer picks identity"),
    (["eval_adaptive", "--n", "512", "--element", "dispatched"],
     "element not timed ms: -"),
    (["bench_value_refresh", "--scale", "32"], "element cold build"),
])
def test_tool_entry_points_on_cpu(argv, expect):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-m", f"spada_tpu_torch.tools.{argv[0]}",
         "--device", "cpu", *argv[1:]],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
