"""The port's slice as a whole against the JAX package and scipy.

``spgemm(dataflow='spada', device='cpu')`` must take the same tile/element
dispatch decision as ``spada_tpu.ops.spgemm.dispatch_dataflow`` under the
same config and give the same C as ``spada_tpu``'s ``spgemm`` on the CPU
and as scipy, to 1e-4 (f32 products summed in another order).  The config
is the port's H100 profile.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from spada_tpu.config import SpadaConfig
from spada_tpu.io.workloads import (block_sparse_csr, localized_powerlaw_csr,
                                    powerlaw_csr, random_csr,
                                    relu_activation_csr)
from spada_tpu.plan.planner import choose_tile_size, plan_spgemm
from spada_tpu.plan.planner import execute_plan as jax_execute_plan
from spada_tpu_torch.convert import from_reference as P
from spada_tpu_torch import cli
from spada_tpu_torch.config import (REFERENCE_ELEMENT_FIXED_S,
                                    REFERENCE_TILE_TERMS, CardConfig,
                                    SpadaConfig as PortConfig, card_config,
                                    datasheet_peaks, h100_config)
from spada_tpu_torch.ops.spgemm import (_peak_flops, dispatch_dataflow,
                                        element_plan_bytes,
                                        estimate_element_time,
                                        measure_device_perf, spgemm,
                                        spgemm_csr)
from test_torch_card_model import assert_card_tile_side
from spada_tpu_torch.plan.execute import execute_plan, make_profiled_measure
from spada_tpu_torch.plan.planner import plan_spgemm as port_plan_spgemm
from test_fuzz import _random_case

# the module, not the function spada_tpu.ops re-exports under its name
jax_spgemm_mod = importlib.import_module("spada_tpu.ops.spgemm")


def _pairs(cari_workload):
    return {
        "cari": (cari_workload.a, cari_workload.b, "tile"),
        "locpl": (localized_powerlaw_csr(2048, 2048, 16.0, seed=1,
                                         dtype=np.float32),
                  localized_powerlaw_csr(2048, 2048, 16.0, seed=2,
                                         dtype=np.float32), "element"),
        "nn": (block_sparse_csr(1536, 1536, 384, 0.2, seed=5),
               relu_activation_csr(1536, 512, 0.35, seed=6), "tile"),
    }


def _reference_kind(cfg):
    """``cfg``'s fields of the reference's schema, as a ``SpadaConfig``:
    the card's peaks and per-item fit, the reference's element model."""
    return PortConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


def _oracle(a, b):
    return np.asarray((a.to_scipy() @ b.to_scipy()).todense())


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("name", ["cari", "locpl", "nn"])
def test_spada_slice_matches_reference_and_scipy(cari_workload, name):
    a, b, route = _pairs(cari_workload)[name]
    # the card's profile; the reference prices both sides with its own
    # models, so it takes the profile's fields of its schema.  Under the
    # card's profile the tile side is the card's model
    cfg, ref_cfg = h100_config(), _reference_kind(h100_config())
    choice, det = dispatch_dataflow(P(a), P(b), cfg)
    ref_choice, ref_det = jax_spgemm_mod.dispatch_dataflow(a, b, ref_cfg)
    assert choice == ref_choice == route
    assert_card_tile_side(P(a), P(b), cfg, det)
    assert dispatch_dataflow(P(a), P(b), ref_cfg)[1] == ref_det

    res = spgemm(P(a), P(b), cfg, dataflow="spada", device="cpu")
    ref = jax_spgemm_mod.spgemm(a, b, ref_cfg, dataflow="spada")
    assert res.engine_used == ref.engine_used == route
    got = res.todense()
    _close(got, ref.todense())
    _close(got, _oracle(a, b))
    assert res.useful_flops == ref.useful_flops


@pytest.mark.parametrize("name", ["cari", "nn"])
def test_plan_path_matches_reference(cari_workload, name):
    a, b, _ = _pairs(cari_workload)[name]
    cfg = h100_config()
    t, _ = choose_tile_size(a, b, cfg)
    cfg.tile_k = cfg.tile_n = cfg.default_tm = t
    cfg.tm_choices = tuple(x for x in cfg.tm_choices if x <= t) + (t,)
    plan = plan_spgemm(a, b, cfg)
    got = execute_plan(P(a), P(b), P(plan), cfg, device="cpu")
    ref = jax_execute_plan(a, b, plan, cfg)
    assert got.n_work_items == ref.n_work_items
    assert got.mxu_flops == ref.mxu_flops
    assert [s.tm for s in got.segments] == [s.tm for s in ref.segments]
    _close(got.todense(), ref.todense())
    _close(got.todense(), _oracle(a, b))
    # the result round-trips through the spgemm entry point too
    via = spgemm(P(a), P(b), cfg, dataflow="spada", plan=P(plan),
                 device="cpu")
    np.testing.assert_array_equal(via.todense(), got.todense())


@pytest.mark.parametrize("dataflow", ["ip", "op", "rowwise", "element"])
def test_other_dataflows_match_reference(cari_workload, dataflow):
    # cari expands to ~19M scalar products: the element case takes locpl
    name = "locpl" if dataflow == "element" else "cari"
    a, b, _ = _pairs(cari_workload)[name]
    cfg = h100_config()
    res = spgemm(P(a), P(b), cfg, dataflow=dataflow, device="cpu")
    ref = jax_spgemm_mod.spgemm(a, b, cfg, dataflow=dataflow)
    assert (res.tm, res.n_work_items) == (ref.tm, ref.n_work_items)
    _close(res.todense(), ref.todense())


def test_bf16_tiles_close_to_scipy(cari_workload):
    a, b = cari_workload.a, cari_workload.b
    cfg = h100_config(engine_dtype="bfloat16", precision="default")
    res = spgemm(P(a), P(b), cfg, dataflow="rowwise", device="cpu")
    ref = jax_spgemm_mod.spgemm(a, b, cfg, dataflow="rowwise")
    assert res.tile_itemsize == 2
    _close(res.todense(), ref.todense())
    np.testing.assert_allclose(res.todense(), _oracle(a, b), rtol=0.05,
                               atol=0.5)


def test_cost_models_match_reference(cari_workload):
    a, b, _ = _pairs(cari_workload)["locpl"]
    # a config of the reference's kind: the reference's 30 us
    cfg = PortConfig(**datasheet_peaks())
    assert (element_plan_bytes(P(a), P(b))
            == jax_spgemm_mod.element_plan_bytes(a, b))
    for tile_t in (None, 1e-5, 1e-3):
        assert (estimate_element_time(P(a), P(b), cfg, tile_t)
                == jax_spgemm_mod.estimate_element_time(a, b, cfg, tile_t))


@pytest.mark.parametrize("name", ["cari", "locpl"])
@pytest.mark.parametrize("tile_t", [None, 1e-5, 1e-3])
def test_card_config_charges_its_element_fixed_time(cari_workload, name,
                                                    tile_t):
    """Under a card config the element model charges ``element_fixed_s``
    where the reference charges 30 us, and nothing else changes; a
    ``CardConfig`` left at its default prices what the reference does."""
    a, b, _ = _pairs(cari_workload)[name]
    card = h100_config()
    ref_kind = _reference_kind(card)
    assert card.element_fixed_s != REFERENCE_ELEMENT_FIXED_S
    default = CardConfig(**dataclasses.asdict(ref_kind))
    assert default.element_fixed_s == REFERENCE_ELEMENT_FIXED_S == 30e-6
    want = jax_spgemm_mod.estimate_element_time(a, b, ref_kind, tile_t)
    assert estimate_element_time(P(a), P(b), default, tile_t) == want
    got = estimate_element_time(P(a), P(b), card, tile_t)
    assert got["e_products"] == want["e_products"]
    if got["bytes_model"] == want["bytes_model"]:
        assert got["t_est"] == pytest.approx(
            want["t_est"] - REFERENCE_ELEMENT_FIXED_S + card.element_fixed_s,
            rel=1e-12)
    empty = P(random_csr(64, 64, 0.0, seed=0))
    assert estimate_element_time(empty, empty, card)["t_est"] == \
        card.element_fixed_s


def test_run_spada_routes_and_matches_scipy(cari_workload):
    pairs = _pairs(cari_workload)
    for name in ("locpl", "nn"):
        a, b, route = pairs[name]
        lines = []
        run = cli.run_spada(P(a), P(b), h100_config(), "cpu",
                            log=lines.append)
        assert run.choice == route
        _close(run.result.todense(), _oracle(a, b))
        if route == "tile":
            assert run.plan is not None
            assert run.config.tile_k == run.dispatch["tile_T"]
            assert any(line.startswith("tile size:") for line in lines)
        else:
            assert lines[0].startswith("dataflow dispatch: element")


def test_cli_run_on_cpu(capsys):
    rc = cli.main(["run", "spada", "SS", "cari", "config/default.json",
                   "--device", "cpu", "--no-result"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "tile size:" in out and "backend: cpu" in out


def test_cli_host_modes_point_to_reference(capsys):
    """The ``plan`` mode runs under both schemes and prints the plan."""
    for scheme in ("analytic", "profiled"):
        assert cli.main(["plan", "spada", "SS", "cari", "--device", "cpu",
                         "--plan-scheme", scheme]) == 0
        out = capsys.readouterr().out
        assert f"scheme {scheme})" in out and "tm histogram" in out


def test_cli_plan_prints_the_reference_lines(capsys):
    from spada_tpu import cli as jax_cli

    argv = ["plan", "spada", "SS", "cari", "config/default.json"]
    assert jax_cli.main(argv) == 0
    ref = capsys.readouterr().out.splitlines()
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines() == ref


def _printed_panels(lines):
    import re

    return [tuple(int(x) for x in re.match(
        r"\s+rows \[(\d+), (\d+)\)\s+tm=(\d+)", ln).groups())
        for ln in lines if ln.strip().startswith("rows [")]


def test_cli_plan_card_prints_what_run_executes(capsys):
    """``plan --card`` on the CPU plans under the card's profile (the
    datasheet's H100) as ``run`` does: the same tile edge and plan lines,
    and its panels are the plan ``run_spada`` executes."""
    argv = ["spada", "SS", "cari", "config/default.json", "--device", "cpu"]
    assert cli.main(["plan", *argv, "--card"]) == 0
    plan_out = capsys.readouterr().out.splitlines()
    assert cli.main(["run", *argv, "--no-result"]) == 0
    run_out = capsys.readouterr().out.splitlines()

    def decisions(lines):
        return [ln for ln in lines
                if ln.startswith(("tile size:", "plan[", "densify:"))]

    assert decisions(plan_out) == decisions(run_out) != []
    config = card_config(PortConfig.from_json("config/default.json"))
    w = cli.load_workload(cli.build_port_parser().parse_args(
        ["run", *argv]), config)
    run = cli.run_spada(w.a, w.b, config, "cpu", densify=True,
                        log=lambda s: None)
    executed = [(p.row_start, p.row_end, p.tm) for p in run.plan.panels]
    assert _printed_panels(plan_out) == executed
    assert sorted({seg.tm for seg in run.result.segments}) == \
        sorted({tm for _, _, tm in executed})


def test_dispatch_caps_its_exact_pattern_product():
    """Above ``ELEMENT_EXACT_CAP`` products an ambiguous element estimate
    reads its bytes off a row sample: within 0.5% of the exact pattern
    product's, in a small part of its time (an ambiguous pair of 1.8x the
    cap)."""
    import time

    from spada_tpu_torch.ops.element import expansion_products
    from spada_tpu_torch.ops.spgemm import ELEMENT_EXACT_CAP
    from spada_tpu_torch.tools.probe_dispatch_crossover import \
        banded_fill_csr

    a = banded_fill_csr(16384, 384, 64, seed=1)
    b = banded_fill_csr(16384, 384, 64, seed=2)
    e = expansion_products(a, b)
    assert e > ELEMENT_EXACT_CAP
    cfg = h100_config()
    t_lo = 3 * e * 4 / cfg.hbm_bytes_per_s + cfg.element_fixed_s
    t_hi = 5 * e * 4 / cfg.hbm_bytes_per_s + cfg.element_fixed_s
    t0 = time.perf_counter()
    got = estimate_element_time(a, b, cfg, tile_t=(t_lo + t_hi) / 2)
    sampled_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = element_plan_bytes(a, b, cap=cfg.element_cap)
    exact_s = time.perf_counter() - t0
    assert got["bytes_model"] == "sampled" and got["e_products"] == e
    assert got["bytes"] == pytest.approx(exact["bytes"], rel=5e-3)
    assert sampled_s < exact_s / 4


def test_cli_run_profiled_on_cpu(cari_workload, capsys):
    c = cli.execute(["run", "spada", "SS", "cari", "config/default.json",
                     "--device", "cpu", "--no-result",
                     "--plan-scheme", "profiled"])
    out = capsys.readouterr().out
    assert "plan[profiled]:" in out
    # no device time on the CPU, and the report says so
    assert "device perf: not measured (cpu)" in out
    _close(c.todense(), _oracle(cari_workload.a, cari_workload.b))


def test_profiled_plan_with_default_measure():
    """``plan_spgemm(scheme='profiled')`` with the port's measure on the
    CPU, run through ``execute_plan``, equals scipy
    (``tests/test_plan.py::test_profiled_scheme_with_default_measure``)."""
    a = powerlaw_csr(200, 128, 6.0, seed=50)
    b = random_csr(128, 160, 0.1, seed=51)
    calls = []
    measure = make_profiled_measure(P(a), P(b), PortConfig(), device="cpu")

    def counted(s, e, tm):
        calls.append(measure(s, e, tm))
        return calls[-1]

    plan = port_plan_spgemm(P(a), P(b), scheme="profiled", measure=counted)
    assert plan.meta["scheme"] == "profiled"
    assert calls and all(t >= 0.0 for t in calls)
    res = execute_plan(P(a), P(b), plan, device="cpu")
    np.testing.assert_allclose(res.todense(), _oracle(a, b), rtol=1e-4,
                               atol=1e-4)
    # a span with no products takes no time: A's nonzeros are all in
    # k-tile 1, B's in k-tile 0
    from spada_tpu_torch.sparse.csr import CsrMatrix

    idx = np.arange(64)
    a2 = CsrMatrix.from_coo((64, 256), idx, idx + 128, np.ones(64))
    b2 = CsrMatrix.from_coo((256, 160), idx, idx, np.ones(64))
    assert make_profiled_measure(a2, b2, device="cpu")(0, 64, 32) == 0.0


def _slab_cases():
    fa, fb = _random_case(7)[1:]
    return {
        # tests/test_spgemm.py: a budget of three tm=32 C tiles
        "slabbed": (random_csr(300, 256, 0.06, seed=70),
                    random_csr(256, 300, 0.06, seed=71),
                    {"dense_c_budget": 3 * 32 * 128 * 4}, 32),
        "one_shot": (powerlaw_csr(200, 160, 6.0, seed=72),
                     random_csr(160, 220, 0.08, seed=73), {}, None),
        # tests/test_fuzz.py: a budget of 2^18 bytes
        "fuzz": (fa, fb, {"dense_c_budget": 1 << 18}, None),
    }


@pytest.mark.parametrize("case", ["slabbed", "one_shot", "fuzz"])
def test_spgemm_csr_matches_reference_and_scipy(case):
    a, b, over, tm = _slab_cases()[case]
    got = spgemm_csr(P(a), P(b), PortConfig(**over), dataflow="rowwise",
                     tm=tm, device="cpu")
    ref = jax_spgemm_mod.spgemm_csr(a, b, SpadaConfig(**over),
                                    dataflow="rowwise", tm=tm)
    sp = (a.to_scipy() @ b.to_scipy()).tocsr()
    sp.sort_indices()
    tol = 1e-5 * max(float(np.abs(sp.data).max(initial=0.0)), 1e-30)
    for other in (ref, P(sp)):
        np.testing.assert_array_equal(got.indptr, other.indptr)
        np.testing.assert_array_equal(got.indices, other.indices)
        np.testing.assert_allclose(got.data, other.data, rtol=0, atol=tol)


def test_spgemm_csr_slabs_equal_one_shot():
    a, b, over, tm = _slab_cases()["slabbed"]
    many = spgemm_csr(P(a), P(b), PortConfig(**over), dataflow="rowwise",
                      tm=tm, device="cpu")
    one = spgemm(P(a), P(b), PortConfig(), dataflow="rowwise", tm=tm,
                 device="cpu").to_csr()
    np.testing.assert_array_equal(many.indptr, one.indptr)
    np.testing.assert_array_equal(many.indices, one.indices)
    np.testing.assert_array_equal(many.data, one.data)


def test_spgemm_keeps_its_launches_as_host_state(cari_workload):
    a, b = P(cari_workload.a), P(cari_workload.b)
    res = spgemm(a, b, h100_config(), dataflow="rowwise", device="cpu")
    (wl, a_tiles, b_tiles, tm), = res.host_state["segments"]
    assert (res.host_state["tk"], res.host_state["tn"]) == (res.tk, res.tn)
    assert tm == res.tm and wl.n_items == res.n_work_items
    assert a_tiles.dtype == b_tiles.dtype == np.float32


def test_measure_device_perf_is_none_on_cpu(cari_workload):
    a, b = P(cari_workload.a), P(cari_workload.b)
    res = spgemm(a, b, h100_config(), dataflow="rowwise", device="cpu")
    assert measure_device_perf(a, b, h100_config(), "rowwise",
                               host_state=res.host_state,
                               device="cpu") is None
    assert measure_device_perf(a, b, h100_config(), "element",
                               device="cpu") is None


def test_peak_flops_is_the_rate_the_tiles_run_at():
    """f32 tiles run 3xTF32: a third of dense TF32 (495 TFLOP/s on an H100
    SXM), not the 67 TFLOP/s FP32 rate; bf16 tiles the dense bf16 rate."""
    for name in (None, "NVIDIA H100 80GB HBM3"):
        assert _peak_flops(name, torch.float32) == 495e12 / 3
        assert _peak_flops(name, np.float32) == 495e12 / 3
        assert _peak_flops(name, torch.bfloat16) == 989e12
    assert _peak_flops("NVIDIA H100 PCIe", torch.float32) == 378e12 / 3


def test_cuda_device_raises_without_cuda(cari_workload):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        spgemm(P(cari_workload.a), P(cari_workload.b), h100_config(),
               device="cuda")


def test_h100_profile():
    cfg = h100_config()
    assert (cfg.hbm_bytes_per_s, cfg.peak_flops_f32,
            cfg.peak_flops_bf16) == (3.35e12, 67e12, 989e12)
    assert datasheet_peaks("NVIDIA H100 PCIe")["hbm_bytes_per_s"] == 2.0e12
    assert datasheet_peaks("NVIDIA H200")["hbm_bytes_per_s"] == 4.8e12
    # the per-item terms are the card's fit for the tile dtype
    # (tools/probe_item_overhead.py on an H100 80GB HBM3 at 700 W): the
    # per-T dict, acc and fixed on square tiles, held >= 0 (the lstsq
    # fit's fixed term is negative)
    assert cfg.engine_item_overhead_s == {128: 6.131e-08, 256: 5.541e-07,
                                          384: 1.983e-06, 512: 4.577e-06}
    assert cfg.engine_acc_s_per_elem == pytest.approx(1.6096162e-11,
                                                      rel=1e-7)
    assert cfg.engine_item_fixed_s == 0.0
    bf16 = h100_config(engine_dtype="bfloat16")
    assert bf16.engine_item_overhead_s == {128: 1.075e-08, 256: 1.099e-07,
                                           384: 4.187e-07, 512: 9.926e-07}
    assert bf16.engine_acc_s_per_elem == pytest.approx(3.4655986e-12,
                                                       rel=1e-7)
    assert bf16.engine_item_fixed_s == 0.0
    # the element path's fixed time, fitted on the card
    # (tools/probe_dispatch_crossover.py --element-fit), in place of the
    # reference's 30 us, for either tile dtype
    assert isinstance(cfg, CardConfig) and isinstance(bf16, CardConfig)
    assert cfg.element_fixed_s == pytest.approx(4.8789908e-06, rel=1e-7)
    assert bf16.element_fixed_s == cfg.element_fixed_s
    # an explicit override wins; everything else keeps the SpadaConfig
    # defaults
    mine = {128: 1e-7}
    over = h100_config(tile_k=256, engine_item_overhead_s=mine,
                       engine_item_fixed_s=5e-8)
    assert over.engine_item_overhead_s == mine
    assert over.engine_item_fixed_s == 5e-8
    assert over.engine_acc_s_per_elem == cfg.engine_acc_s_per_elem
    base = dataclasses.asdict(over)
    assert base["tile_k"] == 256
    for key, value in dataclasses.asdict(SpadaConfig()).items():
        if key not in ("tile_k", "hbm_bytes_per_s", "peak_flops_f32",
                       "peak_flops_bf16", "ici_bytes_per_s",
                       "engine_item_overhead_s", "engine_acc_s_per_elem",
                       "engine_item_fixed_s"):
            assert base[key] == value, key
    assert set(base) - set(dataclasses.asdict(SpadaConfig())) == {
        "element_fixed_s", *REFERENCE_TILE_TERMS}
    with pytest.raises(ValueError, match="engine_dtype"):
        h100_config(engine_dtype="float16")


def test_card_config_keeps_the_reference_schema(tmp_path):
    """The CLI's ``run`` puts the card's profile on a config of the
    reference's schema (``card_config``); ``SpadaConfig``'s JSON stays the
    reference's, and a ``CardConfig`` round-trips its own field."""
    path = "config/default.json"
    base = PortConfig.from_json(path)
    base.engine_dtype = "bfloat16"
    card = card_config(base)
    want = h100_config(engine_dtype="bfloat16")
    for f in dataclasses.fields(CardConfig):
        if f.name in ("engine_item_overhead_s", "engine_acc_s_per_elem",
                      "engine_item_fixed_s", "element_fixed_s",
                      "hbm_bytes_per_s", "peak_flops_f32", "peak_flops_bf16",
                      "ici_bytes_per_s", *REFERENCE_TILE_TERMS):
            assert getattr(card, f.name) == getattr(want, f.name), f.name
        else:
            assert getattr(card, f.name) == getattr(base, f.name), f.name
    out = tmp_path / "card.json"
    for cfg, cls in ((card, CardConfig), (base, PortConfig)):
        cfg.to_json(str(out))
        got = cls.from_json(str(out))
        # JSON keys are strings: the per-T dict comes back keyed by str(T)
        per_t = {int(t): v for t, v in got.engine_item_overhead_s.items()}
        assert per_t == cfg.engine_item_overhead_s
        assert dataclasses.replace(
            got, engine_item_overhead_s=per_t) == cfg
    card.to_json(str(out))
    with pytest.raises(ValueError, match="element_fixed_s"):
        PortConfig.from_json(str(out))


def test_cuda_time_needs_a_device():
    from spada_tpu_torch.utils.timing import cuda_time

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cuda_time(lambda: None)


def _dtype_pair():
    from spada_tpu.io.workloads import banded_csr

    return (banded_csr(512, 512, 24, seed=0, dtype=np.float32),
            banded_csr(512, 512, 24, seed=1, dtype=np.float32))


@pytest.mark.parametrize("cfg_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", [
    None, np.float32, torch.float32, "float32", "ml_dtypes.bfloat16",
    torch.bfloat16, "bfloat16"])
def test_spgemm_dtype_matches_reference(cfg_dtype, dtype):
    """spgemm's ``dtype`` sits where the reference's does (after ``plan``).
    None or float32 (torch, numpy or the name) is the reference's float32
    default: the config's tiles, so bf16 under a bf16 config; bfloat16
    (torch's, ml_dtypes' or the name) is bf16 tiles under any config.  The
    uniform path gives the reference's C within the engine's gate and its
    tile_itemsize."""
    import ml_dtypes

    if dtype == "ml_dtypes.bfloat16":
        dtype = ml_dtypes.bfloat16
    bf16 = "bfloat16" in str(dtype)
    a, b = _dtype_pair()
    cfg = h100_config(engine_dtype=cfg_dtype, element_dispatch="never")
    res = spgemm(P(a), P(b), cfg, "rowwise", None, None, dtype,
                 device="cpu")
    ref = jax_spgemm_mod.spgemm(a, b, cfg, dataflow="rowwise",
                                dtype=ml_dtypes.bfloat16 if bf16
                                else np.float32)
    assert res.tile_itemsize == ref.tile_itemsize == (
        2 if bf16 or cfg_dtype == "bfloat16" else 4)
    assert (res.tm, res.n_work_items) == (ref.tm, ref.n_work_items)
    _close(res.todense(), ref.todense())
    gate = 1e-2 if res.tile_itemsize == 2 else 1e-4
    want = _oracle(a, b)
    assert np.abs(res.todense() - want).max() <= gate * np.abs(want).max()


@pytest.mark.parametrize("dtype", [np.float16, np.float64, torch.float16,
                                   "int8"])
def test_spgemm_other_dtypes_raise(dtype):
    """float16 and other dtypes raise TypeError in the port; the reference
    runs float16 and float64 tiles (ROADMAP: differences by design)."""
    a, b = _dtype_pair()
    cfg = h100_config(element_dispatch="never")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        spgemm(P(a), P(b), cfg, dataflow="rowwise", dtype=dtype,
               device="cpu")
    assert jax_spgemm_mod.spgemm(a, b, cfg, dataflow="rowwise",
                                 dtype=np.float16).tile_itemsize == 2


def test_spgemm_dtype_only_on_the_uniform_path(cari_workload):
    """As in the reference, ``dtype`` sets the tiles of the uniform path
    alone: the element path and the ``plan=`` path ignore it."""
    a, b, _ = _pairs(cari_workload)["locpl"]
    cfg = h100_config()
    el = spgemm(P(a), P(b), cfg, dataflow="element", dtype=torch.bfloat16,
                device="cpu")
    np.testing.assert_array_equal(
        el.todense(),
        spgemm(P(a), P(b), cfg, dataflow="element", device="cpu").todense())
    a, b = _dtype_pair()
    cfg = h100_config(element_dispatch="never")
    plan = port_plan_spgemm(P(a), P(b), cfg)
    via = spgemm(P(a), P(b), cfg, dataflow="spada", plan=plan,
                 dtype=torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(
        via.todense(), execute_plan(P(a), P(b), plan, cfg,
                                    device="cpu").todense())
