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
                                    relu_activation_csr)
from spada_tpu.plan.planner import choose_tile_size, plan_spgemm
from spada_tpu.plan.planner import execute_plan as jax_execute_plan
from spada_tpu_torch.convert import from_reference as P
from spada_tpu_torch import cli
from spada_tpu_torch.config import datasheet_peaks, h100_config
from spada_tpu_torch.ops.spgemm import (dispatch_dataflow, element_plan_bytes,
                                        estimate_element_time, spgemm)
from spada_tpu_torch.plan.execute import execute_plan

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


def _oracle(a, b):
    return np.asarray((a.to_scipy() @ b.to_scipy()).todense())


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("name", ["cari", "locpl", "nn"])
def test_spada_slice_matches_reference_and_scipy(cari_workload, name):
    a, b, route = _pairs(cari_workload)[name]
    cfg = h100_config()
    choice, det = dispatch_dataflow(P(a), P(b), cfg)
    ref_choice, ref_det = jax_spgemm_mod.dispatch_dataflow(a, b, cfg)
    assert choice == ref_choice == route
    assert det["tile_T"] == ref_det["tile_T"]
    assert det["element"] == ref_det["element"]

    res = spgemm(P(a), P(b), cfg, dataflow="spada", device="cpu")
    ref = jax_spgemm_mod.spgemm(a, b, cfg, dataflow="spada")
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
    cfg = h100_config()
    assert (element_plan_bytes(P(a), P(b))
            == jax_spgemm_mod.element_plan_bytes(a, b))
    for tile_t in (None, 1e-5, 1e-3):
        assert (estimate_element_time(P(a), P(b), cfg, tile_t)
                == jax_spgemm_mod.estimate_element_time(a, b, cfg, tile_t))


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
    assert cli.main(["plan", "spada", "SS", "cari", "--device", "cpu"]) == 2
    assert "python -m spada_tpu.cli plan" in capsys.readouterr().out


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
    # everything else keeps the SpadaConfig defaults
    base = dataclasses.asdict(h100_config(tile_k=256))
    assert base["tile_k"] == 256
    assert base["engine_item_overhead_s"] == dataclasses.asdict(
        SpadaConfig())["engine_item_overhead_s"]


def test_cuda_time_needs_a_device():
    from spada_tpu_torch.utils.timing import cuda_time

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        cuda_time(lambda: None)
