"""``spada_tpu_torch.tools.eval_scaling`` against the JAX package.

At the tool's ``--quick`` size (n = 2048·D, band 96, tm 64), D in {1, 2,
4}: the port's partitions are the reference's array for array, and the
scaling model's estimates under ``SpadaConfig()`` are the reference's
exactly.  The tool's functional run (a spawned gloo group of D ranks on the
CPU per D) gives the C of the reference's ``spgemm_halo`` and
``spgemm_sharded`` on the JAX 8-device CPU mesh (``tests/conftest.py``)
within 1e-5 of max|C|, and scipy's.  Its entry point on the CPU writes the
file it is given and nothing else.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from spada_tpu.config import SpadaConfig as RefConfig
from spada_tpu.io.workloads import banded_csr
from spada_tpu.parallel import partition_halo, partition_spgemm
from spada_tpu.parallel import scaling as ref_scaling
from spada_tpu.parallel import spgemm_halo, spgemm_sharded
from spada_tpu_torch.config import SpadaConfig as PortConfig
from spada_tpu_torch.parallel import scaling as port_scaling
from spada_tpu_torch.tools import eval_scaling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DS = (1, 2, 4)


@pytest.fixture(scope="module")
def points():
    return {D: eval_scaling.point(D, eval_scaling.QUICK, PortConfig())
            for D in DS}


@pytest.fixture(scope="module")
def reference():
    """{D: (a, b, halo problem, psum-merge problem)} of the JAX package."""
    base_n, band, tm = eval_scaling.QUICK
    out = {}
    for D in DS:
        n = base_n * D
        a = banded_csr(n, n, bandwidth=band, seed=0, dtype=np.float32)
        b = banded_csr(n, n, bandwidth=band, seed=1, dtype=np.float32)
        out[D] = (a, b, partition_halo(a, b, D, RefConfig(), tm=tm),
                  partition_spgemm(a, b, *eval_scaling.reduce_mesh(D),
                                   RefConfig(), tm=tm))
    return out


@pytest.fixture(scope="module")
def functional(points):
    return eval_scaling.functional([points[D] for D in DS],
                                   log=lambda s: None)


def _same_fields(ref, got):
    for f in dataclasses.fields(ref):
        x, y = getattr(ref, f.name), getattr(got, f.name)
        if isinstance(x, list):
            assert len(x) == len(y), f.name
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v, err_msg=f.name)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f.name)


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("D", DS)
def test_problems_equal_reference(points, reference, D):
    _, _, halo, red = reference[D]
    _same_fields(halo, points[D].halo)
    _same_fields(red, points[D].reduce)


@pytest.mark.parametrize("D", DS)
def test_estimates_equal_reference(points, reference, D):
    _, _, halo, red = reference[D]
    rc, pc = RefConfig(), PortConfig()
    assert (port_scaling.estimate_halo_scaling(points[D].halo, pc).as_dict()
            == ref_scaling.estimate_halo_scaling(halo, rc).as_dict())
    assert (port_scaling.estimate_reduce_scaling(points[D].reduce,
                                                 pc).as_dict()
            == ref_scaling.estimate_reduce_scaling(red, rc).as_dict())


@pytest.mark.parametrize("D", DS)
def test_functional_groups_equal_reference_and_scipy(functional, reference,
                                                     points, D):
    from spada_tpu_torch.parallel.halo import halo_view
    from spada_tpu_torch.parallel.spgemm import ShardedResult

    a, b, halo, red = reference[D]
    n_dp, n_tp = eval_scaling.reduce_mesh(D)
    devs = np.array(jax.devices()[:D])
    want_h = spgemm_halo(halo, mesh=Mesh(devs, ("dp",))).c_tiles
    want_r = spgemm_sharded(red, mesh=Mesh(devs.reshape(n_dp, n_tp),
                                           ("dp", "tp"))).c_tiles
    got_h, got_r = functional[D]
    assert _rel(got_h, want_h) <= 1e-5
    assert _rel(got_r, want_r) <= 1e-5
    ref = (a.to_scipy().astype(np.float64) @ b.to_scipy()).tocsr()
    p = points[D]
    for view, c in ((halo_view(p.halo), got_h), (p.reduce, got_r)):
        diff = ShardedResult(view, c).to_csr().to_scipy() - ref
        assert abs(diff).max() <= 1e-5 * abs(ref).max()


def test_functional_gates_reject_a_wrong_c(functional, points):
    """A C off by 1e-3 in one element fails both gates; the right one
    passes."""
    from spada_tpu_torch.parallel.halo import halo_view

    p = points[2]
    view = halo_view(p.halo)
    c = functional[2][0]
    ref = p.a.to_scipy().astype(np.float64) @ p.b.to_scipy()
    eval_scaling.check_functional(p, view, c, "right", ref)
    eval_scaling.panel_gate(p.a, p.b, view, c, eval_scaling.F32_GATE,
                            "right")
    bad = c.copy()
    bad[1, 0, 0, 0] += 1e-3 * (1 + abs(bad[1, 0, 0, 0])) + 1e-3
    with pytest.raises(RuntimeError, match="allclose"):
        eval_scaling.check_functional(p, view, bad, "off", ref)
    bad = c.copy()
    bad[1, 0, 0, 0] += 1e-3 * np.abs(c).max()
    with pytest.raises(RuntimeError, match="differ from scipy"):
        eval_scaling.panel_gate(p.a, p.b, view, bad, eval_scaling.F32_GATE,
                                "off")


def test_entry_point_on_cpu_writes_only_its_out_file(tmp_path):
    eval_md = os.path.join(ROOT, "EVAL_SCALING.md")
    before = os.stat(eval_md)
    with open(eval_md, "rb") as f:
        before_bytes = f.read()
    cwd, out_dir = tmp_path / "cwd", tmp_path / "out"
    cwd.mkdir()
    out_dir.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-m", "spada_tpu_torch.tools.eval_scaling",
         "--device", "cpu", "--quick", "--out",
         str(out_dir / "table.md")],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "# Weak-scaling evaluation" in res.stdout
    assert "What is measured and what is modeled" in res.stdout
    assert "CPU wall ms" in res.stdout
    assert os.listdir(cwd) == []
    assert os.listdir(out_dir) == ["table.md"]
    text = (out_dir / "table.md").read_text()
    assert text.startswith("# Weak-scaling evaluation")
    assert [line.split(" | ")[0] for line in text.splitlines()
            if line[:2] == "| " and line[2:3].isdigit()] == [
                f"| {D}" for D in eval_scaling.DEVICES]
    after = os.stat(eval_md)
    with open(eval_md, "rb") as f:
        assert f.read() == before_bytes
    assert after.st_mtime_ns == before.st_mtime_ns
