"""``spada_tpu_torch.tools.probe_op`` against the JAX package.

At n = 2048, band 128, T = 128 (the tool's operands, cut to a CPU's size):
the port's k-major C through the ``'xla'`` engine, the launch
``spgemm(dataflow="op")`` makes, equals the reference's
``run_worklist_xla`` on the same tiles within 1e-5 of max|C|, for f32 and
bf16 tiles (both widen bf16 products into f32 sums, so only the order of
the sums differs); the row schedule's C from the ``'cached'`` engine
(``tile_spgemm``'s plain version on the CPU) equals it too.  The tool's
bounds are the reference's two formulas at the card profile's HBM rate,
and its entry point runs on the CPU.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spada_tpu.io.workloads import banded_csr
from spada_tpu.ops.engine import run_worklist_xla
from spada_tpu.ops.worklist import build_worklist as ref_worklist
from spada_tpu.sparse.bsr import BsrMatrix
from spada_tpu_torch.config import card_profile
from spada_tpu_torch.convert import bsr_to_torch, from_reference
from spada_tpu_torch.ops.engine import prepare_worklist
from spada_tpu_torch.ops.worklist import build_worklist
from spada_tpu_torch.tools import probe_op

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BAND, T = 2048, 128, 128


@pytest.fixture(scope="module")
def operands():
    a = banded_csr(N, N, bandwidth=BAND, seed=0, dtype=np.float32)
    b = banded_csr(N, N, bandwidth=BAND, seed=1, dtype=np.float32)
    return (BsrMatrix.from_csr(a, T, T, dtype=np.float32),
            BsrMatrix.from_csr(b, T, T, dtype=np.float32))


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_path_and_row_schedule_match_reference(operands, dtype):
    a_bsr, b_bsr = operands
    wlk = ref_worklist(a_bsr, b_bsr, order="k")
    want = np.asarray(run_worklist_xla(
        jnp.asarray(a_bsr.tiles).astype(dtype),
        jnp.asarray(b_bsr.tiles).astype(dtype), wlk.a_tid, wlk.b_tid,
        wlk.o_tid, n_c_tiles=wlk.n_c_tiles, precision="highest"))
    pa, pb = from_reference(a_bsr), from_reference(b_bsr)
    tdt = getattr(torch, dtype)
    at, bt = bsr_to_torch(pa, "cpu", tdt), bsr_to_torch(pb, "cpu", tdt)
    port_k = build_worklist(pa, pb, order="k")
    np.testing.assert_array_equal(port_k.o_tid, wlk.o_tid)
    op_c = prepare_worklist(port_k, at, bt, engine="xla")().numpy()
    assert _rel(op_c, want) <= 1e-5
    row_c = prepare_worklist(build_worklist(pa, pb, order="row"), at, bt,
                             engine="cached")().numpy()
    assert row_c.shape == want.shape
    assert _rel(row_c, want) <= 1e-5


def test_bounds_are_the_reference_formulas():
    hbm = card_profile()["hbm_bytes_per_s"]
    for W, n_c, t, isz in ((377, 209, 384, 4), (377, 209, 384, 2),
                           (134, 74, 128, 2)):
        rmw, onchip = probe_op.bounds(W, n_c, t, isz, hbm)
        assert rmw == (W * (2 * t * t) * isz + 2 * W * t * t * 4) / hbm
        assert onchip == (W * (2 * t * t) * isz + n_c * t * t * 4) / hbm


def test_run_on_cpu_gates_and_reports(operands):
    a_bsr, _ = operands
    res = probe_op.run(N, BAND, T, device="cpu", log=lambda s: None)
    assert list(res) == ["bfloat16", "float32"]
    hbm = card_profile()["hbm_bytes_per_s"]
    wl = ref_worklist(*operands, order="k")
    for dt, r in res.items():
        assert (r["W"], r["n_c"]) == (wl.n_items, wl.n_c_tiles)
        isz = 2 if dt == "bfloat16" else 4
        assert (r["rmw_s"], r["onchip_s"]) == probe_op.bounds(
            wl.n_items, wl.n_c_tiles, T, isz, hbm)
        assert r["share"] is None and r["timed"] == "cpu wall"
        assert r["agree"] <= probe_op.AGREE
        assert max(r["gate_op"], r["gate_row"]) <= probe_op.GATE[dt]
        assert r["op_device"] == "cpu"


def test_entry_point_on_cpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-m", "spada_tpu_torch.tools.probe_op", "--device",
         "cpu", "--n", str(N), "--band", str(BAND), "--T", str(T)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("op/k-major W=") == 2
    assert "(cpu wall)" in out.stdout
