"""The work counts against a brute-force count, and the roofline's work
taken from the inputs alone."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_bench import counts, harness
from gpu_bench.cells import load_cell
from gpu_bench.csr import Csr


def _random_csr(rng, m, n, density):
    d = (rng.random((m, n)) < density) * rng.random((m, n))
    rows, cols = np.nonzero(d)
    indptr = np.concatenate(([0], np.cumsum(np.bincount(rows, minlength=m))))
    return Csr((m, n), indptr, cols.astype(np.int32),
               d[rows, cols].astype(np.float32))


@pytest.mark.parametrize("seed", range(5))
def test_useful_flop_and_bytes_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    a = _random_csr(rng, 7, 9, 0.3)
    b = _random_csr(rng, 9, 5, 0.4)
    pa, pb = a.indptr, b.indptr
    products = 0
    c = set()
    for i in range(7):
        for k in a.indices[pa[i]:pa[i + 1]]:
            for j in b.indices[pb[k]:pb[k + 1]]:
                products += 1
                c.add((i, j))
    assert counts.useful_flop(a, b) == 2 * products
    want = (a.nnz * 8 + 8 * 4) + (b.nnz * 8 + 10 * 4) + (len(c) * 8 + 8 * 4)
    assert counts.product_bytes(a, b, len(c)) == want
    assert counts.product_bytes(a, a, 3) == (a.nnz * 8 + 8 * 4) + 3 * 8 + 8 * 4


def test_least_time_takes_the_larger_bound():
    t, which = counts.least_time(67e12, 0)
    assert t == pytest.approx(1.0) and which == "operations"
    t, which = counts.least_time(0, 3.35e12)
    assert t == pytest.approx(1.0) and which == "bytes"


def _roofline():
    path = Path(__file__).resolve().parents[1] / "metrics" / "spgemm_roofline.py"
    spec = importlib.util.spec_from_file_location("roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_reads_the_inputs_work_whatever_the_plan():
    """Two plans of one input (tm 8 and the planner's own) run different
    items, and the roofline's work is the same for both."""
    cell = load_cell("opt-1.3b-fc2-blk32.prefill-16k")
    cell.config.update(hidden_size=256, ffn_dim=1024)
    cell.traffic.update(tokens=2048)
    inputs = harness.make_inputs(cell, 5)
    dev = torch.device("cpu")
    run = harness.plan_cell(cell, inputs, dev, lambda m: None)
    assert run.choice == "tile"
    thin = type(run.plan)([type(p)(p.row_start, p.row_end, 8)
                           for p in run.plan.panels],
                          run.plan.tile_k, run.plan.tile_n, {})
    recs = []
    for plan in (run.plan, thin):
        run.plan = plan
        out = harness.measure(cell, inputs, run, 5, 0.05, dev)
        assert out["correct"]
        recs.append(out["record"])
    assert recs[0].items != recs[1].items
    a, b = inputs.pairs[0]
    assert recs[0].flop == recs[1].flop == counts.useful_flop(a, b)
    assert recs[0].nbytes == recs[1].nbytes
    roof = _roofline()
    for r in recs:
        r.trace = {"op_s": 2.0 * r.products}
        assert roof.read(r) == pytest.approx(
            100 * counts.least_time(r.flop, r.nbytes)[0] / 2.0)
