"""The thin-panel sweep tool (``spada_tpu_torch.tools.sweep_thin``) on the
CPU, where it runs the plain tile engine.

The sweep's C is gated inside the tool against scipy on its first rows; here
the tool's case list, blocks and item counts are held to the launch rule and
to the JAX package's worklist builder on the same banded pair, and its
command line is run once.  The kernels themselves are held to the plain
version on the card by ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest

from spada_tpu.io.workloads import banded_csr as jax_banded_csr
from spada_tpu.ops.worklist import build_worklist as jax_build_worklist
from spada_tpu.sparse.bsr import BsrMatrix as JaxBsr
from spada_tpu_torch import _build
from spada_tpu_torch.tools import sweep_thin


def test_sweep_cases_blocks_and_item_counts():
    n, T = 1024, 128
    rows = sweep_thin.run(n=n, band=96, T=T, tms=(8, 16, 64, 128),
                          device="cpu", gate_rows=256, log=lambda s: None)
    assert [(r["dtype"], r["tm"]) for r in rows] == [
        (dt, tm) for tm in (8, 16, 64, 128) for dt in sweep_thin.DTYPES]
    a = jax_banded_csr(n, n, 96, seed=0, dtype=np.float32)
    b = jax_banded_csr(n, n, 96, seed=1, dtype=np.float32)
    b_bsr = JaxBsr.from_csr(b, T, T)
    for r in rows:
        assert r["block"] == ("mma" if r["tm"] == 128 else "mma_thin")
        wl = jax_build_worklist(JaxBsr.from_csr(a, r["tm"], T), b_bsr,
                                order="row")
        assert (r["W"], r["n_c"]) == (wl.n_items, wl.n_c_tiles)
        # on the CPU the launch is the plain version: no time, no error
        assert r["ms"] is None and r["lib_ms"] is None
        assert r["plain_err"] == 0.0
        assert r["gate_err"] <= sweep_thin.GATE[r["dtype"]]
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
    assert _build.launches["tile_spgemm"] == 0


def test_sweep_cli_on_cpu(capsys):
    assert sweep_thin.main(["--device", "cpu", "--n", "512", "--band", "48",
                            "--tms", "16,128", "--dtypes", "bfloat16"]) == 0
    out = capsys.readouterr().out
    assert "| bfloat16 | 16 | mma_thin |" in out
    assert "| bfloat16 | 128 | mma |" in out
    assert "not timed" in out


def test_sweep_engines_share_operands_and_gate_each():
    """``engines``: every tile kernel runs on the same operands and
    worklist of each (dtype, tm), tile_stream at each ogroup of OGROUPS,
    each case gated against its plain version and scipy; tile_spgemm,
    all four kernels name the thin block below tm 128.  An unknown engine
    raises."""
    tms = (8, 64, 128)
    rows = sweep_thin.run(n=512, band=48, T=128, tms=tms, device="cpu",
                          gate_rows=256, engines=sweep_thin.ENGINES,
                          log=lambda s: None)
    labels = ["tile_spgemm"] + [f"tile_stream og={og}"
                                for og in sweep_thin.OGROUPS] + [
        "tile_panel", "tile_grid"]
    assert [(r["tm"], r["dtype"], r["engine"]) for r in rows] == [
        (tm, dt, e) for tm in tms for dt in sweep_thin.DTYPES for e in labels]
    assert set(sweep_thin.BITWISE) <= set(labels)
    first = {}
    for r in rows:
        assert r["block"] == ("mma_thin" if r["tm"] < 128 else "mma"), r
        assert r["plain_err"] <= sweep_thin.PLAIN_TOL
        assert r["gate_err"] <= sweep_thin.GATE[r["dtype"]]
        assert (r["same_bits"] is None) == (r["kernel"] == "tile_spgemm")
        # one worklist per tm, one bound per (dtype, tm)
        key = (r["dtype"], r["tm"])
        first.setdefault(key, r)
        assert (r["W"], r["n_c"], r["bound_ms"]) == (
            first[key]["W"], first[key]["n_c"], first[key]["bound_ms"])
    assert not any(_build.launches[k] for k in sweep_thin.ENGINES)
    with pytest.raises(ValueError, match="unknown engines"):
        sweep_thin.run(n=512, band=48, tms=(8,), device="cpu",
                       engines=("tile_probe",), log=lambda s: None)


def test_sweep_cli_engines_on_cpu(capsys):
    """Asking for tile_stream or tile_panel runs tile_spgemm first, the C
    they must equal bit for bit on a card; tile_grid alone runs alone."""
    assert sweep_thin.main(["--device", "cpu", "--n", "512", "--band", "48",
                            "--tms", "16", "--dtypes", "float32",
                            "--engines", "tile_panel,tile_stream"]) == 0
    out = capsys.readouterr().out
    table = [line.split(" | ")[3] for line in out.splitlines()
             if line.startswith("| float32 | 16 |")]
    assert table == ["tile_spgemm", "tile_stream og=1", "tile_stream og=8",
                     "tile_panel"]
    rows = sweep_thin.run(n=512, band=48, tms=(16,), dtypes=("float32",),
                          device="cpu", gate_rows=256,
                          engines=("tile_grid",), log=lambda s: None)
    assert [(r["engine"], r["same_bits"]) for r in rows] == [
        ("tile_grid", None)]


def test_sweep_grid_chunks_and_cari_pair():
    """``grid_chunks`` adds one tile_grid case per G on the thin block only
    (tm 128 runs the wide block, one item per block), each gated against
    the plain version and scipy; ``pair="cari"`` runs the CLI's stock
    matrix, C = A A^T, whose tm-64 worklist is the JAX package's (130
    items at T = 128)."""
    rows = sweep_thin.run(n=512, band=48, T=128, tms=(16, 128),
                          dtypes=("float32",), device="cpu", gate_rows=256,
                          engines=("tile_grid",), grid_chunks=(2, 4),
                          log=lambda s: None)
    assert [(r["tm"], r["engine"], r["chunk"]) for r in rows] == [
        (16, "tile_grid", None), (16, "tile_grid G=2", 2),
        (16, "tile_grid G=4", 4), (128, "tile_grid", None)]
    assert all(r["plain_err"] == 0.0 and r["kernel"] == "tile_grid"
               for r in rows)
    rows = sweep_thin.run(T=128, tms=(64,), device="cpu", gate_rows=256,
                          engines=("tile_grid",), pair="cari",
                          grid_chunks=(2,), log=lambda s: None)
    from spada_tpu.io.workloads import GemmWorkload as JaxWorkload

    w = JaxWorkload.from_suitesparse("./matrices", "cari")
    wl = jax_build_worklist(JaxBsr.from_csr(w.a, 64, 128),
                            JaxBsr.from_csr(w.b, 128, 128), order="row")
    assert wl.n_items == 130
    assert [(r["dtype"], r["engine"], r["W"], r["n_c"], r["block"])
            for r in rows] == [
        (dt, e, 130, wl.n_c_tiles, "mma_thin") for dt in sweep_thin.DTYPES
        for e in ("tile_grid", "tile_grid G=2")]
    assert all(r["gate_err"] <= sweep_thin.GATE[r["dtype"]] for r in rows)
    with pytest.raises(ValueError, match="unknown pair"):
        sweep_thin.run(n=512, band=48, tms=(8,), device="cpu",
                       pair="rmat", log=lambda s: None)


def test_a_warpgroup_case_brings_the_direct_launch_beside_it():
    """Where the prepared tile_spgemm launch takes the warpgroup block (f32
    tm-64 panels dense along k: no slice mask kept), a ``tile_spgemm
    direct`` case follows it on the thin block, and the bitwise cases are
    held to that one's C; the bf16 tiles keep the prepared case alone."""
    rows = sweep_thin.run(n=1024, band=384, T=128, tms=(64,), device="cpu",
                          gate_rows=256, engines=sweep_thin.ENGINES,
                          log=lambda s: None)
    got = [(r["dtype"], r["engine"], r["block"]) for r in rows
           if r["kernel"] == "tile_spgemm"]
    assert got == [("float32", "tile_spgemm", "mma_wg"),
                   ("float32", "tile_spgemm direct", "mma_thin"),
                   ("bfloat16", "tile_spgemm", "mma_thin")]
    assert all(r["same_bits"] for r in rows
               if r["engine"] in sweep_thin.BITWISE)
    assert all(r["block"] == "mma_thin" for r in rows
               if r["kernel"] != "tile_spgemm")
