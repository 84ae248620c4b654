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
    tile_stream and tile_panel name the thin block below tm 128, tile_grid
    its narrow SIMT block.  An unknown engine raises."""
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
        thin = "narrow_simt" if r["kernel"] == "tile_grid" else "mma_thin"
        assert r["block"] == (thin if r["tm"] < 128 else "mma"), r
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
