"""The panel engine's run order in the port against the JAX package.

``run_worklist_panel(run_order=...)`` of ``spada_tpu_torch.ops.engine`` must
return the reference's ``run_perm`` array for array (output position ->
original C tile, None for row order) and, with the permutation undone, the
reference's C to 1e-5 of max|C| (f32 products summed in another order).
The reference's panel kernel runs in interpret mode with ``ogroup=1``: its
interpret cost grows with the C tiles per step, and at these tile edges the
group changes neither C nor the slot counts its 12 MiB fit gives, which
'auto' ranks the orders under.  The planner itself,
``spada_tpu_torch.ops.panelplan``, is pinned in ``tests/test_torch_host.py``.
"""

import numpy as np
import pytest
import torch

from spada_tpu.io.workloads import banded_csr
from spada_tpu.ops import engine as jax_engine
from spada_tpu.ops import panelplan as ref_pp
from spada_tpu.ops.worklist import build_worklist
from spada_tpu.sparse.bsr import BsrMatrix
from spada_tpu_torch.convert import c_tiles_to_numpy
from spada_tpu_torch.ops import engine
from spada_tpu_torch.ops import panelplan as port_pp


def _banded(n, band, t):
    a = banded_csr(n, n, bandwidth=band, seed=0, dtype=np.float32)
    b = banded_csr(n, n, bandwidth=band, seed=1, dtype=np.float32)
    A = BsrMatrix.from_csr(a, t, t, dtype=np.float32)
    B = BsrMatrix.from_csr(b, t, t, dtype=np.float32)
    return A, B, build_worklist(A, B, order="row")


def _undo(c, perm):
    if perm is None:
        return c
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return c[inv]


def _port(A, B, wl, run_order, dtype=torch.float32):
    a_t = torch.from_numpy(A.tiles).to(dtype)
    b_t = torch.from_numpy(B.tiles).to(dtype)
    c, a_plan, b_plan, perm = engine.run_worklist_panel(
        a_t, b_t, wl.a_tid, wl.b_tid, wl.o_tid, wl.n_c_tiles,
        run_order=run_order, c_rows=wl.c_tile_row, c_cols=wl.c_tile_col)
    assert a_plan is None and b_plan is None
    return c_tiles_to_numpy(c), perm


def _same_perm(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("run_order", ["row", "col", "diag", "auto"])
def test_panel_engine_run_orders(run_order):
    A, B, wl = _banded(512, 96, 64)
    ref_c, _, _, ref_perm = jax_engine.run_worklist_panel(
        A.tiles, B.tiles, wl.a_tid, wl.b_tid, wl.o_tid,
        n_c_tiles=wl.n_c_tiles, interpret=True, precision="highest",
        ogroup=1, run_order=run_order, c_rows=wl.c_tile_row,
        c_cols=wl.c_tile_col)
    oracle = np.asarray(jax_engine.run_worklist_xla(
        A.tiles, B.tiles, wl.a_tid, wl.b_tid, wl.o_tid,
        n_c_tiles=wl.n_c_tiles, precision="highest"))
    got, perm = _port(A, B, wl, run_order)
    _same_perm(perm, ref_perm)
    if run_order in ("col", "diag"):
        assert perm is not None and not np.array_equal(
            perm, np.arange(wl.n_c_tiles))
    ref_c = np.asarray(ref_c)
    scale = np.abs(oracle).max()
    assert np.abs(got - ref_c).max() <= 1e-5 * scale
    assert np.abs(_undo(got, perm) - oracle).max() <= 1e-5 * scale


def _stub_kernel(monkeypatch):
    """The reference's panel kernel replaced by zeros: only its host side,
    which computes ``run_perm``, is compared."""
    import jax.numpy as jnp

    def zeros(tile_ptr, apk, bpk, a_t, b_t, *, n_c_tiles, out_dtype, **kw):
        return jnp.zeros((n_c_tiles, a_t.shape[2], b_t.shape[2]), out_dtype)

    monkeypatch.setattr(jax_engine, "_run_pallas_panel", zeros)


@pytest.mark.parametrize("t,dtype", [(512, torch.float32),
                                     (256, torch.bfloat16)])
def test_auto_order_under_the_reference_fit(monkeypatch, t, dtype):
    """At T = 512 the reference's 12 MiB fit shrinks the slot counts (to
    10 and 10), which can change what 'auto' picks; the port ranks the
    orders under the same counts.  bf16 tiles halve the bytes a slot takes.
    """
    _stub_kernel(monkeypatch)
    A, B, wl = _banded(4096, 300, t)
    tiles = A.tiles if dtype == torch.float32 else A.tiles.astype(
        jax_engine.jnp.bfloat16)
    btiles = B.tiles if dtype == torch.float32 else B.tiles.astype(
        jax_engine.jnp.bfloat16)
    _, _, _, ref_perm = jax_engine.run_worklist_panel(
        tiles, btiles, wl.a_tid, wl.b_tid, wl.o_tid, n_c_tiles=wl.n_c_tiles,
        interpret=True, run_order="auto", c_rows=wl.c_tile_row,
        c_cols=wl.c_tile_col)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    slots = engine.panel_plan_slots(t, t, t, itemsize)
    if t == 512:
        assert slots == (10, 10, 4, 4)
    _, perm = _port(A, B, wl, "auto", dtype)
    _same_perm(perm, ref_perm)
    run_ptr = np.searchsorted(wl.o_tid, np.arange(wl.n_c_tiles + 1))
    order, want_perm, _ = ref_pp.choose_run_order(
        wl.a_tid, wl.b_tid, run_ptr, wl.c_tile_row, wl.c_tile_col, *slots)
    _same_perm(perm, None if order == "row" else want_perm)


def test_order_chooser_picks_argmin():
    A, B, wl = _banded(4096, 96, 64)
    run_ptr = np.searchsorted(np.asarray(wl.o_tid),
                              np.arange(wl.n_c_tiles + 1)).astype(np.int64)
    args = (wl.a_tid, wl.b_tid, run_ptr, wl.c_tile_row, wl.c_tile_col)
    order, perm, totals = port_pp.choose_run_order(
        *args, a_slots=12, b_slots=16, depth=4, max_panel=4)
    r_order, r_perm, r_totals = ref_pp.choose_run_order(
        *args, a_slots=12, b_slots=16, depth=4, max_panel=4)
    assert set(totals) == {"row", "col", "diag"}
    assert totals[order] == min(totals.values()), totals
    assert len(perm) == wl.n_c_tiles
    assert (order, totals) == (r_order, r_totals)
    np.testing.assert_array_equal(perm, r_perm)


def test_run_order_arguments_checked():
    A, B, wl = _banded(512, 96, 64)
    a_t, b_t = torch.from_numpy(A.tiles), torch.from_numpy(B.tiles)
    ids = (wl.a_tid, wl.b_tid, wl.o_tid, wl.n_c_tiles)
    with pytest.raises(ValueError, match="unknown run order"):
        engine.run_worklist_panel(a_t, b_t, *ids, run_order="zigzag")
    with pytest.raises(ValueError, match="c_rows"):
        engine.run_worklist_panel(a_t, b_t, *ids, run_order="col")


def test_auto_order_where_the_reference_planner_deadlocks(monkeypatch):
    """At T = 512 with long runs the panel planner finds no safe window at
    the fit's 10 and 10 slots and the reference raises; the port ranks the
    orders under the reference's unclamped counts (12, 16) instead, and its
    C is right in the order it chose."""
    _stub_kernel(monkeypatch)
    A, B, wl = _banded(4096, 700, 512)
    with pytest.raises(RuntimeError, match="deadlock"):
        jax_engine.run_worklist_panel(
            A.tiles, B.tiles, wl.a_tid, wl.b_tid, wl.o_tid,
            n_c_tiles=wl.n_c_tiles, interpret=True, run_order="auto",
            c_rows=wl.c_tile_row, c_cols=wl.c_tile_col)
    got, perm = _port(A, B, wl, "auto")
    run_ptr = np.searchsorted(wl.o_tid, np.arange(wl.n_c_tiles + 1))
    order, want_perm, _ = ref_pp.choose_run_order(
        wl.a_tid, wl.b_tid, run_ptr, wl.c_tile_row, wl.c_tile_col,
        12, 16, 4, 4)
    _same_perm(perm, None if order == "row" else want_perm)
    oracle = np.asarray(jax_engine.run_worklist_xla(
        A.tiles, B.tiles, wl.a_tid, wl.b_tid, wl.o_tid,
        n_c_tiles=wl.n_c_tiles, precision="highest"))
    assert np.abs(_undo(got, perm) - oracle).max() <= 1e-5 * np.abs(
        oracle).max()
