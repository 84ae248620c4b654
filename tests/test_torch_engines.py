"""The port's streaming, panel and pallas_grid engines against the JAX package.

On the CPU the wrappers ``tile_stream``, ``tile_panel`` and ``tile_grid``
take their plain versions.  Through ``run_worklist_streaming``,
``run_worklist_panel`` and ``run_worklist_pallas`` they must equal the JAX
functions of the same name in interpret mode and
``run_worklist_xla(precision='highest')``, to 1e-5 of max|C|: f32 products of
the same values, summed in another order.  The JAX panel and pallas_grid
kernels leave a C tile with no items unspecified, where the port writes an
exact zero tile, so such tiles are compared with the plain engine only.  The
JAX panel kernel runs with ``ogroup=1``: in interpret mode its cost grows
with the C tiles per step, and the grouping changes no value of C.  The CUDA
kernels are held to these plain versions on the card by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spada_tpu.io.workloads import (block_sparse_csr, powerlaw_csr,
                                    random_csr, relu_activation_csr)
from spada_tpu.ops import engine as jax_engine
from spada_tpu.plan.planner import choose_tile_size, plan_spgemm
from spada_tpu.plan.planner import execute_plan as jax_execute_plan
from spada_tpu.sparse.bsr import BsrMatrix
from spada_tpu_torch.convert import from_reference as P
from spada_tpu_torch import cli
from spada_tpu_torch.config import h100_config
from spada_tpu_torch.convert import bsr_to_torch, c_tiles_to_numpy, item_ptr_of
from spada_tpu_torch.ops import engine
from spada_tpu_torch.ops.spgemm import spgemm
from spada_tpu_torch.ops.worklist import build_worklist
from spada_tpu_torch.plan.execute import execute_plan

jax_spgemm_mod = importlib.import_module("spada_tpu.ops.spgemm")

ENGINES = ["streaming", "panel", "pallas_grid"]
WRAPPER = {"streaming": "tile_stream", "panel": "tile_panel",
           "pallas_grid": "tile_grid"}


def _case(tm, seed=41, tn=64):
    a = powerlaw_csr(256, 256, 12.0, seed=seed, dtype=np.float32)
    b = random_csr(256, 256, 0.08, seed=seed + 1, dtype=np.float32)
    ab = P(BsrMatrix.from_csr(a, tm, 64, dtype=np.float32))
    bb = P(BsrMatrix.from_csr(b, 64, tn, dtype=np.float32))
    return ab, bb, build_worklist(ab, bb, order="row")


def _relerr(got, ref):
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


def _port(eng, a_t, b_t, a_ids, b_ids, o_ids, first, n_c, **kw):
    if eng == "streaming":
        c = engine.run_worklist_streaming(a_t, b_t, a_ids, b_ids, o_ids, n_c,
                                          **kw)
    elif eng == "panel":
        c = engine.run_worklist_panel(a_t, b_t, a_ids, b_ids, o_ids, n_c,
                                      **kw)[0]
    else:
        c = engine.run_worklist_pallas(a_t, b_t, a_ids, b_ids, o_ids, first,
                                       n_c, **kw)
    return c_tiles_to_numpy(c)


def _jax(eng, a_tiles, b_tiles, a_ids, b_ids, o_ids, first, n_c, **kw):
    args = (a_tiles, b_tiles, a_ids, b_ids, o_ids)
    if eng == "streaming":
        c = jax_engine.run_worklist_streaming(
            *args, n_c_tiles=n_c, interpret=True, precision="highest", **kw)
    elif eng == "panel":
        c = jax_engine.run_worklist_panel(
            *args, n_c_tiles=n_c, interpret=True, precision="highest",
            ogroup=1, **kw)[0]
    else:
        c = jax_engine.run_worklist_pallas(
            *args, first, n_c_tiles=n_c, interpret=True, precision="highest")
    return np.asarray(c.astype(jnp.float32))


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Counts the calls that reach each kernel wrapper of the port."""
    calls = {name: 0 for name in
             ("tile_spgemm", "tile_stream", "tile_panel", "tile_grid")}

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    for name in calls:
        monkeypatch.setattr(engine, name, counted(name, getattr(engine, name)))
    return calls


# (a) each engine against its JAX kernel and the XLA oracle ----------------

def _check_engine(eng, ab, bb, wl):
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    ids = (wl.a_tid, wl.b_tid, wl.o_tid, wl.first, wl.n_c_tiles)
    got = _port(eng, a_t, b_t, *ids)
    xla = np.asarray(jax_engine.run_worklist_xla(
        ab.tiles, bb.tiles, wl.a_tid, wl.b_tid, wl.o_tid,
        n_c_tiles=wl.n_c_tiles, precision="highest"))
    ref = _jax(eng, ab.tiles, bb.tiles, *ids)
    assert got.shape == xla.shape == (wl.n_c_tiles, ab.tm, bb.tn)
    assert _relerr(got, xla) <= 1e-5
    assert _relerr(got, ref) <= 1e-5  # build_worklist: no empty C tiles
    # run_worklist reaches the same engine
    via = c_tiles_to_numpy(engine.run_worklist(wl, a_t, b_t, engine=eng))
    np.testing.assert_array_equal(via, got)


@pytest.mark.parametrize("tm", [8, 32, 64])
@pytest.mark.parametrize("eng", ENGINES)
def test_engine_matches_jax_kernel_and_xla(eng, tm):
    _check_engine(eng, *_case(tm))


@pytest.mark.parametrize("eng", ENGINES)
def test_engine_matches_jax_kernel_at_tensor_core_shapes(eng):
    """tm = tn = 128, tk = 64, runs of several items: tiles that the card's
    kernels run on tensor cores (``csrc/tile_mma.cuh``)."""
    ab, bb, wl = _case(128, seed=43, tn=128)
    assert np.any(np.diff(wl.o_tid) == 0)
    _check_engine(eng, ab, bb, wl)


# (b) panel: pre-transposed A, bf16 output, empty C tiles ------------------

def test_panel_takes_pretransposed_a():
    ab, bb, wl = _case(32, seed=11)
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    ids = (wl.a_tid, wl.b_tid, wl.o_tid, wl.n_c_tiles)
    c, a_plan, b_plan, perm = engine.run_worklist_panel(a_t, b_t, *ids)
    assert (a_plan, b_plan, perm) == (None, None, None)
    # a_tiles_t is what the engine reads when it is given
    pre, _, _, _ = engine.run_worklist_panel(
        torch.zeros_like(a_t), b_t, *ids,
        a_tiles_t=a_t.transpose(1, 2).contiguous())
    torch.testing.assert_close(pre, c, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="run_order"):
        engine.run_worklist_panel(a_t, b_t, *ids, run_order="col")


def _check_panel_bf16_output(ab, bb, wl):
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    ids = (wl.a_tid, wl.b_tid, wl.o_tid, wl.n_c_tiles)
    got = engine.run_worklist_panel(a_t, b_t, *ids,
                                    out_dtype=torch.bfloat16)[0]
    assert got.dtype == torch.bfloat16
    f32 = engine.run_worklist_panel(a_t, b_t, *ids)[0]
    torch.testing.assert_close(got, f32.to(torch.bfloat16), rtol=0, atol=0)
    ref = _jax("panel", ab.tiles, bb.tiles, wl.a_tid, wl.b_tid, wl.o_tid,
               None, wl.n_c_tiles, out_dtype=jnp.bfloat16)
    got = got.float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.abs(ref) + 1e-30)) - 7)
    assert np.all(np.abs(got - ref) <= ulp)


def test_panel_bf16_output_matches_jax():
    """Both round their f32 sums once to bf16; the sums differ in order, so
    the two may round a value to neighbouring bf16 numbers: at most one
    bf16 ulp apart.  The port's bf16 output is its f32 output rounded."""
    _check_panel_bf16_output(*_case(8, seed=13))


def test_panel_bf16_output_matches_jax_at_tensor_core_shapes():
    """As above, at tiles the card runs on tensor cores (tm = tn = 128,
    tk = 64)."""
    _check_panel_bf16_output(*_case(128, seed=17, tn=128))


def test_panel_gap_tiles_are_zero():
    """The gap-tile case of tests/test_panel.py: C tiles 1, 2, 4 and 5 have
    no items; the port writes them as exact zeros."""
    rng = np.random.default_rng(1)
    T, nk = 16, 5
    a_tiles = rng.normal(size=(nk, T, T)).astype(np.float32)
    b_tiles = rng.normal(size=(nk, T, T)).astype(np.float32)
    a_ids = np.array([0, 1, 2, 3, 4, 1], np.int32)
    b_ids = np.array([0, 1, 2, 0, 3, 4], np.int32)
    o_ids = np.array([0, 0, 0, 3, 3, 6], np.int32)
    n_c = 7
    at_t = np.ascontiguousarray(a_tiles.transpose(0, 2, 1))
    got = c_tiles_to_numpy(engine.run_worklist_panel(
        torch.from_numpy(a_tiles), torch.from_numpy(b_tiles), a_ids, b_ids,
        o_ids, n_c, a_tiles_t=torch.from_numpy(at_t))[0])
    xla = np.asarray(jax_engine.run_worklist_xla(
        a_tiles, b_tiles, a_ids, b_ids, o_ids, n_c_tiles=n_c,
        precision="highest"))
    ref = _jax("panel", a_tiles, b_tiles, a_ids, b_ids, o_ids, None, n_c,
               max_panel=2, a_tiles_t=jnp.asarray(at_t))
    nonempty = np.unique(o_ids)
    empty = np.setdiff1d(np.arange(n_c), o_ids)
    assert np.all(got[empty] == 0.0)
    assert _relerr(got, xla) <= 1e-5
    assert _relerr(got[nonempty], ref[nonempty]) <= 1e-5


# (c) streaming groups; pallas_grid's first flags ---------------------------

@pytest.mark.parametrize("ogroup", [1, 8])
def test_streaming_groups_with_empty_tiles(ogroup):
    """Every third C tile's run emptied and five item-less C tiles appended,
    so n_c is no multiple of 8 and whole groups have no items.  JAX's
    streaming kernel zero-fills each group, so it is compared on all
    tiles."""
    ab, bb, wl = _case(64, seed=7)
    keep = wl.o_tid % 3 != 1
    a_ids, b_ids, o_ids = wl.a_tid[keep], wl.b_tid[keep], wl.o_tid[keep]
    n_c = wl.n_c_tiles + 5
    ptr = item_ptr_of(o_ids, n_c, ogroup)
    assert n_c % 8 and np.any(np.diff(ptr) == 0)
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    got = _port("streaming", a_t, b_t, a_ids, b_ids, o_ids, None, n_c,
                ogroup=ogroup, nbuf=2)
    ref = _jax("streaming", ab.tiles, bb.tiles, a_ids, b_ids, o_ids, None,
               n_c, ogroup=ogroup, nbuf=2)
    empty = np.setdiff1d(np.arange(n_c), o_ids)
    assert np.all(got[empty] == 0.0) and np.all(ref[empty] == 0.0)
    assert _relerr(got, ref) <= 1e-5
    assert got.shape == (n_c, 64, 64)


def test_item_ptr_matches_reference_grouping():
    o = np.array([0, 0, 1, 5, 5, 5, 9, 10], np.int32)
    for ogroup in (1, 3, 8):
        n_groups = -(-11 // ogroup)
        np.testing.assert_array_equal(
            item_ptr_of(o, 11, ogroup),
            np.searchsorted(o, np.arange(n_groups + 1) * ogroup))
    with pytest.raises(ValueError, match="ogroup"):
        item_ptr_of(o, 11, 0)


def test_pallas_checks_first_flags():
    ab, bb, wl = _case(8)
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    args = (a_t, b_t, wl.a_tid, wl.b_tid, wl.o_tid)
    bad = wl.first.copy()
    bad[1] = 1 - bad[1]
    for first in (bad, wl.first[:-1], np.zeros_like(wl.first)):
        with pytest.raises(ValueError, match="first"):
            engine.run_worklist_pallas(*args, first, wl.n_c_tiles)


# (d) the slice as a whole ---------------------------------------------------

def _pair():
    """Block-sparse x ReLU-sparse, tile side; K = 256 gives C-tile runs of
    one or two items at the configs' tile edges, which keeps the JAX panel
    kernel's interpret compile short."""
    return (block_sparse_csr(384, 256, 64, 0.5, seed=5),
            relu_activation_csr(256, 256, 0.35, seed=6))


def _scipy(a, b):
    return np.asarray((a.to_scipy() @ b.to_scipy()).todense())


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("override", ENGINES + ["use_pallas"])
def test_spgemm_engine_override_matches_reference(override, wrapper_calls):
    a, b = _pair()
    cfg = (h100_config(use_pallas=True) if override == "use_pallas"
           else h100_config(engine=override))
    res = spgemm(P(a), P(b), cfg, dataflow="spada", device="cpu")
    ref = jax_spgemm_mod.spgemm(a, b, cfg, dataflow="spada")
    assert res.engine_used == ref.engine_used == "tile"
    eng = "pallas_grid" if override == "use_pallas" else override
    assert wrapper_calls[WRAPPER[eng]] == 1
    assert wrapper_calls["tile_spgemm"] == 0
    got = res.todense()
    _close(got, ref.todense())
    _close(got, _scipy(a, b))


@pytest.mark.parametrize("eng", ENGINES)
def test_plan_path_engine_override_matches_reference(eng, wrapper_calls):
    a, b = _pair()
    cfg = h100_config(engine=eng)
    t, _ = choose_tile_size(a, b, cfg)
    cfg.tile_k = cfg.tile_n = cfg.default_tm = t
    cfg.tm_choices = tuple(x for x in cfg.tm_choices if x <= t) + (t,)
    plan = plan_spgemm(a, b, cfg)
    got = execute_plan(P(a), P(b), P(plan), cfg, device="cpu")
    ref = jax_execute_plan(a, b, plan, cfg)
    assert wrapper_calls[WRAPPER[eng]] == len(got.segments) > 0
    assert wrapper_calls["tile_spgemm"] == 0
    assert [s.tm for s in got.segments] == [s.tm for s in ref.segments]
    _close(got.todense(), ref.todense())
    _close(got.todense(), _scipy(a, b))


# (e) the CLI's --engine -----------------------------------------------------

@pytest.mark.parametrize("eng", ENGINES)
def test_cli_engine_flag(eng, wrapper_calls, capsys):
    rc = cli.main(["run", "spada", "SS", "cari", "config/default.json",
                   "--device", "cpu", "--engine", eng, "--no-result"])
    assert rc == 0
    # the first run and the warm second run both take the engine
    assert wrapper_calls[WRAPPER[eng]] >= 2
    assert wrapper_calls["tile_spgemm"] == 0
    assert "backend: cpu" in capsys.readouterr().out


# (f) engine choice and what the engines refuse ------------------------------

def test_select_engine_and_k_major_refusal():
    assert engine.select_engine("row", use_pallas=True) == "pallas_grid"
    assert engine.select_engine("k", use_pallas=True) == "pallas_grid"
    assert engine.select_engine("row") == "cached"
    assert engine.select_engine("row", use_pallas=False) == "xla"
    a = powerlaw_csr(200, 256, 10.0, seed=5, dtype=np.float32)
    b = random_csr(256, 192, 0.1, seed=6, dtype=np.float32)
    ab = P(BsrMatrix.from_csr(a, 16, 64))
    bb = P(BsrMatrix.from_csr(b, 64, 64))
    wl = build_worklist(ab, bb, order="k")
    assert np.any(np.diff(wl.o_tid) < 0)
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    for eng in ENGINES:
        with pytest.raises(ValueError, match="row-major"):
            engine.run_worklist(wl, a_t, b_t, engine=eng)
        # the engines' own entry points refuse unsorted o ids too
        with pytest.raises(ValueError, match="row-major"):
            _port(eng, a_t, b_t, wl.a_tid, wl.b_tid, wl.o_tid,
                  np.r_[1, np.diff(wl.o_tid) != 0], wl.n_c_tiles)


def test_wrappers_check_arguments():
    ab, bb, wl = _case(8)
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    ids = [torch.from_numpy(x) for x in (wl.a_tid, wl.b_tid, wl.o_tid)]
    ptr = torch.from_numpy(item_ptr_of(wl.o_tid, wl.n_c_tiles, 8))
    with pytest.raises(ValueError, match="item_ptr"):
        engine.tile_stream(a_t, b_t, *ids, ptr, wl.n_c_tiles, ogroup=4)
    with pytest.raises(ValueError, match="nbuf"):
        engine.tile_stream(a_t, b_t, *ids, ptr, wl.n_c_tiles, 8, nbuf=1)
    with pytest.raises(ValueError, match="differ in length"):
        engine.tile_grid(a_t, b_t, ids[0], ids[1], ids[2][:-1],
                         wl.n_c_tiles)
    with pytest.raises(ValueError, match="tk mismatch"):
        # natural A where the panel wrapper wants it k-transposed
        engine.tile_panel(a_t, b_t, ids[0], ids[1], ptr, torch.float32)
    with pytest.raises(TypeError, match="out_dtype"):
        engine.tile_panel(a_t.transpose(1, 2).contiguous(), b_t, ids[0],
                          ids[1], ptr, torch.float16)
    with pytest.raises(ValueError, match="exceed"):
        engine.run_worklist_streaming(a_t[:1], b_t, wl.a_tid, wl.b_tid,
                                      wl.o_tid, wl.n_c_tiles)
    with pytest.raises(ValueError, match="exceed n_c_tiles"):
        engine.run_worklist_pallas(a_t, b_t, wl.a_tid, wl.b_tid, wl.o_tid,
                                   wl.first, wl.n_c_tiles - 1)
