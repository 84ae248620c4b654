"""The warpgroup block of ``tile_spgemm`` (``csrc/tile_wgmma.cuh``): its
schedule and routing on the CPU, its kernel against the plain version and
the f64 product on the card (``cuda`` marker: skips without a card).  The
file imports no JAX:

    python -m pytest tests/test_torch_wgmma.py --noconftest -q
"""

import collections

import numpy as np
import pytest
import torch

from spada_tpu_torch import _build
from spada_tpu_torch.convert import tile_ptr_of
from spada_tpu_torch.ops import engine
from spada_tpu_torch.ops.engine import (prepare_cached,
                                        run_worklist_reference, tile_spgemm,
                                        wg_schedule, wg_units)
from spada_tpu_torch.plan.card_model import block_pieces


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def grouped(tm, tk, tn, run, n_cols=2, experts=(3, 2), straddle=True,
            empty=(1, 1), seed=0):
    """A grouped product as the expert cell's: ``experts`` panels (one C
    tile row each) per expert, each panel's runs of ``run`` items reading
    its expert's B tiles (id (e * run + i) * n_cols + j for k-tile i,
    column j), a last panel that straddles two experts when ``straddle``,
    and C tile (panel, column) ``empty`` with no items.  Host arrays (a, b,
    a_ids, b_ids, o_ids, n_c)."""
    rng = np.random.default_rng(seed)
    panels = [e for e, n in enumerate(experts) for _ in range(n)]
    if straddle:
        panels.append(-1)
    o, a_ids, b_ids = [], [], []
    for p, e in enumerate(panels):
        for j in range(n_cols):
            if (p, j) == tuple(empty):
                continue
            for i in range(run):
                ei = e if e >= 0 else i % len(experts)
                o.append(p * n_cols + j)
                a_ids.append(p * run + i)
                b_ids.append((ei * run + i) * n_cols + j)
    n_a, n_b = len(panels) * run, len(experts) * run * n_cols
    a = rng.standard_normal((n_a, tm, tk), np.float32)
    b = rng.standard_normal((n_b, tk, tn), np.float32)
    return (a, b, *(np.array(x, np.int32) for x in (a_ids, b_ids, o)),
            len(panels) * n_cols)


def _check_units(units, tile_ptr, b_ids, pieces):
    """Every piece once; the two pieces of a unit read the same B run."""
    flat = units[units >= 0]
    assert sorted(flat.tolist()) == list(range((len(tile_ptr) - 1) * pieces))

    def run(p):
        o = p // pieces
        return b_ids[tile_ptr[o]:tile_ptr[o + 1]].tolist()

    for p1, p2 in units:
        if p2 >= 0:
            assert run(p1) == run(p2)


# ---- the schedule, on the host ---------------------------------------------

def test_the_units_pair_panels_of_one_b_run():
    """tm 64: expert 0's three panels pair two and leave one, expert 1's
    two pair, the straddler runs alone, and so does the empty tile (the only
    run of its kind); units of one B run together."""
    a, b, ai, bi, o, n_c = grouped(64, 64, 128, run=3)
    tp = tile_ptr_of(o, n_c)
    units = wg_units(tp, bi, 1)
    _check_units(units, tp, bi, 1)
    pairs = {tuple(u) for u in units.tolist() if u[1] >= 0}
    singles = sorted(u[0] for u in units.tolist() if u[1] < 0)
    # panels 0-2 expert 0, 3-4 expert 1, 5 the straddler; C tile 3 empty
    assert pairs == {(0, 2), (1, 5), (6, 8), (7, 9)}
    assert singles == [3, 4, 10, 11]
    groups = [tuple(bi[tp[u[0]]:tp[u[0] + 1]]) for u in units.tolist()]
    changes = sum(x != y for x, y in zip(groups, groups[1:]))
    assert changes == len(set(groups)) - 1


@pytest.mark.parametrize("tm", [128, 192, 320])
def test_the_units_of_taller_tiles(tm):
    """tm a multiple of 64: a C tile's pieces pair with each other, and an
    odd last piece with the next tile of the same B run."""
    pieces = tm // 64
    a, b, ai, bi, o, n_c = grouped(tm, 32, 128, run=2, straddle=False,
                                   empty=(9, 9))
    tp = tile_ptr_of(o, n_c)
    units = wg_units(tp, bi, pieces)
    _check_units(units, tp, bi, pieces)
    n_pieces = n_c * pieces
    # two B runs per column and expert: 2 x 2 groups of 3 and 2 panels
    odd = sum((n * pieces) % 2 for n in (3, 2)) * 2
    assert int((units[:, 1] < 0).sum()) == odd
    assert len(units) == (n_pieces + odd) // 2


def test_the_units_of_one_item_runs_and_no_items():
    tp = np.array([0, 1, 1, 2, 3], np.int64)
    units = wg_units(tp, np.array([7, 7, 8], np.int32), 1)
    _check_units(units, tp, np.array([7, 7, 8]), 1)
    assert {tuple(u) for u in units.tolist()} == {(1, -1), (0, 2), (3, -1)}


def _tiles(tm, tk, tn, dtype=torch.float32, n=4):
    return (torch.ones((n, tm, tk), dtype=dtype),
            torch.ones((n, tk, tn), dtype=dtype))


@pytest.mark.parametrize("tm,tk,tn,dtype,takes", [
    (64, 256, 256, torch.float32, True),      # the expert cell's tiles
    (192, 128, 128, torch.float32, True),
    (64, 32, 128, torch.float32, True),
    (64, 256, 256, torch.bfloat16, False),    # bf16: the thin block
    (32, 128, 128, torch.float32, False),     # tm 32
    (8, 128, 128, torch.float32, False),
    (128, 256, 256, torch.float32, False),    # the wide tensor-core block
    (64, 256, 64, torch.float32, False),      # tn 64: SIMT
    (64, 48, 128, torch.float32, False),      # tk 48: SIMT
])
def test_the_rule_of_the_schedule(tm, tk, tn, dtype, takes):
    a, b = _tiles(tm, tk, tn, dtype)
    tp = np.array([0, 2, 2, 4], np.int64)
    got = wg_schedule(a, b, np.array([0, 1, 0, 1], np.int32), tp)
    assert (got is not None) == takes
    if takes:
        assert got.units.dtype == torch.int32 and got.units.shape[1] == 2
        assert got.pairs + got.singles == got.units.shape[0]


def test_the_rule_leaves_masked_and_empty_launches_alone():
    a, b = _tiles(64, 256, 256)
    tp = np.array([0, 2, 2, 4], np.int64)
    bi = np.array([0, 1, 0, 1], np.int32)
    kept = engine.SliceMask(torch.zeros((4, 1), dtype=torch.int32), 32, 8)
    unkept = engine.SliceMask(None, 32, 32)
    assert wg_schedule(a, b, bi, tp, kept) is None
    assert wg_schedule(a, b, bi, tp, unkept) is not None
    assert wg_schedule(a, b, bi[:0], np.zeros(4, np.int64)) is None


@pytest.mark.parametrize("a_fixed", [True, False])
def test_a_prepared_call_carries_the_schedule_on_its_ids(monkeypatch,
                                                         a_fixed):
    """The schedule rides on the uploaded a_tid, so the prepared call still
    passes tile_spgemm its five operands; A rewritten in place
    (``a_fixed=False``) keeps no mask and still takes the block."""
    a, b, ai, bi, o, n_c = grouped(64, 64, 128, run=3)
    seen = []

    def five(a_t, b_t, a_tid, b_tid, tile_ptr):
        seen.append(a_tid.wg_schedule)
        return "C"

    call = prepare_cached(torch.from_numpy(a), torch.from_numpy(b), ai, bi,
                          o, n_c, a_fixed=a_fixed)
    assert call.schedule is not None and call.schedule.pairs == 4
    monkeypatch.setattr(engine, "tile_spgemm", five)
    assert call() == "C" and seen == [call.schedule]


def test_a_prepared_call_on_the_cpu_is_the_plain_product():
    a, b, ai, bi, o, n_c = grouped(64, 64, 128, run=3)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    call = prepare_cached(at, bt, ai, bi, o, n_c)
    ref = run_worklist_reference(at, bt, *(torch.from_numpy(x)
                                           for x in (ai, bi, o)), n_c)
    assert torch.equal(call(), ref)


@pytest.mark.parametrize("tm,tk,tn,dtype,block,pieces", [
    (64, 256, 256, "float32", "mma_thin", 2),     # the expert cell
    (32, 128, 128, "float32", "mma_thin", 1),     # prefill-16k
    (32, 128, 128, "bfloat16", "mma_thin", 1),    # its control
    (256, 256, 256, "float32", "mma", 4),
])
def test_tile_block_and_block_pieces_are_unchanged(tm, tk, tn, dtype, block,
                                                   pieces):
    """The planner prices the blocks it did: the warpgroup block changes
    neither the name tile_block gives a shape nor its blocks per C tile."""
    assert engine.tile_block(tm, tk, tn, dtype) == block
    assert block_pieces(tm, tk, tn, 2 if dtype == "bfloat16" else 4) == pieces


def test_a_warpgroup_launch_counts_once_per_product(monkeypatch):
    """A launch on the block counts as tile_spgemm and tile_spgemm_wg_thin;
    the benchmark's count leaves the _thin name out."""
    from gpu_bench import system

    monkeypatch.setattr(_build, "launches", collections.Counter())
    for _ in range(3):
        _build.launches["tile_spgemm"] += 1
        _build.launches["tile_spgemm" + engine.EXTRA_COUNT["mma_wg"]] += 1
    assert system.launches() == 3
    assert engine._BLOCKS.index("mma_wg") == 4


@pytest.mark.parametrize("case",
                         ["bf16", "tm32", "mask", "units", "pieces"])
def test_a_schedule_the_block_cannot_run_raises(case):
    """The wrapper checks the schedule on a_tid before any launch (on the
    CPU too): f32 tiles of tm a multiple of 64, no slice mask, int32 [U, 2]
    units, built for as many pieces as the launch has."""
    tm = 32 if case == "tm32" else 64
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    a, b, ai, bi, o, n_c = grouped(tm, 64, 128, run=2)
    at, bt = (torch.from_numpy(x).to(dtype) for x in (a, b))
    tp = tile_ptr_of(o, n_c)
    units = torch.from_numpy(wg_units(tp, bi, 1))
    pieces = n_c * max(tm // 64, 1) + (case == "pieces")
    sched = engine.WgSchedule(units.long() if case == "units" else units,
                              0, 0, pieces)
    mask = (engine.SliceMask(torch.zeros((len(ai), 1), dtype=torch.int32),
                             4, 2) if case == "mask" else None)
    a_tid = torch.from_numpy(ai)
    a_tid.wg_schedule = sched
    with pytest.raises(ValueError):
        tile_spgemm(at, bt, a_tid, *(torch.from_numpy(x) for x in (bi, tp)),
                    mask=mask)


@pytest.mark.parametrize("tm,dtype,block", [
    (64, torch.float32, "mma_wg"),
    (32, torch.float32, "mma_thin"),
    (64, torch.bfloat16, "mma_thin"),
    (128, torch.float32, "mma"),
])
def test_a_prepared_call_names_the_block_it_launches(tm, dtype, block):
    """``call.block``: the warpgroup block under a schedule, else the
    block tile_block names; None where there is nothing to launch."""
    a, b, ai, bi, o, n_c = grouped(tm, 256, 256, run=2)
    at, bt = (torch.from_numpy(x).to(dtype) for x in (a, b))
    call = prepare_cached(at, bt, ai, bi, o, n_c)
    assert call.block == block
    assert (call.schedule is not None) == (block == "mma_wg")
    empty = prepare_cached(at, bt, ai[:0], bi[:0], o[:0], n_c)
    assert empty.block is None and empty.schedule is None


def test_the_sweep_runs_the_plain_version_on_the_cpu():
    """tools/sweep_wgmma at a small size on the CPU: both cases gated
    against float64 and the plain version, untimed, each with the block a
    card runs it on and the bound."""
    from spada_tpu_torch.tools import sweep_wgmma

    rows = sweep_wgmma.run(experts=2, rows=96, k_tiles=2, cols=2, T=128,
                           device="cpu", log=lambda s: None)
    assert [(r["kernel"], r["block"]) for r in rows] == [
        ("thin", "mma_thin"), ("wg", "mma_wg")]
    assert all(r["ms"] is None and r["err"] <= sweep_wgmma.TOL
               and r["plain_err"] == 0.0 and r["plain_ms"] is None
               and r["bound_ms"] > 0 for r in rows)
    op = sweep_wgmma.grouped_product(3, 100, 2, 2, 128, 0,
                                     torch.device("cpu"))
    # every panel's rows sit in one or two experts' k-tiles
    assert op["panels"] == -(-int(op["counts"].sum()) // 64)
    assert op["flop"] == 2 * int(op["counts"].sum()) * 2 * 128 * 2 * 128


# ---- the kernel, on the card ---------------------------------------------------

def _relerr(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def _f64(a, b, ai, bi, o, n_c):
    c = torch.zeros((n_c, a.shape[1], b.shape[2]), dtype=torch.float64,
                    device=a.device)
    for s in range(0, len(ai), 64):
        sl = slice(s, s + 64)
        c.index_add_(0, o[sl].long(), torch.bmm(a[ai[sl].long()].double(),
                                                 b[bi[sl].long()].double()))
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("run", [1, 8, 64])
@pytest.mark.parametrize("tk,tn", [(256, 256), (512, 512), (256, 512)])
@pytest.mark.parametrize("tm", [64, 128, 192])
def test_the_block_matches_plain_and_f64(cuda_device, tm, tk, tn, run):
    """Runs of 1, 8 and 64 items of grouped panels, pairs and singles (an
    odd panel, a straddler, an empty C tile written as exact zeros): 1e-5
    of max|C| against the plain version and the f64 product.  tm 64 and
    192 take the block through prepare_cached; tm 128, which the wide
    tensor-core block runs there, through a schedule set on a_tid."""
    a, b, ai, bi, o, n_c = grouped(tm, tk, tn, run, seed=tm + tk + run)

    def dev(x):
        return torch.from_numpy(x).to(cuda_device)

    at, bt = dev(a), dev(b)
    before = _build.launches.copy()
    if tm == 128:
        tp = tile_ptr_of(o, n_c)
        a_tid = dev(ai)
        a_tid.wg_schedule = engine.WgSchedule(dev(wg_units(tp, bi, 2)), 0, 0,
                                              n_c * 2)
        got = tile_spgemm(at, bt, a_tid, dev(bi), dev(tp))
    else:
        call = prepare_cached(at, bt, ai, bi, o, n_c)
        assert call.schedule is not None and call.schedule.singles > 0
        got = call()
    ids = [dev(x) for x in (ai, bi, o)]
    ref = run_worklist_reference(at, bt, *ids, n_c)
    exact = _f64(at, bt, *ids, n_c)
    torch.cuda.synchronize()
    assert _build.launches - before == collections.Counter(
        {"tile_spgemm": 1, "tile_spgemm_wg_thin": 1})
    assert _relerr(got, ref) <= 1e-5
    assert _relerr(got.double(), exact) <= 1e-5
    empty = torch.from_numpy(np.diff(tile_ptr_of(o, n_c)) == 0).to(
        cuda_device)
    assert bool(empty.any()) and bool((got[empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tm32", "bf16", "masked"])
def test_other_prepared_launches_stay_on_the_thin_block(cuda_device, case):
    """A prepared launch at tm 32, of bf16 tiles, or with a slice mask kept
    reports the thin block and gives the direct launch's C bit for bit."""
    tm, dtype = (32, torch.float32) if case == "tm32" else (
        (64, torch.bfloat16) if case == "bf16" else (64, torch.float32))
    a, b, ai, bi, o, n_c = grouped(tm, 256, 256, 8, seed=3)
    if case == "masked":
        a[:, :, 32:224] = 0     # six of each A tile's eight k-slices empty
    at = torch.from_numpy(a).to(cuda_device, dtype)
    bt = torch.from_numpy(b).to(cuda_device, dtype)
    call = prepare_cached(at, bt, ai, bi, o, n_c)
    assert call.schedule is None
    assert (call.mask is not None and call.mask.words is not None) == (
        case == "masked")
    before = _build.launches.copy()
    got = call()
    direct = tile_spgemm(at, bt, *(torch.from_numpy(x).to(cuda_device)
                                   for x in (ai, bi, tile_ptr_of(o, n_c))))
    torch.cuda.synchronize()
    assert _build.launches - before == collections.Counter(
        {"tile_spgemm": 2, "tile_spgemm_thin": 2})
    assert torch.equal(got, direct)


@pytest.mark.cuda
def test_the_expert_cell_at_a_tiny_size(cuda_device):
    """The expert cell cut to a test's size, planned and run by the
    benchmark's harness through prepare_worklist on the card: its launches
    run on the warpgroup block and its products are correct."""
    from gpu_bench import harness
    from gpu_bench.cells import load_cell

    cell = load_cell("deepseek-v3-experts-ep32.prefill-4k")
    # at these widths the card's planner takes tm 64 x 256 x 256 tiles
    cell.config.update({"hidden_size": 1024, "moe_intermediate_size": 512})
    cell.traffic.update({"tokens": 8192})
    inputs = harness.make_inputs(cell, 7)
    run = harness.plan_cell(cell, inputs, cuda_device, lambda msg: None)
    before = _build.launches.copy()
    out = harness.measure(cell, inputs, run, 7, 0.05, cuda_device)
    ran = _build.launches - before
    assert out["correct"], out
    assert ran["tile_spgemm_wg_thin"] == ran["tile_spgemm"] > 0, ran
