"""The port's copies of the host modules against the JAX package's own.

``spada_tpu_torch`` imports nothing of ``spada_tpu``: it carries copies of
the host layer (config, CSR/BSR, MatrixMarket reader, workload generators,
planners, densify, the C++ ESC planner, the traffic model, the CLI's host
modes).  Each case gives the reference and the copy the same inputs, each
package building its own objects from the same seeds, and requires equal
results: arrays equal element for element, numbers equal exactly.
"""

import dataclasses
import fcntl
import os
import shutil
import tempfile

import numpy as np
import pytest

import spada_tpu_torch
from spada_tpu import cli as ref_cli
from spada_tpu import native as ref_native
from spada_tpu.config import SpadaConfig as RefConfig
from spada_tpu.io import mtx as ref_mtx
from spada_tpu.io import workloads as ref_wl
from spada_tpu.models.traffic import simulate_traffic as ref_traffic
from spada_tpu.plan import densify as ref_densify
from spada_tpu.plan import planner as ref_planner
from spada_tpu.sparse import bsr as ref_bsr
from spada_tpu_torch import cli as port_cli
from spada_tpu_torch import native as port_native
from spada_tpu_torch.config import SpadaConfig as PortConfig
from spada_tpu_torch.config import datasheet_peaks
from spada_tpu_torch.convert import from_reference
from spada_tpu_torch.io import mtx as port_mtx
from spada_tpu_torch.io import workloads as port_wl
from spada_tpu_torch.models.traffic import simulate_traffic as port_traffic
from spada_tpu_torch.plan import densify as port_densify
from spada_tpu_torch.plan import execute as port_execute
from spada_tpu_torch.plan import planner as port_planner
from spada_tpu_torch.sparse import bsr as port_bsr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATRICES = os.path.join(ROOT, "matrices")

# The reference's native library builds with g++ into one fixed path under
# a lock that guards threads, not processes: pytest-xdist workers that build
# or load it at once can read a half-written file, and the reference then
# takes its NumPy fallback for good, so its native tests skip.  Every worker
# imports this file while collecting, before any test runs; building or
# loading the library here, one process at a time, leaves it whole for all.
with open(os.path.join(tempfile.gettempdir(), "spada_native_build.lock"),
          "w") as _lock:
    fcntl.flock(_lock, fcntl.LOCK_EX)
    try:
        ref_native.load()
    finally:
        fcntl.flock(_lock, fcntl.LOCK_UN)


def _pair(wl, io_mtx, name):
    """(A, B) of one workload, built by one package's own modules."""
    if name in ("cari", "lap5_32"):
        m = io_mtx.load_mtx(os.path.join(MATRICES, f"{name}.mtx"))
        w = wl.GemmWorkload.from_matrix(name, m)
        return w.a, w.b
    if name == "banded":
        return (wl.banded_csr(512, 512, 24, seed=0, dtype=np.float32),
                wl.banded_csr(512, 512, 24, seed=1, dtype=np.float32))
    if name == "nn":
        return (wl.block_sparse_csr(512, 512, 64, 0.2, seed=5),
                wl.relu_activation_csr(512, 128, 0.35, seed=6))
    if name == "locpl":
        return (wl.localized_powerlaw_csr(1024, 1024, 8.0, seed=1,
                                          dtype=np.float32),
                wl.localized_powerlaw_csr(1024, 1024, 8.0, seed=2,
                                          dtype=np.float32))
    if name == "fem":
        m = wl.fem_q1_graded_csr(24, 20, grading=1.1)
        return m, m
    raise KeyError(name)


WORKLOADS = ["cari", "lap5_32", "banded", "nn", "locpl", "fem"]


@pytest.fixture(scope="module")
def pairs():
    """name -> (reference (A, B), port (A, B)), built once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (_pair(ref_wl, ref_mtx, name),
                           _pair(port_wl, port_mtx, name))
        return cache[name]

    return get


def _same(x, y, path="value"):
    """Exact equality of numbers, arrays, and containers and dataclasses of
    them; the classes may differ (one from each package)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        assert dataclasses.is_dataclass(y), path
        x, y = dataclasses.asdict(x), dataclasses.asdict(y)
    if isinstance(x, dict):
        assert isinstance(y, dict) and x.keys() == y.keys(), path
        for k in x:
            _same(x[k], y[k], f"{path}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y), path
        for i, (u, v) in enumerate(zip(x, y)):
            _same(u, v, f"{path}[{i}]")
    elif isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), path
    elif x is None or y is None:
        assert x is y, path
    else:
        assert type(x) is type(y) and x == y, f"{path}: {x!r} != {y!r}"


def _csr_same(x, y):
    _same((x.shape, x.indptr, x.indices, x.data),
          (y.shape, y.indptr, y.indices, y.data))


def _configs():
    """The reference's and the port's SpadaConfig with the H100 peaks."""
    peaks = datasheet_peaks()
    return RefConfig(**peaks), PortConfig(**peaks)


def _plan_tuple(plan):
    return ([(p.row_start, p.row_end, p.tm) for p in plan.panels],
            plan.tile_k, plan.tile_n, plan.meta)


# ---- io, generators, formats ----------------------------------------------

@pytest.mark.parametrize("name", WORKLOADS)
def test_workloads_equal(pairs, name):
    (ra, rb), (pa, pb) = pairs(name)
    assert type(pa).__module__ == "spada_tpu_torch.sparse.csr"
    _csr_same(ra, pa)
    _csr_same(rb, pb)


@pytest.mark.parametrize("name", WORKLOADS)
def test_bsr_and_tiles_equal(pairs, name):
    (ra, _), (pa, _) = pairs(name)
    for tm, tn in ((64, 128), (128, 128)):
        _same(ref_bsr.BsrMatrix.from_csr(ra, tm, tn),
              port_bsr.BsrMatrix.from_csr(pa, tm, tn))
        _same(ref_bsr.tiles_of_csr(ra, tm, tn),
              port_bsr.tiles_of_csr(pa, tm, tn))


def test_nn_pickle_generator_equal():
    from spada_tpu.models.nn_workloads import make_nn_gemms as ref_make
    from spada_tpu_torch.models.nn_workloads import make_nn_gemms

    layers = {"fc": ((96, 64), 16), "proj": ((64, 64), 8)}
    ref, got = ref_make(layers=layers), make_nn_gemms(layers=layers)
    assert ref.keys() == got.keys()
    for k in ref:
        for r, g in zip(ref[k], got[k]):
            _same((r.indptr, r.indices, r.data), (g.indptr, g.indices, g.data))


# ---- planners ---------------------------------------------------------------

@pytest.mark.parametrize("name", WORKLOADS)
def test_choose_tile_size_equal(pairs, name):
    (ra, rb), (pa, pb) = pairs(name)
    rc, pc = _configs()
    _same(ref_planner.choose_tile_size(ra, rb, rc),
          port_planner.choose_tile_size(pa, pb, pc))


@pytest.mark.parametrize("name", WORKLOADS)
def test_plan_spgemm_equal(pairs, name):
    (ra, rb), (pa, pb) = pairs(name)
    rc, pc = _configs()
    ref = ref_planner.plan_spgemm(ra, rb, rc)
    got = port_planner.plan_spgemm(pa, pb, pc)
    _same(_plan_tuple(ref), _plan_tuple(got))
    # the execution half: the rows each panel height stacks
    for tm in {p.tm for p in got.panels}:
        panels = [p for p in got.panels if p.tm == tm]
        rs, rbase = ref_planner._slice_rows_padded(ra, panels, tm)
        ps, pbase = port_execute._slice_rows_padded(pa, panels, tm)
        _csr_same(rs, ps)
        _same(rbase, pbase)


@pytest.mark.parametrize("name", WORKLOADS)
def test_plan_op_dataflow_equal(pairs, name):
    (ra, rb), (pa, pb) = pairs(name)
    rc, pc = _configs()
    for scheme in (1, 2):
        _same(ref_planner.plan_op_dataflow(ra, rb, rc, scheme=scheme),
              port_planner.plan_op_dataflow(pa, pb, pc, scheme=scheme))


@pytest.mark.parametrize("name", WORKLOADS)
def test_densify_equal(pairs, name):
    (ra, rb), (pa, pb) = pairs(name)
    rc, pc = _configs()
    ref = ref_densify.choose_densify(ra, rb, 128, 128, 128, rc)
    got = port_densify.choose_densify(pa, pb, 128, 128, 128, pc)
    _same(ref, got)
    for x, y in zip(ref_densify.apply_densify(ra, rb, ref),
                    port_densify.apply_densify(pa, pb, got)):
        _csr_same(x, y)


@pytest.mark.parametrize("name", ["lap5_32", "banded", "nn", "locpl", "fem"])
def test_native_esc_plan_equal(pairs, name):
    """The C++ ESC planner built from the port's own source, into the
    port's build directory (cari's 19M products are left out for time)."""
    (ra, rb), (pa, pb) = pairs(name)
    assert port_native.load() is not None
    assert os.path.dirname(port_native._SO) == os.path.join(
        os.path.dirname(spada_tpu_torch.__file__), "_build")
    e = int(np.dot(np.bincount(pa.indices, minlength=pa.shape[1]),
                   np.diff(pb.indptr)))
    args = (pb.shape[0], 512, e)
    ref = ref_native.esc_plan(ra.indptr, ra.indices, rb.indptr, rb.indices,
                              *args)
    got = port_native.esc_plan(pa.indptr, pa.indices, pb.indptr, pb.indices,
                               *args)
    counts = got[0]
    nnz_c, chunks, n_padded = (int(x) for x in counts[:3])
    _same(ref[0], counts)
    trims = (nnz_c, pa.shape[0], 32, 32, chunks, n_padded, n_padded)
    for r, g, n in zip(ref[1:], got[1:], trims):
        _same(r[:n], g[:n])


def test_reference_native_library_loads():
    """Where g++ is found, the reference's native library loaded whole in
    this worker (the lock at the top of this file), so the reference's own
    native tests run instead of skipping."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the reference takes its NumPy fallbacks")
    assert ref_native.load() is not None


@pytest.mark.parametrize("name", WORKLOADS)
def test_traffic_report_equal(pairs, name):
    (ra, rb), (pa, pb) = pairs(name)
    rc, pc = _configs()
    _same(ref_traffic(ra, rb, rc, compute_values=False).report,
          port_traffic(pa, pb, pc, compute_values=False).report)


def test_config_from_json_equal():
    path = os.path.join(ROOT, "config", "default.json")
    _same(RefConfig.from_json(path), PortConfig.from_json(path))
    _same(RefConfig(), PortConfig())


# ---- the CLI's host modes -------------------------------------------------

@pytest.mark.parametrize("mode", ["traffic", "breuse"])
def test_cli_host_modes_equal(mode, capsys):
    argv = [mode, "spada", "SS", "cari", "config/default.json"]
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        assert ref_cli.main(argv) == 0
        ref = capsys.readouterr().out
        assert port_cli.main(argv) == 0
        got = capsys.readouterr().out
    finally:
        os.chdir(cwd)
    assert got == ref and "cari" in got


# ---- the converter --------------------------------------------------------

@pytest.mark.parametrize("name", ["cari", "nn"])
def test_from_reference(pairs, name):
    (ra, rb), (pa, pb) = pairs(name)
    got = from_reference(ra)
    assert type(got) is type(pa)
    _csr_same(got, pa)
    bsr = from_reference(ref_bsr.BsrMatrix.from_csr(ra, 64, 128))
    assert type(bsr) is port_bsr.BsrMatrix
    _same(bsr, port_bsr.BsrMatrix.from_csr(pa, 64, 128))
    rc, pc = _configs()
    plan = from_reference(ref_planner.plan_spgemm(ra, rb, rc))
    assert type(plan) is port_planner.ExecutionPlan
    assert all(type(p) is port_planner.PanelSpec for p in plan.panels)
    _same(_plan_tuple(plan), _plan_tuple(port_planner.plan_spgemm(pa, pb, pc)))
    with pytest.raises(TypeError, match="no port counterpart"):
        from_reference(object())


# ---- the distributed strategies' host side --------------------------------

from spada_tpu.parallel import element_dp as ref_edp  # noqa: E402
from spada_tpu.parallel import halo as ref_halo  # noqa: E402
from spada_tpu.parallel import partition as ref_part  # noqa: E402
from spada_tpu.parallel import scaling as ref_scaling  # noqa: E402
from spada_tpu_torch.parallel import element_dp as port_edp  # noqa: E402
from spada_tpu_torch.parallel import halo as port_halo  # noqa: E402
from spada_tpu_torch.parallel import partition as port_part  # noqa: E402
from spada_tpu_torch.parallel import scaling as port_scaling  # noqa: E402


@pytest.mark.parametrize("name", WORKLOADS)
def test_partition_spgemm_equal(pairs, name):
    (ra, rb), (pa, pb) = pairs(name)
    for n_dp, n_tp in ((2, 2), (3, 1)):
        ref = ref_part.partition_spgemm(ra, rb, n_dp, n_tp, tm=64)
        got = port_part.partition_spgemm(pa, pb, n_dp, n_tp, tm=64)
        _same(ref, got)
        assert ref.imbalance == got.imbalance
        _same(from_reference(ref), got)


@pytest.mark.parametrize("name", WORKLOADS)
def test_partition_halo_equal(pairs, name):
    (ra, rb), (pa, pb) = pairs(name)
    ref = ref_halo.partition_halo(ra, rb, 4, tm=64)
    got = port_halo.partition_halo(pa, pb, 4, tm=64)
    _same(ref, got)
    _same(from_reference(ref), got)


@pytest.mark.parametrize("name", ["lap5_32", "banded", "nn", "locpl", "fem"])
def test_partition_element_equal(pairs, name):
    (ra, rb), (pa, pb) = pairs(name)
    ref = ref_edp.partition_element(ra, rb, 3)
    got = port_edp.partition_element(pa, pb, 3)
    _same(ref, got)
    np.testing.assert_array_equal(ref.e_per_shard, got.e_per_shard)
    _same(from_reference(ref), got)


@pytest.mark.parametrize("name", WORKLOADS)
def test_choose_parallel_strategy_equal(pairs, name):
    (ra, rb), (pa, pb) = pairs(name)
    rc, pc = _configs()
    for n_dev in (2, 4):
        _same(ref_part.choose_parallel_strategy(ra, rb, n_dev, rc, tm=64),
              port_part.choose_parallel_strategy(pa, pb, n_dev, pc, tm=64))


@pytest.mark.parametrize("name", ["cari", "banded", "nn"])
def test_scaling_estimates_equal(pairs, name):
    """At the reference's config values, and at the card's link rate."""
    (ra, rb), (pa, pb) = pairs(name)
    halo = (ref_halo.partition_halo(ra, rb, 4, tm=64),
            port_halo.partition_halo(pa, pb, 4, tm=64))
    red = (ref_part.partition_spgemm(ra, rb, 2, 2, tm=64),
           port_part.partition_spgemm(pa, pb, 2, 2, tm=64))
    for rc, pc in ((RefConfig(), PortConfig()), _configs()):
        _same(ref_scaling.estimate_halo_scaling(halo[0], rc),
              port_scaling.estimate_halo_scaling(halo[1], pc))
        _same(ref_scaling.estimate_reduce_scaling(red[0], rc),
              port_scaling.estimate_reduce_scaling(red[1], pc))
        assert (port_scaling.estimate_halo_scaling(halo[1], pc).as_dict()
                == ref_scaling.estimate_halo_scaling(halo[0], rc).as_dict())


def test_package_exports_equal_reference():
    """The reference's top-level surface, bound to the port's classes."""
    import spada_tpu
    from spada_tpu_torch.sparse.csr import CsrMatrix

    assert spada_tpu_torch.__all__ == spada_tpu.__all__
    assert spada_tpu_torch.SpadaConfig is PortConfig
    assert spada_tpu_torch.CsrMatrix is CsrMatrix
    assert spada_tpu_torch.GemmWorkload is port_wl.GemmWorkload
    assert spada_tpu_torch.__version__ == spada_tpu.__version__


def test_datasheet_link_rate():
    assert datasheet_peaks()["ici_bytes_per_s"] == 450e9
    assert datasheet_peaks("NVIDIA H100 PCIe")["ici_bytes_per_s"] == 64e9
    assert datasheet_peaks("NVIDIA H100 NVL")["ici_bytes_per_s"] == 300e9
    assert datasheet_peaks("NVIDIA H200")["ici_bytes_per_s"] == 450e9


# ---- the panel planner ------------------------------------------------------

from spada_tpu.ops import panelplan as ref_pp  # noqa: E402
from spada_tpu.ops.worklist import build_worklist as ref_worklist  # noqa: E402
from spada_tpu_torch.ops import panelplan as port_pp  # noqa: E402


def _panel_streams():
    """(ids, run_ptr) streams: both operands of a banded worklist, and
    random runs of distinct tiles (the fuzz of tests/test_panel.py)."""
    a = ref_wl.banded_csr(512, 512, bandwidth=96, seed=0, dtype=np.float32)
    A = ref_bsr.BsrMatrix.from_csr(a, 64, 64, dtype=np.float32)
    wl = ref_worklist(A, A, order="row")
    ptr = np.searchsorted(wl.o_tid, np.arange(wl.n_c_tiles + 1)).astype(
        np.int64)
    out = [(wl.a_tid, ptr), (wl.b_tid, ptr)]
    rng = np.random.default_rng(0)
    for _ in range(4):
        lens = rng.integers(1, 8, 40)
        ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        ids = np.concatenate([rng.choice(25, n, replace=False) for n in lens])
        out.append((ids.astype(np.int64), ptr))
    return out, wl


@pytest.mark.parametrize("native", [True, False])
def test_plan_panel_cache_equal(monkeypatch, native):
    if not native:
        # both packages' NumPy planners
        monkeypatch.setattr(ref_native, "plan_panel_cache",
                            lambda *a: None)
        monkeypatch.setattr(port_native, "plan_panel_cache",
                            lambda *a: None)
    else:
        assert port_native.load() is not None
    streams, _ = _panel_streams()
    for ids, ptr in streams:
        for slots, depth, max_panel in ((12, 3, 4), (16, 0, 2), (8, 2, 1)):
            _same(ref_pp.plan_panel_cache(ids, ptr, slots, depth, max_panel),
                  port_pp.plan_panel_cache(ids, ptr, slots, depth, max_panel))


def test_run_orders_equal():
    _, wl = _panel_streams()
    ptr = np.searchsorted(wl.o_tid, np.arange(wl.n_c_tiles + 1))
    for order in ("row", "col", "diag"):
        perm = port_pp.order_runs(wl.c_tile_row, wl.c_tile_col, order)
        _same(ref_pp.order_runs(wl.c_tile_row, wl.c_tile_col, order), perm)
        _same(ref_pp.permute_runs(perm, ptr, wl.a_tid, wl.b_tid),
              port_pp.permute_runs(perm, ptr, wl.a_tid, wl.b_tid))
    for slots in ((12, 16), (16, 12)):
        _same(ref_pp.choose_run_order(wl.a_tid, wl.b_tid, ptr, wl.c_tile_row,
                                      wl.c_tile_col, *slots),
              port_pp.choose_run_order(wl.a_tid, wl.b_tid, ptr,
                                       wl.c_tile_row, wl.c_tile_col, *slots))
    with pytest.raises(ValueError, match="unknown run order"):
        port_pp.order_runs(wl.c_tile_row, wl.c_tile_col, "zigzag")
