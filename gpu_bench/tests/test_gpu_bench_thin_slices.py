"""The reader of ``thin_slices_run_pct`` on ``launch`` spans made by hand:
the window's spans that carry slice counts give their share, the others
count for nothing, and no such span gives None."""

import collections

import pytest

from gpu_bench import harness
from gpu_bench.cells import load_part
from spada_tpu_torch.utils import trace


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(trace, "_done",
                        collections.deque(maxlen=trace.LIMIT))


def _launch(kernel, **attrs):
    trace.launch(kernel, items=4, **attrs).end()


def _read(launches):
    rec = harness.Record("c", "cuda", products=launches, launches=launches)
    return load_part("metrics", "thin_slices_run_pct").read(rec)


def test_the_window_share_of_slices_run(fresh):
    # before the window: left out by the count of the window's launches
    _launch("tile_spgemm", slices=100, slices_run=100)
    _launch("tile_spgemm", slices=731_136, slices_run=209_664)
    _launch("esc_stream_group")
    _launch("tile_spgemm", slices=731_136, slices_run=209_664)
    assert _read(3) == pytest.approx(100 * 209_664 / 731_136)
    assert _read(3) == pytest.approx(28.676470588)
    assert _read(4) == pytest.approx(100 * 419_428 / 1_462_372)


def test_no_masked_launch_reads_none(fresh):
    assert _read(2) is None
    _launch("tile_spgemm")
    _launch("esc_stream_group")
    assert _read(2) is None


def test_a_port_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(trace, "spans")
    assert _read(1) is None


def test_a_tiny_traced_run_of_the_tile_cell(fresh, monkeypatch):
    """The tile cell cut to a test's size plans thin row panels on 32 x
    32-pruned W2: its launches skip most k-slices, the element cell's
    launches carry none."""
    from gpu_bench.tests.test_gpu_bench_port_spans import _measure

    monkeypatch.setattr(trace, "_enabled", True)
    share = load_part("metrics", "thin_slices_run_pct").read(
        _measure("opt-1.3b-fc2-blk32.prefill-16k"))
    assert 0 < share < 50
    trace.clear()
    assert load_part("metrics", "thin_slices_run_pct").read(
        _measure("graph500-s14-sym.a2-reuse")) is None
