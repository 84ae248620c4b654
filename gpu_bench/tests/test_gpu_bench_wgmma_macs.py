"""The reader of ``tile_wgmma_macs_pct`` on ``launch`` spans made by hand:
the window's multiply-adds on the warpgroup block over all its tile
launches' multiply-adds; a port whose launches carry no ``macs`` reads
None."""

import collections

import pytest

from gpu_bench import harness
from gpu_bench.cells import load_part
from spada_tpu_torch.utils import trace


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(trace, "_done",
                        collections.deque(maxlen=trace.LIMIT))


def _launch(kernel, block=None, **attrs):
    t = trace.launch(kernel, items=4, **attrs)
    if block is not None:
        t.step("launch.alloc", block=block)
    t.end()


def _read(launches):
    rec = harness.Record("c", "cuda", products=launches, launches=launches)
    return load_part("metrics", "tile_wgmma_macs_pct").read(rec)


def test_the_window_share_on_the_warpgroup_block(fresh):
    # before the window: left out by the count of the window's launches
    _launch("tile_spgemm", "mma_thin", macs=10**9)
    _launch("tile_spgemm", "mma_wg", macs=300)
    _launch("esc_stream_group")
    _launch("tile_spgemm", "mma_thin", macs=100)
    assert _read(3) == pytest.approx(75.0)
    assert _read(4) == pytest.approx(100 * 300 / (10**9 + 400))


@pytest.mark.parametrize("block", ["mma_thin", "mma", "plain"])
def test_no_launch_on_the_block_reads_zero(fresh, block):
    """The parent port, and a cell whose launches stay on the thin block
    (``prefill-16k``): 0."""
    _launch("tile_spgemm", block, macs=4 * 32 * 128 * 128)
    _launch("tile_spgemm", block, macs=4 * 32 * 128 * 128)
    assert _read(2) == 0


def test_launches_without_macs_read_none(fresh):
    assert _read(2) is None
    _launch("esc_stream_group")
    _launch("esc_stream_group")
    assert _read(2) is None


def test_a_port_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(trace, "spans")
    assert _read(1) is None


def test_a_tiny_traced_run_of_the_expert_cell(fresh, monkeypatch):
    """The expert cell cut to a test's size on the CPU: its launches carry
    ``macs`` and run the plain version, so none is on the block."""
    from gpu_bench.tests.test_gpu_bench_port_spans import _measure

    monkeypatch.setattr(trace, "_enabled", True)
    assert load_part("metrics", "tile_wgmma_macs_pct").read(
        _measure("deepseek-v3-experts-ep32.prefill-4k")) == 0
