"""The ``tile_spgemm_roofline`` reader on device traces made by hand."""

import pytest

from gpu_bench import counts, harness
from gpu_bench.cells import load_part

roofline = load_part("metrics", "tile_spgemm_roofline")
EXPERTS = "deepseek-v3-experts-ep32.prefill-4k"
THIN = "void tile_spgemm_thin<float, 64, false>(float const*, int)"


def _rec(cell, ops, products=4, flop=8 * 10**12, nbytes=10**9):
    trace = None if ops is None else {"device_ops": ops}
    return harness.Record(cell, "cuda", products=products, flop=flop,
                          nbytes=nbytes, trace=trace)


def test_f32_tiles_are_held_to_a_third_of_the_tf32_rate():
    assert roofline.PEAK_TILE_FLOP_S["float32"] == pytest.approx(165e12)
    assert roofline.PEAK_TILE_FLOP_S["float32"] > 2 * counts.PEAK_F32_FLOP_S
    # compute-bound: the operations' time; memory-bound: the bytes'
    assert roofline.least_time(165 * 10**12, 1, "float32") == pytest.approx(1)
    assert roofline.least_time(1, 3.35e12, "bfloat16") == pytest.approx(1)
    assert roofline.least_time(989 * 10**12, 1, "bfloat16") == pytest.approx(1)


def test_the_tile_kernels_time_per_product():
    # 4 products of 8 TFLOP in 0.8 s of the thin kernel: 0.2 s each against
    # a least time of 8e12 / 165e12 s; the memset is not the kernel's
    ops = [[THIN, 0.6], ["Memset (Device)", 0.5],
           ["void tile_spgemm_mma<float>(float const*)", 0.2]]
    got = roofline.read(_rec(EXPERTS, ops))
    assert got == pytest.approx(100 * (8e12 / 165e12) / 0.2)


@pytest.mark.parametrize("ops,products", [
    (None, 4),                                    # no device trace
    ([["esc_stream_group_kernel", 0.3]], 4),      # the element side
    ([[THIN, 0.3]], 0)])                          # no product completed
def test_nothing_to_read_reads_none(ops, products):
    assert roofline.read(_rec(EXPERTS, ops, products)) is None
