"""Tiny sizes of the cells added after ``tests/test_gpu_bench_faults.py``'s
``TINY`` was written, registered there before any test runs, so that every
test parametrized over the benchmark's cells runs them too (on the CPU, at a
size a test can hold, on the side their plan takes)."""

TINY = {
    "deepseek-v3-experts-ep32.prefill-4k": (
        {"hidden_size": 256, "moe_intermediate_size": 128}, {"tokens": 512},
        "tile"),
}


def pytest_configure(config):
    from gpu_bench.tests import test_gpu_bench_faults as faults

    for name in faults.CELLS:
        if name in TINY:
            faults.TINY.setdefault(name, TINY[name])
