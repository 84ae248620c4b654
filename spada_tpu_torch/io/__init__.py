"""Copy of :mod:`spada_tpu.io`
for spada_tpu_torch, held equal to it by ``tests/test_torch_host.py``; only
the imports differ."""
from spada_tpu_torch.io.mtx import load_mtx
from spada_tpu_torch.io.workloads import (
    GemmWorkload,
    load_pickled_gemms,
    sort_by_length,
)

__all__ = [
    "load_mtx",
    "GemmWorkload",
    "load_pickled_gemms",
    "sort_by_length",
]
