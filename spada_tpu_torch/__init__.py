"""spada_tpu_torch — the adaptive-dataflow SpGEMM of ``spada_tpu`` on
PyTorch and hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``spada_tpu`` stays the reference; this package imports
nothing of it.  Its host layer is a copy of the reference's, at the same
relative paths (``config``, ``sparse/``, ``io/``, ``plan/``, ``models/``,
``utils/trace``, ``utils/metrics``, ``native/``), held equal to it by
``tests/test_torch_host.py``.  The device side is rewritten:

- ``ops.engine``: the tile engines, ``csrc/tile_*.cu``;
- ``ops.element_stream``: the element (ESC) class kernels,
  ``csrc/esc_stream.cu``;
- ``ops.spgemm``: ``spgemm(a, b, config, dataflow, device=...)``;
- ``plan.execute``: per-panel-height plan execution;
- ``cli``: the ``run``, ``traffic`` and ``breuse`` modes, and
  ``run_spada``, the adaptive main path;
- ``tools``: the probe tools, ablation modes of the kernels, and the
  reference's calibration and evaluation tools.

The top level exports the reference's surface: ``SpadaConfig``,
``CsrMatrix`` and ``GemmWorkload`` (host modules that import only NumPy).

Kernels build with ``nvcc`` and the C++ host helpers with ``g++`` at first
use, into ``_build/``; importing this
package loads neither JAX nor CUDA.
"""

__version__ = "0.1.0"

from spada_tpu_torch.config import SpadaConfig
from spada_tpu_torch.sparse.csr import CsrMatrix
from spada_tpu_torch.io.workloads import GemmWorkload

__all__ = [
    "SpadaConfig",
    "CsrMatrix",
    "GemmWorkload",
    "__version__",
]
