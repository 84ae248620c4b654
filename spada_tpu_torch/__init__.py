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
- ``tools``: the probe tools, ablation modes of the kernels.

Kernels build with ``nvcc`` and the C++ host helpers with ``g++`` at first
use, into ``_build/``; importing this
package loads neither JAX nor CUDA.
"""

__version__ = "0.1.0"
