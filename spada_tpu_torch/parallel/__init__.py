"""Multi-GPU execution on torch.distributed: the port of
:mod:`spada_tpu.parallel`.

One process per rank (PyTorch's SPMD model): every rank calls the same entry
point with the same host problem and computes its own shard; every rank
returns the whole result, gathered with ``all_gather_into_tensor``.  The
caller initialises the default process group (NCCL on cards, gloo on the
CPU); ``mesh=None`` takes the row-major mesh of that group.

- **dp** (A's row panels; C inherits them) needs no communication.
- **tp** (the contraction split into k slabs): each tp rank's k-partial C
  tiles are merged by ``reduce_scatter_tensor`` or ``all_reduce`` over the
  tp group (:func:`spgemm_sharded`).
- **halo** (dp only): B stays k-sharded and each rank receives the B tiles
  its worklist needs over D-1 point-to-point rounds, issued at once before
  any compute (:func:`spgemm_halo`).
- **element dp**: the ESC element engine over E-balanced row slabs, with no
  communication in the multiply (:func:`spgemm_element_dp`).

:func:`choose_parallel_strategy` picks one by modelled bytes.  The
partitioners and the chooser are copies of the reference's; each rank's
body (``sharded_rank``, ``halo_rank``, ``element_rank``) runs the CUDA
kernels of the single-GPU path on its shard.
"""

from spada_tpu_torch.parallel.element_dp import (partition_element,
                                                 spgemm_element_dp)
from spada_tpu_torch.parallel.halo import partition_halo, spgemm_halo
from spada_tpu_torch.parallel.partition import (choose_parallel_strategy,
                                                partition_spgemm,
                                                ShardedProblem)
from spada_tpu_torch.parallel.spgemm import spgemm_sharded

__all__ = ["partition_spgemm", "ShardedProblem", "spgemm_sharded",
           "partition_halo", "spgemm_halo", "choose_parallel_strategy",
           "partition_element", "spgemm_element_dp"]
