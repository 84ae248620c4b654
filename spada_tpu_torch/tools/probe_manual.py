"""Serialization probe of the tile kernel (port of
``tools/probe_manual.py``).

The TPU probe switched the v2 cached kernel's parts off one at a time
(A/B DMAs, C copy-out, dots, slot reads) and ran it flat, in one grid step.
Here the same switches are modes of ``csrc/tile_probe.cu`` on the same
workload as ``probe_kernel`` (T from ``PROBE_T`` or ``--T``, default 256):

    python -m spada_tpu_torch.tools.probe_manual [modes...]
    PROBE_T=384 python -m spada_tpu_torch.tools.probe_manual v2full flat

Mode names are the TPU probe's (``v2full v2nocopy v2nodma v2dots v2loop``
by default; also ``v2store v2stat v3acc v3st v4stat v4unroll flat real``).
The TPU probe's ``PROBE_OGROUP`` and ``PROBE_NBUF`` set its grid grouping and
output buffers, which the CUDA kernel does not have.
"""

from __future__ import annotations

import sys

from spada_tpu_torch.tools.tile_probe import probe_main

DEFAULT_MODES = ["v2full", "v2nocopy", "v2nodma", "v2dots", "v2loop"]
ALL_MODES = DEFAULT_MODES + ["v2store", "v2stat", "v3acc", "v3st", "v4stat",
                             "v4unroll", "flat", "real"]


def main(argv=None):
    return probe_main(argv, DEFAULT_MODES, env_T=True,
                      description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main(sys.argv[1:])
