"""Per-item cost decomposition of the tile kernel (port of
``tools/probe_kernel.py``).

Runs the TPU probe's workload (``banded_csr(65536, 65536, 384)``, T = 256
tiles, bf16) through the modes of ``csrc/tile_probe.cu`` that the TPU
probe's variants map to, and prints each mode's time and ns per work item
beside the bound of the full work:

    python -m spada_tpu_torch.tools.probe_kernel [modes...]
    python -m spada_tpu_torch.tools.probe_kernel --device cpu --n 2048

Mode names are the TPU probe's (``full nodma statslot oneslot noacc empty``
by default; also ``empty0 empty1 emptyS emptyD nozero``), mapped by
:data:`spada_tpu_torch.tools.tile_probe.TPU_MODES`.
"""

from __future__ import annotations

import sys

from spada_tpu_torch.tools.tile_probe import probe_main

DEFAULT_MODES = ["full", "nodma", "statslot", "oneslot", "noacc", "empty"]
ALL_MODES = DEFAULT_MODES + ["empty0", "empty1", "emptyS", "emptyD", "nozero"]


def main(argv=None):
    return probe_main(argv, DEFAULT_MODES, env_T=False,
                      description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main(sys.argv[1:])
