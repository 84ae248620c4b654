"""The probe tools of the port: ablation modes of the CUDA kernels.

Each module is run as ``python -m spada_tpu_torch.tools.<name>`` and is
named after the Pallas probe of ``tools/`` it ports:

- ``probe_kernel``, ``probe_manual``: ``csrc/tile_probe.cu``, the tile
  kernel with one component stripped per mode (:mod:`.tile_probe`);
- ``probe_panel3d``: runs of two adjacent slot tiles, per item
  (``tile_spgemm``) or as one contraction (``tile_panel``);
- ``probe_pallas_stream``: the element class kernels at the TPU probe's
  block sizes, beside ``torch.mul`` and ``torch.linalg.vecdot``.

Each runs on the card by default and takes ``--device cpu`` (the plain
versions, at a small size); on the card it prints ms and ns per item (GB/s
for the stream probe) beside the bound.
"""
