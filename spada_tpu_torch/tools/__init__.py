"""The tools of the port: ablation probes of the CUDA kernels, and the
planner's calibration and evaluation.

Each module is run as ``python -m spada_tpu_torch.tools.<name>`` and is
named after the Pallas probe of ``tools/`` it ports:

- ``probe_kernel``, ``probe_manual``: ``csrc/tile_probe.cu``, the tile
  kernel with one component stripped per mode (:mod:`.tile_probe`);
- ``probe_panel3d``: runs of two adjacent slot tiles, per item
  (``tile_spgemm``) or as one contraction (``tile_panel``);
- ``probe_pallas_stream``: the element class kernels at the TPU probe's
  block sizes, beside ``torch.mul`` and ``torch.linalg.vecdot``.

The planner's calibration and evaluation tools, named after the reference
tools they port (:mod:`.harness` holds what they share):

- ``probe_item_overhead``: the per-item terms of ``config.h100_config``,
  fitted on ``tile_spgemm``;
- ``probe_dispatch_crossover``: the tile/element dispatch against both
  sides measured;
- ``eval_adaptive``: the adaptive plan against fixed panel heights, the
  panel engine, densify and the element side;
- ``bench_value_refresh``: the serving loop, fresh values into held tiles
  and operands.

Each runs on the card by default and takes ``--device cpu`` (the plain
versions, at a small size); on the card it prints ms and ns per item (GB/s
for the stream probe) beside the bound.
"""
