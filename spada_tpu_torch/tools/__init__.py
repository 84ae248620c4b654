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
  fitted on ``tile_spgemm``; ``--thin``: the thin row panels' points;
  ``--latency`` and ``--items``: the card's tile model's tables;
- ``probe_dispatch_crossover``: the tile/element dispatch against both
  sides measured; ``--element-fit``: the element path's fixed term;
- ``eval_adaptive``: the adaptive plan against fixed panel heights, the
  panel engine, densify and the element side, with each dispatch's
  verdict and each tile plan's t_est under the card's model and the
  parent's beside its time;
- ``bench_value_refresh``: the serving loop, fresh values into held tiles
  and operands;
- ``probe_op``: the op dataflow's k-major engine (the plain scatter-add
  engine) against its byte bound and against the row schedule on
  ``tile_spgemm``;
- ``eval_scaling``: halo against psum-merge at D = 1..8, functional in
  spawned gloo groups on the CPU, every rank's body timed on the card,
  beside ``parallel.scaling``'s model.

Each runs on the card by default and takes ``--device cpu`` (the plain
versions, at a small size); on the card it prints ms and ns per item (GB/s
for the stream probe) beside the bound.
"""
