"""The benchmark of spada_tpu_torch, the PyTorch and CUDA port of spada_tpu.

One run measures one cell (a configuration under a traffic mix, both named in
``BENCHMARK.json`` at the root of the repository) on one card:

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from the seed, plans the product once through
the port's entry (``spada_tpu_torch.cli.plan_spada``) and holds two value sets
of the same structure on the card, with their launches prepared.  The window
then repeats products in a closed loop, one in flight, alternating the value
sets.  After the window a plain reference (``references/``) recomputes C from
the same inputs and judges the products the window left behind.

Everything that belongs to one configuration, traffic mix or metric is a file
of its own, found by its name: ``configs/<config>.json``,
``traffic/<mix>.json``, ``generators/<generator>.py``,
``references/<reference>.py`` and ``metrics/<metric>.py``.  Nothing here
imports ``jax`` or the JAX package ``spada_tpu``; only ``system.py`` imports
the port.
"""
