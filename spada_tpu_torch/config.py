"""Typed configuration for the whole framework.

The reference scatters its tuning surface across a JSON file
(``frontend.rs:8-23``, ``config/config_1mb_row1.json``) and hard-coded
constants (``simulator.rs:449-455``, ``scheduler.rs:203``,
``rowwise_perf_adjust.rs:125-126``, ``rowwise_adjust.rs:227-234``,
``colwise_reg_adjust.rs:39``).  Here every one of those knobs is surfaced in a
single dataclass, together with the TPU-native tunables that replace the
simulated micro-architecture.

Copy of :mod:`spada_tpu.config` for spada_tpu_torch, held equal to it by
``tests/test_torch_host.py``, followed by the port's hardware profile:
:func:`datasheet_peaks` and :func:`h100_config` put the roofline constants
of an NVIDIA Hopper card into ``SpadaConfig``, :func:`tile_work` and
:func:`stream_work` count the operations and bytes a kernel must do and
move, and :func:`roofline_bound` turns them into the least time they could
take.

The planner (``choose_tile_size``), the densify scorer and the tile/element
dispatch read ``hbm_bytes_per_s``, ``peak_flops_f32`` and
``peak_flops_bf16``.  The defaults of ``SpadaConfig`` describe another chip,
so the port sets them from NVIDIA's data sheets for the SKU the card names.
These are PLACEHOLDERS: published peaks (dense, without sparsity, at the
full power limit), not rates measured on the card.  A benchmark PR is to
measure them.  The per-item overhead terms (``engine_item_overhead_s``,
``engine_acc_s_per_elem``, ``engine_item_fixed_s``), which the planner adds
per work item beyond those rates, are fitted on an H100 SXM
(:func:`item_fit`, ``tools/probe_item_overhead.py``), one set per tile
dtype, on square tiles, with ``acc`` and ``fixed`` held non-negative
(:func:`fit_item_terms`); the thin row panels' points
(:data:`_THIN_FIT`, ``tools/probe_item_overhead.py --thin``) are recorded
beside them and not fitted into the planner's terms (see
:func:`h100_config`).  The element path's fixed time per multiply, which
the reference's ``estimate_element_time`` charges as a literal 30 us, is
fitted on the same card (:func:`element_fit`,
``tools/probe_dispatch_crossover.py --element-fit``) and carried by
:class:`CardConfig`, beside the terms of the card's own tile model
(:func:`tile_terms`, ``tools/probe_item_overhead.py --latency --items``),
which the reference's schema lacks.  The other SKUs take the same values
until they are measured.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class SpadaConfig:
    # ---- workload locations (reference: OmegaConfig, frontend.rs:8-23) ----
    ss_filepath: str = "./matrices"
    nn_filepath: str = "./matrices/nn_gemm.pkl"

    # ---- simulated-machine knobs, kept for the traffic/functional model ----
    # (reference: config_1mb_row1.json + simulator.rs:449-455)
    pe_num: int = 2
    at_num: int = 16
    lane_num: int = 8
    cache_size: int = 1_572_864          # fiber-cache bytes (1.5 MiB)
    word_byte: int = 8
    block_shape: Tuple[int, int] = (1, 10_000_000)
    mem_latency: int = 30                # cycles
    cache_latency: int = 0               # cycles
    freq: float = 1.0                    # GHz
    channel: int = 16
    bandwidth_per_channel: float = 8.0   # bytes/cycle
    # hard-wired datapath params (simulator.rs:449-455)
    sb_size: int = 4                     # stream-buffer depth
    pb_size: int = 8                     # psum-buffer depth
    pop_num_per_lane: int = 2
    sn_latency: int = 4                  # sorting-network latency
    mt_latency: int = 4                  # merge-tree latency
    tree_width: int = 8                  # adder-tree width

    # ---- adaptive-policy knobs ----
    # (reference: scheduler.rs:203, rowwise_*_adjust.rs, colwise_*_adjust.rs)
    adjust_scheme: int = 3               # 0 cost / 1 colwise-reg / 2 colwise-irr / 3 latency
    var_factor: float = 1.5              # row-group segmentation threshold
    group_diviser: int = 128             # wide-vs-narrow group split
    sample_num: int = 4                  # blocks sampled per candidate height
    cost_miss_weight: int = 100          # DRAM-traffic weight in the cost metric
    colwise_block_width: int = 8         # scheme-1 fixed block width

    # ---- TPU-native execution knobs (new; replace the simulated uarch) ----
    tile_n: int = 128                    # output-tile lane width (MXU column dim)
    tile_k: int = 128                    # contraction-tile depth (MXU row dim)
    tm_choices: Tuple[int, ...] = (8, 16, 32, 64, 128)  # candidate row-panel heights
    default_tm: int = 128
    dataflow: str = "spada"              # 'spada' | 'ip' | 'op' | 'rowwise'
    vmem_limit_bytes: Optional[int] = None
    engine: str = "auto"                 # 'auto' | 'streaming' | 'cached' | 'panel' | 'xla' | 'pallas_grid'
    engine_dtype: str = "float32"        # tile dtype: 'float32' | 'bfloat16'
    use_pallas: Optional[bool] = None    # legacy: True forces 'pallas_grid'
    precision: str = "highest"           # 'highest' (true f32) | 'default' (bf16 MXU)
    acc_dtype: str = "float32"
    # memory budget for densifying C in the outer-product path (bytes)
    dense_c_budget: int = 2 << 30
    # element-granular (ESC) path: chunk cap and dispatch policy
    # ('auto' = byte/overhead cost model picks tile vs element per matrix;
    #  'never'/'always' force one side — the reference's dataflow adaptivity
    #  lifted to the density axis)
    element_cap: int = 512
    element_dispatch: str = "auto"
    # element numeric executor: 'auto' (pallas on TPU — its cross-sublane
    # reduces beat XLA's minor-dim reduces, 1.03 vs 1.20 ms on locpl-64k;
    # xla elsewhere, where pallas would run interpreted), 'xla' (fused
    # elementwise/reduce ops), or 'pallas' (pipelined streaming kernels,
    # ops/element_stream)
    element_backend: str = "auto"
    # plan-time layout densification inside spgemm() (C-invariant subset:
    # k-grid anchor + k permutation; row permutations need the caller to
    # carry an inverse, so they only apply via preprocess_densified/CLI)
    densify: str = "auto"                # 'auto' | 'off'

    # measured per-work-item non-MXU overhead by tile edge (v5e, cached
    # engine, honest harness — tools/probe_item_overhead.py; slot configs
    # (12,24,8,8)/(12,24,8,8)/(6,10,4,6)/(6,10,4,2)).  The T=512 value is
    # low because ogroup=2 keeps the f32 accumulators VMEM-cheap there.
    # The previous values (0.15/0.49/1.26/2.49 us) were fitted under the
    # old harness, whose phantom operand pass grew with tile bytes and
    # biased the planner toward small T.
    engine_item_overhead_s: dict = dataclasses.field(
        default_factory=lambda: {128: 0.18e-6, 256: 0.31e-6,
                                 384: 0.72e-6, 512: 0.23e-6}
    )
    # per-item decomposition fitted to the same measurements (non-MXU part
    # scales with the f32 accumulate footprint tm*tn; see BENCH_NOTES.md):
    # t_item = 2*tm*tk*tn/peak + acc*tm*tn + fixed
    engine_acc_s_per_elem: float = 4.8e-12
    engine_item_fixed_s: float = 60e-9

    # ---- HBM roofline constants of the target chip (v5e defaults) ----
    hbm_bytes_per_s: float = 819e9
    peak_flops_f32: float = 98e12
    peak_flops_bf16: float = 197e12
    # per-link one-way ICI bandwidth (v5e: 4 links / chip, 2-D torus;
    # ~45 GB/s each way per link) — the weak-scaling projection input
    ici_bytes_per_s: float = 45e9
    ici_links: int = 4

    @classmethod
    def fast(cls, **overrides) -> "SpadaConfig":
        """Throughput profile: bf16 tiles, fast MXU passes, adaptive tile
        size (the bench configuration).  Accuracy: ~bf16 input rounding
        (values within ~0.5% of f32); use the default profile for the
        scipy-exact f32 path."""
        cfg = cls(engine_dtype="bfloat16", precision="default", **overrides)
        return cfg

    @classmethod
    def from_json(cls, path: str) -> "SpadaConfig":
        """Load a config JSON.

        Accepts both this framework's full schema and the reference's flat
        schema (``parse_config``, frontend.rs:77-85) — unknown keys are
        rejected, missing keys take defaults.
        """
        with open(path) as f:
            raw = json.load(f)
        field_names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - field_names
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        if "block_shape" in raw:
            raw["block_shape"] = tuple(raw["block_shape"])
        if "tm_choices" in raw:
            raw["tm_choices"] = tuple(raw["tm_choices"])
        return cls(**raw)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    # ---- derived quantities ----
    @property
    def bandwidth_bytes_per_cycle(self) -> float:
        return self.channel * self.bandwidth_per_channel

    @property
    def cache_words(self) -> int:
        """Fiber-cache capacity in words (``capability``, storage.rs:498)."""
        return self.cache_size // self.word_byte


# (substring of the device name, HBM bytes/s, f32 FLOP/s outside the
# tensor cores, dense TF32 FLOP/s, dense bf16 FLOP/s, one-way link bytes/s
# from one GPU to one peer); first match wins, the last row is the H100 SXM
# default.  The link: NVLink 4 through NVSwitch (18 links, 450 GB/s each
# way) on SXM boards, the NVLink bridge on NVL cards, PCIe Gen5 x16 on PCIe
# cards.
_DATASHEET = (
    ("H200", 4.8e12, 67e12, 495e12, 989e12, 450e9),
    ("H100 NVL", 3.9e12, 60e12, 418e12, 835e12, 300e9),
    ("H100 PCIe", 2.0e12, 51e12, 378e12, 756e12, 64e9),
    ("H100", 3.35e12, 67e12, 495e12, 989e12, 450e9),
)


def _datasheet_row(device_name: Optional[str]) -> tuple:
    name = device_name or ""
    for row in _DATASHEET:
        if row[0] in name:
            return row
    return _DATASHEET[-1]


def datasheet_peaks(device_name: Optional[str] = None) -> dict:
    """Published peaks for the card named ``device_name`` (as
    ``nvidia-smi``/``torch.cuda.get_device_name`` give it); H100 SXM when no
    name is given or the name is not in the table.  ``ici_bytes_per_s``,
    the reference's inter-chip link rate that the scaling model
    (:mod:`spada_tpu_torch.parallel.scaling`) reads, is the NVLink (or PCIe)
    rate from one GPU to one peer, one way."""
    _, bw, f32, _, bf16, link = _datasheet_row(device_name)
    return {"hbm_bytes_per_s": bw, "peak_flops_f32": f32,
            "peak_flops_bf16": bf16, "ici_bytes_per_s": link}


# The planner's per-item overhead fitted on the card, by tile dtype: seconds
# per work item by tile edge T, the time of one tile_spgemm launch on
# banded_csr(65536, 65536, 384) at T x T tiles beyond choose_tile_size's own
# term for it, over W.  Measured by spada_tpu_torch/tools/probe_item_overhead.py
# on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit, 2026-10-17.
_ITEM_FIT = {
    "float32": {128: 6.131e-08, 256: 5.541e-07, 384: 1.983e-06,
                512: 4.577e-06},
    "bfloat16": {128: 1.075e-08, 256: 1.099e-07, 384: 4.187e-07,
                 512: 9.926e-07},
}


# The same overhead on thin row panels, by tile dtype and (tm, tn): one
# tile_spgemm launch of uniform tm x 128 panels on banded_csr(32768, 32768,
# 384) at tk = tn = 128 (tools/sweep_thin's tile_spgemm case), beyond
# panel_cost_model's own term for it, over W; beside it the item time,
# elapsed / W.  A record: the planner's terms are fitted on the square
# points alone (see h100_config).  Measured by
# spada_tpu_torch/tools/probe_item_overhead.py --thin on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit, 2026-10-17.
_THIN_FIT = {
    "float32": {(8, 128): (-6.881e-09, 1.423e-08),
                (16, 128): (-7.773e-09, 1.488e-08),
                (32, 128): (-2.637e-09, 2.311e-08),
                (64, 128): (8.721e-09, 4.066e-08),
                (128, 128): (4.335e-08, 8.766e-08)},
    "bfloat16": {(8, 128): (-3.857e-09, 6.698e-09),
                 (16, 128): (-4.016e-09, 7.312e-09),
                 (32, 128): (-4.343e-09, 8.531e-09),
                 (64, 128): (-3.854e-09, 1.211e-08),
                 (128, 128): (1.66e-09, 2.381e-08)},
}


def item_shape(key) -> Tuple[int, int]:
    """(tm, tn) of a point's key: T (a T x T tile) or (tm, tn)."""
    return (key, key) if isinstance(key, (int, np.integer)) else tuple(key)


def fit_item_terms(points: dict,
                   item_s: Optional[dict] = None) -> Tuple[float, float]:
    """(acc, fixed): the least-squares fit of ``overhead ~= acc * tm * tn +
    fixed`` to ``{shape: seconds per item}`` with both terms held >= 0.  A
    shape is T (a T x T tile) or (tm, tn).  With ``item_s``, the measured
    time of an item of each shape, each residual counts relative to it, so
    that a thin item's nanoseconds weigh as much as a 512^2 item's
    microseconds, and an overhead at or below zero (the planner's own term
    already at or above the measurement) still has a finite weight.

    The estimator and the densify scorer charge ``acc * tm * tn + fixed``
    per item for every panel height.  The card's overhead on square tiles
    grows about as T^3, so the unconstrained fit (the reference's
    ``np.linalg.lstsq``) puts a negative fixed term under it, a negative
    cost per thin item, and the planner then prefers the thinnest panels.
    With two terms the constrained optimum is the best feasible of the fits
    on each subset of the terms."""
    x = np.asarray([np.prod(item_shape(k)) for k in points], np.float64)
    y = np.asarray(list(points.values()), np.float64)
    w = (np.ones_like(y) if item_s is None
         else 1.0 / np.asarray([item_s[k] for k in points], np.float64))
    lhs = np.stack([x, np.ones_like(x)], axis=1) * w[:, None]
    y = y * w
    best = None
    for cols in ((0, 1), (0,), (1,), ()):
        coef = np.zeros(2)
        if cols:
            coef[list(cols)] = np.linalg.lstsq(lhs[:, list(cols)], y,
                                               rcond=None)[0]
        if (coef < 0).any():
            continue
        sse = float(np.sum((y - lhs @ coef) ** 2))
        if best is None or sse < best[0]:
            best = (sse, coef)
    return float(best[1][0]), float(best[1][1])


def item_fit(engine_dtype: str = "float32") -> dict:
    """The per-item fields of ``SpadaConfig`` fitted on the card for tiles
    of ``engine_dtype`` ('float32' or 'bfloat16'): the measured overhead by
    T, and ``acc`` and ``fixed`` from :func:`fit_item_terms`."""
    if engine_dtype not in _ITEM_FIT:
        raise ValueError(f"unknown engine_dtype {engine_dtype!r}")
    per_t = _ITEM_FIT[engine_dtype]
    acc, fixed = fit_item_terms(per_t)
    return {"engine_item_overhead_s": dict(per_t),
            "engine_acc_s_per_elem": acc, "engine_item_fixed_s": fixed}


#: the fixed time per multiply of the reference's element model
#: (``estimate_element_time``'s literal)
REFERENCE_ELEMENT_FIXED_S = 30e-6

# The element path on the card: (the ESC plan's streamed bytes,
# ops.spgemm.element_plan_bytes, and the device seconds of its
# esc_stream_group launches, one per row slab) of each multiply of the
# family: banded_fill_csr(n, 384, fill) A.B at n = 32768 and 8192, fills
# 192..12, the graded FEM's A.A at 129 edges, and locpl.  Measured by
# spada_tpu_torch/tools/probe_dispatch_crossover.py --element-fit on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit, 2026-10-17.
_ELEMENT_FIT_CARD = "NVIDIA H100 80GB HBM3"
_ELEMENT_FIT = {
    "banded-fill 32768 192": (10830063988, 0.003531),
    "banded-fill 32768 96": (2987260116, 0.0009801),
    "banded-fill 32768 48": (777802852, 0.000258),
    "banded-fill 32768 24": (207008148, 7.422e-05),
    "banded-fill 32768 12": (54487472, 2.45e-05),
    "banded-fill 8192 192": (2627537884, 0.000865),
    "banded-fill 8192 96": (725150904, 0.0002413),
    "banded-fill 8192 48": (188952812, 6.829e-05),
    "banded-fill 8192 24": (50398288, 2.331e-05),
    "banded-fill 8192 12": (13312320, 8.16e-06),
    "fem-graded-129": (14470416, 8.768e-06),
    "locpl 65536 32": (715605668, 0.0002448),
}


def fit_element_fixed(points: dict, hbm_bytes_per_s: float) -> float:
    """``fixed``: the least-squares fit of ``t ~= bytes / hbm_bytes_per_s +
    fixed`` to ``{name: (bytes, seconds)}``, each residual relative to its
    t (the small multiplies, where the fixed time shows, weigh as much as
    the large), held >= 0."""
    b, t = (np.asarray(v, np.float64) for v in zip(*points.values()))
    w = 1.0 / t ** 2
    return max(0.0, float(np.sum(w * (t - b / hbm_bytes_per_s))
                          / np.sum(w)))


def element_fit() -> dict:
    """``{"element_fixed_s": ...}``: :func:`fit_element_fixed` of the
    recorded points at the datasheet byte rate of the card they were
    measured on, one value for every card until each is measured."""
    bw = datasheet_peaks(_ELEMENT_FIT_CARD)["hbm_bytes_per_s"]
    return {"element_fixed_s": fit_element_fixed(_ELEMENT_FIT, bw)}


#: the tile side's card terms in the reference's form: no item table (the
#: per-item terms ``acc * tm * tn + fixed`` add to the byte/flop max), no
#: latency, no L2 reuse (every item's tiles read from HBM), no launch
REFERENCE_TILE_TERMS = {"tile_item_s": (), "tile_item_latency_s": (),
                        "tile_l2_bytes_per_s": 0.0, "tile_l2_bytes": 0,
                        "tile_launch_s": 0.0}


@dataclasses.dataclass
class CardConfig(SpadaConfig):
    """``SpadaConfig`` with the terms of the card's profile that the
    reference's schema has no field for.

    - ``element_fixed_s``: the element path's fixed time per multiply,
      which ``ops.spgemm.estimate_element_time`` adds to the plan's bytes
      over the HBM rate.
    - The tile side's card model (:mod:`spada_tpu_torch.plan.card_model`):
      ``tile_item_s``, ``((tm, T, seconds), ...)``, the throughput time of
      one tm x T x T item on a full grid; ``tile_item_latency_s``, the same
      shapes' time per item of one block's run; ``tile_l2_bytes_per_s``, the
      rate re-read tiles come at from L2, and ``tile_l2_bytes``, the L2
      size that bounds that reuse; ``tile_launch_s``, the fixed time of one
      launch of a plan segment.

    The defaults are the reference's literal and the reference's form
    (:data:`REFERENCE_TILE_TERMS`), so a config of this class prices what
    ``SpadaConfig`` prices until the card's terms are set.  A JSON round
    trip gives the tables back as tuples."""

    element_fixed_s: float = REFERENCE_ELEMENT_FIXED_S
    tile_item_s: tuple = ()
    tile_item_latency_s: tuple = ()
    tile_l2_bytes_per_s: float = 0.0
    tile_l2_bytes: int = 0
    tile_launch_s: float = 0.0

    def __post_init__(self):
        for f in ("tile_item_s", "tile_item_latency_s"):
            setattr(self, f, tuple((int(tm), int(t), float(s))
                                   for tm, t, s in getattr(self, f)))


# The tile side's card model, measured on the card (plan/card_model.py reads
# these through CardConfig's tile_* fields).  _TILE_ITEM: by tile dtype,
# {(tm, T): seconds per item}, one tile_spgemm launch of uniform tm x T
# panels on banded_csr(32768, 32768, 384) at tk = tn = T (tools/sweep_thin's
# pair; every grid above the card's 132 SMs), less its C tiles' f32 write at
# the HBM rate, over W (the model adds each C tile's write back).
# _TILE_LATENCY: by tile dtype, {(tm, T): seconds per item}, the slope of
# one C tile's time over runs of 1, 2, 4 ... 64 items.  _TILE_LAUNCH_S: one
# launch of a one-item worklist less one item's latency, the median over
# the shapes.  _TILE_L2: (the highest rate, over the _TILE_ITEM points, at
# which the re-read tiles arrived beyond the unique tiles' HBM time, bytes
# per second; the card's L2 size in bytes).
_TILE_FIT_SOURCE = {"card": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
                    "date": "2026-10-17",
                    "tool": "spada_tpu_torch/tools/probe_item_overhead.py "
                            "--latency --items"}
_TILE_ITEM: dict = {
    "float32": {(8, 128): 1.368e-08, (16, 128): 1.425e-08,
                (32, 128): 2.176e-08, (64, 128): 3.82e-08,
                (128, 128): 8.257e-08, (8, 256): 5.402e-08,
                (16, 256): 5.651e-08, (32, 256): 8.651e-08,
                (64, 256): 1.51e-07, (128, 256): 3.226e-07,
                (256, 256): 6.445e-07, (8, 384): 1.224e-07,
                (16, 384): 1.262e-07, (32, 384): 1.978e-07,
                (64, 384): 3.433e-07, (128, 384): 7.373e-07,
                (384, 384): 2.183e-06, (8, 512): 2.13e-07,
                (16, 512): 2.231e-07, (32, 512): 3.455e-07,
                (64, 512): 6.06e-07, (128, 512): 1.277e-06,
                (512, 512): 5.082e-06},
    "bfloat16": {(8, 128): 6.236e-09, (16, 128): 6.542e-09,
                 (32, 128): 7.214e-09, (64, 128): 9.519e-09,
                 (128, 128): 1.87e-08, (8, 256): 2.496e-08,
                 (16, 256): 2.628e-08, (32, 256): 2.79e-08,
                 (64, 256): 3.59e-08, (128, 256): 7.061e-08,
                 (256, 256): 1.405e-07, (8, 384): 5.566e-08,
                 (16, 384): 5.848e-08, (32, 384): 6.329e-08,
                 (64, 384): 8.166e-08, (128, 384): 1.624e-07,
                 (384, 384): 4.79e-07, (8, 512): 9.897e-08,
                 (16, 512): 1.045e-07, (32, 512): 1.121e-07,
                 (64, 512): 1.391e-07, (128, 512): 2.766e-07,
                 (512, 512): 1.105e-06},
}
_TILE_LATENCY: dict = {
    "float32": {(8, 128): 2.721e-06, (16, 128): 2.77e-06,
                (32, 128): 3.805e-06, (64, 128): 5.803e-06,
                (128, 128): 1.073e-05, (8, 256): 5.317e-06,
                (16, 256): 5.424e-06, (32, 256): 7.472e-06,
                (64, 256): 1.138e-05, (128, 256): 2.081e-05,
                (256, 256): 2.061e-05, (8, 384): 7.901e-06,
                (16, 384): 8.2e-06, (32, 384): 1.119e-05,
                (64, 384): 1.706e-05, (128, 384): 3.09e-05,
                (384, 384): 3.111e-05, (8, 512): 1.11e-05,
                (16, 512): 1.148e-05, (32, 512): 1.502e-05,
                (64, 512): 2.271e-05, (128, 512): 4.143e-05,
                (512, 512): 4.175e-05},
    "bfloat16": {(8, 128): 8.325e-07, (16, 128): 8.784e-07,
                 (32, 128): 1.054e-06, (64, 128): 1.438e-06,
                 (128, 128): 2.422e-06, (8, 256): 1.643e-06,
                 (16, 256): 1.734e-06, (32, 256): 2.096e-06,
                 (64, 256): 2.797e-06, (128, 256): 4.587e-06,
                 (256, 256): 4.585e-06, (8, 384): 2.435e-06,
                 (16, 384): 2.588e-06, (32, 384): 3.121e-06,
                 (64, 384): 4.19e-06, (128, 384): 6.864e-06,
                 (384, 384): 6.868e-06, (8, 512): 3.244e-06,
                 (16, 512): 3.463e-06, (32, 512): 4.148e-06,
                 (64, 512): 5.545e-06, (128, 512): 9.081e-06,
                 (512, 512): 9.148e-06},
}
_TILE_LAUNCH_S = 5.805e-06
_TILE_L2 = (5.502e+12, 52428800)
# _TILE_RESIDENT: by tile dtype, {(tm, T): blocks of tile_spgemm's block for
# the shape that one SM holds at once} (cudaOccupancyMaxActiveBlocksPer
# Multiprocessor of the kernel as it launches); _TILE_SMS: the card's SMs.
# Measured by spada_tpu_torch/tools/probe_item_overhead.py's run_resident
# (--latency) on an NVIDIA H100 80GB HBM3 at 700.00 W, 2026-10-18.  A record,
# as _THIN_FIT is: the model's term that priced the SMs' shared first wave
# from them failed its rule on the card (blk32 planned tm 64 and ran 1.17x
# its tm-32 plan; PERF.md, Findings), so no config carries them.
_TILE_RESIDENT: dict = {
    "float32": {(8, 128): 4, (16, 128): 4, (32, 128): 3, (64, 128): 2,
                (128, 128): 1, (8, 256): 4, (16, 256): 4, (32, 256): 3,
                (64, 256): 2, (128, 256): 1, (256, 256): 1, (8, 384): 4,
                (16, 384): 4, (32, 384): 3, (64, 384): 2, (128, 384): 1,
                (256, 384): 1, (384, 384): 1, (8, 512): 4, (16, 512): 4,
                (32, 512): 3, (64, 512): 2, (128, 512): 1, (256, 512): 1,
                (384, 512): 1, (512, 512): 1},
    "bfloat16": {(8, 128): 4, (16, 128): 3, (32, 128): 3, (64, 128): 2,
                 (128, 128): 1, (8, 256): 4, (16, 256): 3, (32, 256): 3,
                 (64, 256): 2, (128, 256): 1, (256, 256): 1, (8, 384): 4,
                 (16, 384): 3, (32, 384): 3, (64, 384): 2, (128, 384): 1,
                 (256, 384): 1, (384, 384): 1, (8, 512): 4, (16, 512): 3,
                 (32, 512): 3, (64, 512): 2, (128, 512): 1, (256, 512): 1,
                 (384, 512): 1, (512, 512): 1},
}
_TILE_SMS = 132


def tile_terms(engine_dtype: str = "float32") -> dict:
    """The tile side's card terms of :class:`CardConfig` for tiles of
    ``engine_dtype``, from the recorded tables; the reference's form
    (:data:`REFERENCE_TILE_TERMS`) where none is recorded."""
    if engine_dtype not in _TILE_ITEM:
        raise ValueError(f"unknown engine_dtype {engine_dtype!r}")
    if not _TILE_ITEM[engine_dtype]:
        return dict(REFERENCE_TILE_TERMS)

    def table(d):
        return tuple((tm, t, s) for (tm, t), s in sorted(d.items()))

    return {"tile_item_s": table(_TILE_ITEM[engine_dtype]),
            "tile_item_latency_s": table(_TILE_LATENCY[engine_dtype]),
            "tile_l2_bytes_per_s": _TILE_L2[0], "tile_l2_bytes": _TILE_L2[1],
            "tile_launch_s": _TILE_LAUNCH_S}


def card_profile(device_name: Optional[str] = None,
                 engine_dtype: str = "float32") -> dict:
    """The :class:`CardConfig` fields that describe the card named
    ``device_name``: its datasheet peaks (:func:`datasheet_peaks`), the
    per-item terms fitted for ``engine_dtype`` tiles (:func:`item_fit`),
    the element path's fixed term (:func:`element_fit`) and the tile
    side's card terms (:func:`tile_terms`)."""
    return {**datasheet_peaks(device_name), **item_fit(engine_dtype),
            **element_fit(), **tile_terms(engine_dtype)}


def card_config(config: SpadaConfig,
                device_name: Optional[str] = None) -> CardConfig:
    """``config``'s fields with the profile of the card named
    ``device_name`` for its tile dtype (:func:`card_profile`) in place of
    its own, as a :class:`CardConfig`."""
    fields = {f.name: getattr(config, f.name)
              for f in dataclasses.fields(config)}
    return CardConfig(**{**fields,
                         **card_profile(device_name, config.engine_dtype)})


def h100_config(device_name: Optional[str] = None,
                **overrides) -> CardConfig:
    """:class:`CardConfig` with the card's profile (:func:`card_profile`:
    the datasheet roofline, placeholders until measured, the per-item
    terms fitted for the tile dtype, ``overrides``' ``engine_dtype`` or
    'float32', the element path's fixed term and the tile side's card
    terms), then ``overrides``.

    Under these terms the port plans with the card's own tile model
    (``plan.card_model``: per plan segment a launch plus the largest of
    the byte term with L2 reuse, the items' throughput time with C's
    write, and the longest run at one block's latency).  The reference's
    form of the same planner (``REFERENCE_TILE_TERMS`` as overrides) uses
    the per-item terms, fitted on square tiles: under them
    ``choose_tile_size`` takes T = 128 on most pairs and the estimator's
    ``max(bytes / hbm, mxu / peak) + W * (acc * tm * tn + fixed)`` chooses
    the panel heights.  The thin row panels' points (:data:`_THIN_FIT`)
    are not in that fit: the fit of the same form on square and thin
    points together has ``fixed`` 0 and an ``acc`` 9-24 times smaller,
    and under it cari ran 1.95x, banded 1.18x and nn-bert-ffn1-blk32 1.68x
    slower on an NVIDIA H100 80GB HBM3 at 700 W."""
    dtype = overrides.get("engine_dtype", "float32")
    return CardConfig(**{**card_profile(device_name, dtype), **overrides})


def _is_half(dtype) -> bool:
    return str(dtype).rsplit(".", 1)[-1] in ("bfloat16", "float16")


def matmul_peak_flops(device_name: Optional[str] = None,
                      dtype="float32") -> float:
    """The FLOP/s at which the tile kernels multiply ``dtype`` tiles on the
    card named ``device_name`` (datasheet placeholders until measured):
    bf16 and fp16 tiles at the dense tensor-core rate (their products are
    exact in an f32 accumulator), f32 tiles at a third of the dense TF32
    rate, since 3xTF32 on the tensor cores gives f32-level error at that
    rate (``csrc/tile_mma.cuh``)."""
    _, _, _, tf32, bf16, _ = _datasheet_row(device_name)
    return bf16 if _is_half(dtype) else tf32 / 3


def roofline_bound(flops: float, nbytes: float,
                   device_name: Optional[str] = None,
                   dtype="float32", matmul: bool = False) -> tuple:
    """(seconds, 'operations' | 'bytes'): the least time the card named
    ``device_name`` could take for ``flops`` operations on ``dtype``
    operands that move ``nbytes``, on its datasheet peaks (placeholders
    until measured).  Half-precision operands, and f32 operands of a matrix
    product (``matmul``), count at :func:`matmul_peak_flops`; other f32
    work counts at the FP32 rate outside the tensor cores."""
    _, bw, f32, _, _, _ = _datasheet_row(device_name)
    peak = (matmul_peak_flops(device_name, dtype)
            if matmul or _is_half(dtype) else f32)
    t_op = flops / peak
    t_by = nbytes / bw
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")


def spgemm_flops(a, b) -> int:
    """2 x the scalar multiply-adds of C = A.B for CSR operands (anything
    with ``indptr``, ``indices`` and ``shape``): the nonzeros of A's column
    k times those of B's row k, summed over k.  The zeros inside a tile are
    not counted."""
    col = np.bincount(np.asarray(a.indices), minlength=a.shape[1])
    row = np.diff(np.asarray(b.indptr))
    return 2 * int(np.dot(col.astype(np.int64), row.astype(np.int64)))


def tile_work(a_tiles, b_tiles, n_items: int, n_c: int, a=None,
              b=None) -> tuple:
    """(flops, bytes) a worklist tile kernel must do and move to write the
    f32 C tiles [n_c, tm, tn] from ``a_tiles`` [*, tm, tk] and ``b_tiles``
    [*, tk, tn] (arrays or tensors): the useful products of the CSR pair
    ``a``, ``b`` (:func:`spgemm_flops`), or, without it, every element of
    each item's tiles; each tile read once, two ids per item and one tile
    pointer per C tile (int32), C written once."""
    tm, tk = a_tiles.shape[1], a_tiles.shape[2]
    tn = b_tiles.shape[2]
    flops = (spgemm_flops(a, b) if a is not None
             else 2 * n_items * tm * tk * tn)
    nbytes = (int(a_tiles.nbytes) + int(b_tiles.nbytes)
              + 4 * (2 * n_items + n_c + 1) + 4 * n_c * tm * tn)
    return flops, nbytes


def stream_work(L: int, n: int) -> tuple:
    """(flops, bytes) of one element class: ``n`` f32 outputs, each the sum
    of ``L`` products (L multiplies and L - 1 adds), two [L, n] inputs read
    once and the output written once."""
    return n * (2 * L - 1), 4 * n * (2 * L + 1)
