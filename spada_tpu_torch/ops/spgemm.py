"""Public SpGEMM entry point on PyTorch: C = A @ B for sparse A, B.

The port of :mod:`spada_tpu.ops.spgemm`.  The dataflow axis is the
reference's (``ip | op | rowwise | spada | element``), each a schedule of
the tile engine or the element engine; see that module for what each
means.  ``dataflow='spada'`` picks the engine per matrix by modeled time
(:func:`dispatch_dataflow`) and runs a planner ``ExecutionPlan`` when one
is given (:func:`spada_tpu_torch.plan.execute.execute_plan`).

Every entry point takes the ``device`` it runs on; nothing picks one by
itself.  The host planners are the port's copies of the JAX package's
(:mod:`spada_tpu_torch.plan`, :mod:`spada_tpu_torch.ops.worklist`,
:mod:`spada_tpu_torch.ops.element`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from spada_tpu_torch.config import (REFERENCE_ELEMENT_FIXED_S, SpadaConfig,
                                    datasheet_peaks, matmul_peak_flops)
from spada_tpu_torch.sparse.bsr import BsrMatrix
from spada_tpu_torch.sparse.csr import CsrMatrix
from spada_tpu_torch.convert import (bsr_to_torch, c_tiles_to_numpy,
                                     check_device, synchronize)
from spada_tpu_torch.ops.engine import run_worklist
from spada_tpu_torch.ops.worklist import build_worklist
from spada_tpu_torch.utils import trace


@dataclasses.dataclass
class SpGemmResult:
    """Numeric result (block-sparse or element-granular) + execution metadata.

    ``c_tiles`` stays on the device it was computed on (or is a host array,
    as inside a ``PlanResult``); :meth:`todense` and :meth:`to_csr` read it
    back to the host.
    """

    shape: tuple
    tm: int
    tn: int
    c_tiles: object              # [nC, tm, tn] f32 tensor or host array
    c_tile_row: np.ndarray
    c_tile_col: np.ndarray
    tk: int = 128                # contraction tile edge used by the engine
    tile_itemsize: int = 4       # bytes/element of the A/B tiles as moved
    n_work_items: int = 0
    mxu_flops: int = 0           # FLOPs issued to the tile engine
    useful_flops: int = 0        # 2 * scalar multiply count
    elapsed_s: Optional[float] = None
    # element-granular (ESC) result; when set, c_tiles is empty and
    # todense/to_csr delegate to it
    element: Optional[object] = None
    engine_used: str = "tile"    # 'tile' | 'element'
    # the launches this result ran, as host state ({"segments": [(wl,
    # a_tiles_f32, b_tiles_f32, tm)], "tk", "tn"}), so that
    # measure_device_perf times them without replanning
    host_state: Optional[dict] = None

    def host_tiles(self) -> np.ndarray:
        return c_tiles_to_numpy(self.c_tiles)

    def todense(self) -> np.ndarray:
        if self.element is not None:
            return self.element.todense()
        tiles = self.host_tiles()
        n_tile_cols = -(-self.shape[1] // self.tn)
        n_tile_rows = -(-self.shape[0] // self.tm)
        d = np.zeros((n_tile_rows * self.tm, n_tile_cols * self.tn), np.float32)
        for t in range(tiles.shape[0]):
            r0 = int(self.c_tile_row[t]) * self.tm
            c0 = int(self.c_tile_col[t]) * self.tn
            d[r0 : r0 + self.tm, c0 : c0 + self.tn] = tiles[t]
        return d[: self.shape[0], : self.shape[1]]

    def to_csr(self, prune_eps: float = 0.0) -> CsrMatrix:
        if self.element is not None:
            return self.element.to_csr()
        tiles = self.host_tiles()
        t, r, c = np.nonzero(np.abs(tiles) > prune_eps)
        rows = self.c_tile_row[t].astype(np.int64) * self.tm + r
        cols = self.c_tile_col[t].astype(np.int64) * self.tn + c
        keep = (rows < self.shape[0]) & (cols < self.shape[1])
        return CsrMatrix.from_coo(
            self.shape, rows[keep], cols[keep], tiles[t, r, c][keep]
        )


def _count_useful_flops(a: CsrMatrix, b: CsrMatrix) -> int:
    """2 * Σ_k nnz(A[:,k]) * nnz(B[k,:]) — the scalar multiply count."""
    a_col_counts = np.bincount(a.indices, minlength=a.shape[1])
    b_row_lens = np.diff(b.indptr)
    return int(2 * np.dot(a_col_counts.astype(np.int64), b_row_lens.astype(np.int64)))


def tile_dtype(config: SpadaConfig, dtype=None) -> torch.dtype:
    """The A/B tile dtype: ``config.engine_dtype``'s, or what
    :func:`spgemm`'s ``dtype`` asks for.  ``dtype`` None or float32 (a
    torch or numpy dtype, or its name) means the config's, as the
    reference's float32 default does (under a bf16 config, bf16 tiles);
    bfloat16 (torch's, ``ml_dtypes``' or the name) means bf16 tiles under
    any config.  Another dtype raises ``TypeError``."""
    if config.engine_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown engine_dtype {config.engine_dtype!r}")
    name = "float32" if dtype is None else _dtype_name(dtype)
    if name == "bfloat16":
        return torch.bfloat16
    if name != "float32":
        raise TypeError(f"spgemm: dtype must be float32 or bfloat16, got "
                        f"{dtype!r}")
    return torch.bfloat16 if config.engine_dtype == "bfloat16" else torch.float32


def _dtype_name(dtype) -> str:
    if isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    try:
        return np.dtype(dtype).name
    except TypeError:
        return repr(dtype)


def element_plan_bytes(a: CsrMatrix, b: CsrMatrix, cap: int = 512) -> dict:
    """Exact streamed bytes of the ESC plan WITHOUT building it.

    The chunk-length histogram is the per-C-nonzero product count — the
    boolean pattern product A_pat @ B_pat (scipy).  Each count ``c`` streams
    ``(c // cap) * cap`` full-cap slots plus ``ceil_pow2(c % cap)`` for the
    remainder chunk, two f32 operands per slot, plus one f32 output per
    chunk — exactly :meth:`EscPlan.operand_bytes` of the plan the runner
    would build.
    """
    import scipy.sparse as sp

    from spada_tpu_torch.ops.element import _ceil_pow2

    pa = sp.csr_matrix(
        (np.ones(a.nnz, np.float64), a.indices, a.indptr), shape=a.shape)
    pb = sp.csr_matrix(
        (np.ones(b.nnz, np.float64), b.indices, b.indptr), shape=b.shape)
    counts = (pa @ pb).data.astype(np.int64)
    full = counts // cap
    rem = counts % cap
    n_padded = int(full.sum()) * cap + int(_ceil_pow2(rem[rem > 0]).sum())
    n_chunks = int(full.sum()) + int((rem > 0).sum())
    return {"n_padded": n_padded, "n_chunks": n_chunks,
            "nnz_c": len(counts),
            "bytes": 2 * n_padded * 4 + n_chunks * 4}


#: above this many products an ambiguous element estimate reads the plan's
#: bytes off a row sample (:func:`sampled_plan_bytes`) in place of the exact
#: pattern product, whose host time grows with E (1.5-3 s at 2^25 products)
ELEMENT_EXACT_CAP = 2**25
#: the products of that row sample, about
ELEMENT_SAMPLE_PRODUCTS = 2**21


def sampled_plan_bytes(a: CsrMatrix, b: CsrMatrix, cap: int = 512,
                       products: int = ELEMENT_SAMPLE_PRODUCTS) -> dict:
    """:func:`element_plan_bytes` estimated from every s-th row of A, s
    chosen so that the sample expands to about ``products`` products: the
    sample's exact bytes, padded slots and chunks scaled by E over the
    sample's products; ``sample_rows`` the rows it read."""
    b_len = np.diff(np.asarray(b.indptr)).astype(np.int64)
    per_nnz = b_len[np.asarray(a.indices)]
    csum = np.concatenate([[0], np.cumsum(per_nnz)])
    per_row = csum[np.asarray(a.indptr)[1:]] - csum[np.asarray(a.indptr)[:-1]]
    e = int(per_row.sum())
    stride = max(1, -(-e // max(products, 1)))
    rows = np.arange(0, a.shape[0], stride)
    e_s = int(per_row[rows].sum())
    if e_s == 0:
        return {"n_padded": 0, "n_chunks": 0, "nnz_c": 0, "bytes": 0,
                "sample_rows": len(rows)}
    sub = CsrMatrix.from_scipy(a.to_scipy()[rows].tocsr())
    pb = element_plan_bytes(sub, b, cap=cap)
    scale = e / e_s
    return {**{k: int(round(v * scale)) for k, v in pb.items()},
            "sample_rows": len(rows)}


def element_bounds(e: int, config: SpadaConfig) -> Tuple[float, float]:
    """(least, most) seconds of the element path for ``e`` products: no
    padding, and every class padded to twice its length, two f32 operands
    and one f32 output per product over the HBM rate, plus the fixed time
    per multiply (``config.element_fixed_s`` where the config carries it,
    else the reference's 30 us)."""
    bw = config.hbm_bytes_per_s
    overhead = getattr(config, "element_fixed_s", REFERENCE_ELEMENT_FIXED_S)
    return ((2 * e * 4 + e * 4) / bw + overhead,
            (2 * 2 * e * 4 + e * 4) / bw + overhead)


def estimate_element_time(a: CsrMatrix, b: CsrMatrix,
                          config: SpadaConfig,
                          tile_t: Optional[float] = None) -> dict:
    """Time model for the element (ESC) path.

    Bounds first (padding is between 1x and 2x of E, pow-2 classes), then
    the EXACT plan bytes via the pattern-product chunk histogram
    (:func:`element_plan_bytes`) whenever the decision is ambiguous — i.e.
    ``tile_t`` falls between the bounds — or when no ``tile_t`` is given
    and E is small enough that the O(E) pattern product is cheap.  Where
    the decision is ambiguous and E is above :data:`ELEMENT_EXACT_CAP`,
    the bytes come from a row sample (:func:`sampled_plan_bytes`,
    ``bytes_model`` 'sampled'); the reference runs the exact product there
    at any E.

    The fixed time per multiply is ``config.element_fixed_s`` where the
    config carries the card's (:class:`~spada_tpu_torch.config.CardConfig`),
    else the reference's 30 us.
    """
    from spada_tpu_torch.ops.element import expansion_products

    e = expansion_products(a, b)
    overhead = getattr(config, "element_fixed_s", REFERENCE_ELEMENT_FIXED_S)
    if e == 0:
        return {"e_products": 0, "t_est": overhead, "bytes_model": "exact"}
    bw = config.hbm_bytes_per_s
    t_lo, t_hi = element_bounds(e, config)
    ambiguous = (tile_t is not None and t_lo < tile_t < t_hi)
    if ambiguous or (tile_t is None and e < 2**28):
        if ambiguous and e > ELEMENT_EXACT_CAP:
            pb, kind = sampled_plan_bytes(a, b, config.element_cap), "sampled"
        else:
            pb, kind = element_plan_bytes(a, b, cap=config.element_cap), \
                "exact"
        return {"e_products": e,
                "t_est": pb["bytes"] / bw + overhead,
                "bytes_model": kind, **pb}
    return {"e_products": e, "t_est": t_hi, "t_lo": t_lo,
            "bytes_model": "worst-case"}


def dispatch_dataflow(a: CsrMatrix, b: CsrMatrix,
                      config: SpadaConfig) -> Tuple[str, dict]:
    """Tile vs element engine choice by modeled time: clustered structure
    goes to tile products, scattered structure to the streaming element
    path.  Returns (choice, details) with the tile model per edge and the
    chosen edge under ``'tile_T'``.  The tile model is
    :func:`~spada_tpu_torch.plan.card_model.planner_for`'s: the card's
    model under a ``CardConfig``, ``choose_tile_size`` under a
    ``SpadaConfig``.  The card's model prices no tile edge whose items
    alone cost more than the element side's worst case (its ``t_est`` is
    then that lower bound, ``"bound": True``): the element side is chosen
    there whatever the tile side's full price."""
    from spada_tpu_torch.ops.element import expansion_products
    from spada_tpu_torch.plan.card_model import card_tile_size, planner_for

    tile_size = planner_for(config)[0]
    with trace.span("plan.tile_edge"):
        if tile_size is card_tile_size:
            t_best, t_det = card_tile_size(
                a, b, config,
                cutoff=element_bounds(expansion_products(a, b), config)[1])
        else:
            t_best, t_det = tile_size(a, b, config)
    t_tile = min(v["t_est"] for v in t_det.values())
    elem = estimate_element_time(a, b, config, tile_t=t_tile)
    choice = "element" if elem["t_est"] < t_tile else "tile"
    return choice, {"element": elem, "tile": t_det, "tile_T": t_best}


def _spgemm_via_element(a: CsrMatrix, b: CsrMatrix, config: SpadaConfig,
                        device) -> SpGemmResult:
    from spada_tpu_torch.ops.element import spgemm_element

    er = spgemm_element(a, b, device, cap=config.element_cap,
                        backend=config.element_backend)
    # one plan (StreamResult / EscResult) or row slabs (EscSlabbedResult)
    n_padded = er.plan.n_padded if hasattr(er, "plan") else er.n_padded
    n_products = (er.plan.n_products if hasattr(er, "plan")
                  else er.n_products)
    n_chunks = (len(er.plan.esc_to_csr) if hasattr(er, "plan")
                else er.n_chunks)
    return SpGemmResult(
        shape=(a.shape[0], b.shape[1]), tm=1, tn=1,
        c_tiles=np.zeros((0, 1, 1), np.float32),
        c_tile_row=np.zeros(0, np.int32), c_tile_col=np.zeros(0, np.int32),
        n_work_items=n_chunks,
        mxu_flops=2 * n_padded,
        useful_flops=2 * n_products,
        elapsed_s=er.elapsed_s, element=er, engine_used="element",
    )


def spgemm(
    a: CsrMatrix,
    b: CsrMatrix,
    config: Optional[SpadaConfig] = None,
    dataflow: Optional[str] = None,
    tm: Optional[int] = None,
    plan=None,
    dtype=None,
    device="cuda",
) -> SpGemmResult:
    """Sparse-times-sparse matrix multiply on ``device``.

    For ``dataflow='spada'`` a planner-produced ``ExecutionPlan`` may be
    passed; otherwise a single uniform panel height is used.
    ``dataflow='element'`` forces the element-granular ESC engine; under
    ``'spada'`` the engine is picked per matrix by :func:`dispatch_dataflow`
    (``config.element_dispatch``).  The tile dtype of the uniform path is
    :func:`tile_dtype`'s of ``config`` and ``dtype`` (None or float32: the
    config's; bfloat16: bf16 tiles); the element path and the ``plan=`` path
    take ``config.engine_dtype`` alone, as in the reference.
    """
    config = config or SpadaConfig()
    dataflow = dataflow or config.dataflow
    dev = check_device(device)
    if dataflow not in ("spada", "ip", "op", "rowwise", "element"):
        raise ValueError(
            f"unknown dataflow {dataflow!r}; "
            "expected spada|ip|op|rowwise|element"
        )
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")

    if dataflow == "element" or (
        dataflow == "spada" and config.element_dispatch == "always"
    ):
        return _spgemm_via_element(a, b, config, dev)
    if (dataflow == "spada" and plan is None
            and config.element_dispatch == "auto"):
        choice, _ = dispatch_dataflow(a, b, config)
        if choice == "element":
            return _spgemm_via_element(a, b, config, dev)

    if dataflow == "spada" and plan is not None:
        from spada_tpu_torch.plan.execute import execute_plan

        return execute_plan(a, b, plan, config, device=dev)

    dtype = tile_dtype(config, dtype)
    a, b, tm, a_bsr, b_bsr, wl = _uniform_worklist(a, b, config, dataflow, tm)

    isz = dtype.itemsize
    if wl.n_items == 0:
        return SpGemmResult(
            shape=(a.shape[0], b.shape[1]), tm=tm, tn=config.tile_n,
            c_tiles=np.zeros((0, tm, config.tile_n), np.float32),
            c_tile_row=wl.c_tile_row, c_tile_col=wl.c_tile_col,
            tk=config.tile_k, tile_itemsize=isz,
        )

    engine = _resolve_engine(config)
    a_t = bsr_to_torch(a_bsr, dev, dtype)
    b_t = bsr_to_torch(b_bsr, dev, dtype)
    synchronize(dev)
    t0 = time.perf_counter()
    c_tiles = run_worklist(wl, a_t, b_t, precision=config.precision,
                           engine=engine)
    synchronize(dev)
    elapsed = time.perf_counter() - t0

    return SpGemmResult(
        shape=(a.shape[0], b.shape[1]), tm=tm, tn=config.tile_n,
        c_tiles=c_tiles, c_tile_row=wl.c_tile_row, c_tile_col=wl.c_tile_col,
        tk=config.tile_k, tile_itemsize=isz,
        n_work_items=wl.n_items,
        mxu_flops=2 * wl.n_items * tm * config.tile_k * config.tile_n,
        useful_flops=_count_useful_flops(a, b),
        elapsed_s=elapsed,
        host_state={"segments": [(wl, a_bsr.tiles, b_bsr.tiles, tm)],
                    "tk": config.tile_k, "tn": config.tile_n},
    )


def measure_device_perf(a: CsrMatrix, b: CsrMatrix,
                        config: Optional[SpadaConfig] = None,
                        dataflow: Optional[str] = None,
                        plan=None, host_state=None,
                        device="cuda") -> Optional[dict]:
    """Device time of the launches :func:`spgemm` runs for ``a @ b``.

    The port of the reference's function of the same name: ``engine_s`` is
    the median device seconds of one multiply (CUDA events,
    :func:`spada_tpu_torch.utils.timing.cuda_time`; operands, tiles and ids
    uploaded once before, C's readback excluded), beside the modelled HBM
    bytes over it (``hbm_gbps``, ``pct_hbm_sol``), the tile products' share
    of the tensor-core peak the kernels run at (``mxu_util_pct``, None on
    the element side) and ``flops_per_s``.  Peaks and bandwidth are the
    card's datasheet values (:func:`~spada_tpu_torch.config.datasheet_peaks`),
    not the config's.  A result's ``host_state`` gives the tile side's
    launches directly; otherwise they are rebuilt as :func:`spgemm` builds
    them.  Returns None on a CPU device, where there is no device time, and
    above 2^28 products on the element side (that run streamed row slabs).
    """
    dev = check_device(device)
    if dev.type != "cuda":
        return None
    config = config or SpadaConfig()
    dataflow = dataflow or config.dataflow
    name = torch.cuda.get_device_name(dev)

    # resolve the engine as spgemm() does: an auto-dispatched 'spada' run
    # may have gone to the element side
    if (dataflow == "spada" and plan is None and host_state is None
            and config.element_dispatch in ("auto", "always")):
        if config.element_dispatch == "always":
            dataflow = "element"
        elif dispatch_dataflow(a, b, config)[0] == "element":
            dataflow = "element"

    if dataflow == "element":
        return _time_element(a, b, config, dev, name)

    if host_state is not None:
        segments = host_state["segments"]
        tk, tn = host_state["tk"], host_state["tn"]
    elif dataflow == "spada" and plan is not None:
        from spada_tpu_torch.plan.execute import iter_plan_segments

        b_bsr = BsrMatrix.from_csr(b, plan.tile_k, plan.tile_n,
                                   dtype=np.float32)
        segments = [(wl, a_bsr.tiles, b_bsr.tiles, tm_) for tm_, _, _, a_bsr,
                    wl in iter_plan_segments(a, b_bsr, plan)]
        tk, tn = plan.tile_k, plan.tile_n
    else:
        _, _, tm, a_bsr, b_bsr, wl = _uniform_worklist(a, b, config,
                                                       dataflow)
        segments = [(wl, a_bsr.tiles, b_bsr.tiles, tm)] if wl.n_items else []
        tk, tn = config.tile_k, config.tile_n
    if not segments:
        return None
    return _time_segments(segments, tk, tn, config, dev, name)


def _time_element(a: CsrMatrix, b: CsrMatrix, config: SpadaConfig,
                  dev: torch.device, name: str) -> Optional[dict]:
    """The element side's multiply as :func:`spgemm_element` runs it: one
    ``esc_stream_group`` launch (backends 'auto', 'pallas') or
    :func:`esc_execute` ('xla'), on operands uploaded once."""
    from spada_tpu_torch.convert import stream_operands_to_torch
    from spada_tpu_torch.ops.element import (build_esc_plan, esc_execute,
                                             esc_operands, esc_transfer,
                                             expansion_products,
                                             resolve_element_backend)
    from spada_tpu_torch.utils.timing import cuda_time

    if a.shape[0] > 1 and expansion_products(a, b) > 2**28:
        # spgemm ran row slabs; one whole plan here would take the memory
        # the slabs exist to avoid
        return None
    eplan = build_esc_plan(a, b, cap=config.element_cap)
    backend = resolve_element_backend(config.element_backend)
    if backend == "pallas":
        from spada_tpu_torch.ops.element_stream import (build_stream_layout,
                                                        stream_execute,
                                                        stream_operands)

        layout = build_stream_layout(eplan)
        ops = stream_operands_to_torch(stream_operands(layout, eplan, a, b),
                                       dev)
        bytes_model = layout.operand_bytes()

        def run():
            return stream_execute(layout, ops)
    elif backend == "xla":
        ops = esc_transfer(esc_operands(eplan, a, b), dev)
        bytes_model = eplan.operand_bytes()

        def run():
            return esc_execute(ops)
    else:
        raise ValueError(f"unknown element backend {config.element_backend!r}")
    if not ops:
        return None
    el, _ = cuda_time(run)
    hbm = datasheet_peaks(name)["hbm_bytes_per_s"]
    return {
        "engine_s": el,
        "hbm_gbps": bytes_model / el / 1e9,
        "pct_hbm_sol": 100.0 * bytes_model / hbm / el,
        "mxu_util_pct": None,   # elementwise products, no tensor cores
        "flops_per_s": 2 * eplan.n_products / el,
    }


def _time_segments(segments, tk: int, tn: int, config: SpadaConfig,
                   dev: torch.device, name: str) -> dict:
    """One multiply's tile launches (one per segment, under the engine
    :func:`spgemm` resolves), timed together on tiles and ids uploaded
    once.  The C tiles are returned, not summed: ``cuda_time`` keeps them
    alive, so their stores are timed as a caller pays them."""
    from spada_tpu_torch.ops.engine import prepare_worklist
    from spada_tpu_torch.utils.timing import cuda_time

    dtype = tile_dtype(config)
    engine = _resolve_engine(config)
    on_dev = {}       # host tile array -> its device copy (B is shared)

    def upload(x):
        if id(x) not in on_dev:
            on_dev[id(x)] = (x, torch.from_numpy(
                np.ascontiguousarray(x, np.float32)).to(dev, dtype))
        return on_dev[id(x)][1]

    calls = []
    mxu_flops = bytes_model = 0
    for wl, a_np, b_np, tm in segments:
        calls.append(prepare_worklist(wl, upload(a_np), upload(b_np),
                                      precision=config.precision,
                                      engine=engine))
        mxu_flops += 2 * wl.n_items * tm * tk * tn
        bytes_model += (wl.n_items * (tm * tk + tk * tn) * dtype.itemsize
                        + wl.n_c_tiles * tm * tn * 4)

    el, _ = cuda_time(lambda: [call() for call in calls])
    hbm = datasheet_peaks(name)["hbm_bytes_per_s"]
    return {
        "engine_s": el,
        "hbm_gbps": bytes_model / el / 1e9,
        "pct_hbm_sol": 100.0 * bytes_model / hbm / el,
        "mxu_util_pct": 100.0 * mxu_flops / el / _peak_flops(name, dtype),
        "flops_per_s": mxu_flops / el,
    }


# the reference's name: the rate the tile kernels multiply tiles of a dtype
# at on the named card (3xTF32 for f32, the dense tensor-core rate for bf16)
_peak_flops = matmul_peak_flops


def _uniform_worklist(a: CsrMatrix, b: CsrMatrix, config: SpadaConfig,
                      dataflow: str, tm: Optional[int] = None):
    """:func:`spgemm`'s uniform path up to its launch: the panel height,
    the C-invariant densification of ``'spada'`` (k-anchor / k-perm only:
    C = (A Q)(Q^T B) exactly; scored at that height by
    ``plan.card_densify.densify_for``'s scorer) and the worklist.  Returns
    (a, b as run, tm, a_bsr, b_bsr, wl), tiles in f32 (the device dtype is
    chosen at upload)."""
    if tm is None:
        if dataflow == "op":
            from spada_tpu_torch.plan.planner import plan_op_dataflow

            tm, _ = plan_op_dataflow(a, b, config)
        elif dataflow == "rowwise":
            tm = _multirow_tm(config)
        else:
            tm = {"ip": 128}.get(dataflow, config.default_tm)
    if dataflow == "spada" and config.densify == "auto":
        from spada_tpu_torch.plan.card_densify import densify_for
        from spada_tpu_torch.plan.densify import apply_densify

        dplan = densify_for(config)(a, b, config.tile_k, config, tm=tm,
                                    allow_row_perm=False, tn=config.tile_n)
        if not dplan.is_identity:
            a, b = apply_densify(a, b, dplan)
    a_bsr = BsrMatrix.from_csr(a, tm, config.tile_k, dtype=np.float32)
    b_bsr = BsrMatrix.from_csr(b, config.tile_k, config.tile_n,
                               dtype=np.float32)
    wl = build_worklist(a_bsr, b_bsr, order="k" if dataflow == "op"
                        else "row")
    return a, b, tm, a_bsr, b_bsr, wl


def _resolve_engine(config: SpadaConfig) -> Optional[str]:
    """The engine override :func:`spgemm` and ``execute_plan`` resolve."""
    if config.use_pallas:
        return "pallas_grid"
    return None if config.engine == "auto" else config.engine


def _multirow_tm(config: SpadaConfig) -> int:
    """MultiRow panel height: the config block shape's row count
    (main.rs:67-72), clamped to a tile-viable height; degenerate shapes
    (the stock row1 config's ``[1, inf]``) fall back to a moderate fixed
    panel."""
    bs_tm = int(config.block_shape[0])
    return bs_tm if 8 <= bs_tm <= 512 else 32


def spgemm_csr(
    a: CsrMatrix,
    b: CsrMatrix,
    config: Optional[SpadaConfig] = None,
    dataflow: Optional[str] = None,
    tm: Optional[int] = None,
    prune_eps: float = 0.0,
    device="cuda",
) -> CsrMatrix:
    """SpGEMM with CSR output, C streamed through a bounded tile budget.

    The port of the reference's function of the same name.  The f32 C
    tiles [nC, tm, tn] of the o-sorted worklist are computed in slabs of
    ``config.dense_c_budget // (tm * tn * 4)`` consecutive C tiles (an
    index-range split of the worklist), each on ``device`` under the
    config's engine, read back, pruned at ``prune_eps`` and extracted, then
    freed before the next slab starts: only one slab's C tiles are on the
    device at a time.  ``'element'`` and ``'op'`` (k-major: no o-slabs) run
    in one shot.
    """
    config = config or SpadaConfig()
    dataflow = dataflow or config.dataflow
    dev = check_device(device)
    if dataflow == "element":
        return spgemm(a, b, config, dataflow="element", device=dev).to_csr()
    if dataflow == "op":
        return spgemm(a, b, config, dataflow=dataflow, tm=tm,
                      device=dev).to_csr(prune_eps)
    if tm is None:
        tm = (_multirow_tm(config) if dataflow == "rowwise"
              else {"ip": 128}.get(dataflow, config.default_tm))
    tn = config.tile_n
    a_bsr = BsrMatrix.from_csr(a, tm, config.tile_k, dtype=np.float32)
    b_bsr = BsrMatrix.from_csr(b, config.tile_k, tn, dtype=np.float32)
    wl = build_worklist(a_bsr, b_bsr, order="row")
    shape = (a.shape[0], b.shape[1])
    if wl.n_items == 0:
        return CsrMatrix(shape, np.zeros(shape[0] + 1, np.int64), [], [])

    from spada_tpu_torch.ops.worklist import WorkList

    dtype = tile_dtype(config)
    a_t = bsr_to_torch(a_bsr, dev, dtype)
    b_t = bsr_to_torch(b_bsr, dev, dtype)
    engine = _resolve_engine(config)
    slab_tiles = max(1, int(config.dense_c_budget) // (tm * tn * 4))
    rows, cols, vals = [], [], []
    for o_lo in range(0, wl.n_c_tiles, slab_tiles):
        o_hi = min(o_lo + slab_tiles, wl.n_c_tiles)
        lo, hi = np.searchsorted(wl.o_tid, [o_lo, o_hi])
        sub = WorkList(
            a_tid=wl.a_tid[lo:hi], b_tid=wl.b_tid[lo:hi],
            o_tid=wl.o_tid[lo:hi] - o_lo, first=wl.first[lo:hi].copy(),
            c_tile_row=wl.c_tile_row[o_lo:o_hi],
            c_tile_col=wl.c_tile_col[o_lo:o_hi],
            n_c_tiles=o_hi - o_lo, order="row",
        )
        if len(sub.first):
            sub.first[0] = 1
        c_dev = run_worklist(sub, a_t, b_t, precision=config.precision,
                             engine=engine)
        tiles = c_tiles_to_numpy(c_dev)
        del c_dev   # this slab's device C goes back to the allocator
        t, r, c = np.nonzero(np.abs(tiles) > prune_eps)
        rr = sub.c_tile_row[t].astype(np.int64) * tm + r
        cc = sub.c_tile_col[t].astype(np.int64) * tn + c
        keep = (rr < shape[0]) & (cc < shape[1])
        rows.append(rr[keep])
        cols.append(cc[keep])
        vals.append(tiles[t, r, c][keep])
    rows, cols, vals = (np.concatenate(x) for x in (rows, cols, vals))
    # C tiles come in (tile row, tile col) order and a tile's entries in
    # (row, col) order, so a stable sort by row alone orders the entries
    # as (row, col); no coordinate repeats
    order = np.argsort(rows, kind="stable")
    indptr = np.zeros(shape[0] + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=shape[0]))
    return CsrMatrix(shape, indptr, cols[order], vals[order])
