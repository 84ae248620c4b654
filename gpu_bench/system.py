"""The system under test: spada_tpu_torch, planned once through its entry and
its launches prepared on operands held on the device.

This is the only module of the benchmark that imports the port.  It composes
the port's own functions in the order ``execute_plan`` and ``spgemm_element``
use them, but keeps the operands on the device and the launches prepared, so
that a product enqueues the kernels and nothing else:

- tile side: ``plan.execute.iter_plan_segments`` and ``convert.bsr_to_torch``,
  then one ``ops.engine.prepare_worklist`` call per segment and value set,
  under the engine ``execute_plan`` resolves; C is mapped back through
  ``PlanResult``;
- element side: ``ops.element.build_esc_plan``, then
  ``ops.element_stream.build_stream_layout``, ``stream_operands`` and
  ``convert.stream_operands_to_torch`` per value set, ``stream_execute`` per
  product and ``stream_to_csr`` for C (the ``'pallas'`` backend); or, for
  the ``'xla'`` backend, ``esc_operands``, ``esc_transfer``, ``esc_execute``
  and ``EscResult.to_csr``.

``control=True`` prepares the port's lower-precision path instead: bf16 tiles
on the tile side, bf16 operands of the ``'xla'`` backend on the element side.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

#: the port's precision of each side's control: bf16 tiles, bf16 operands
CONTROL_DTYPE = torch.bfloat16


def port_csr(m):
    """The port's ``CsrMatrix`` over the arrays of the benchmark's CSR."""
    from spada_tpu_torch.sparse.csr import CsrMatrix

    return CsrMatrix(m.shape, m.indptr, m.indices, m.data, check=False)


def card_config(device: torch.device, overrides: dict):
    """``h100_config`` for the card, with the configuration's overrides."""
    from spada_tpu_torch.config import h100_config

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else None)
    return h100_config(name, **overrides)


def plan(a, b, config, device: torch.device, log: Callable[[str], None]):
    """The port's decisions for a.b: dispatch, tile edge and panel plan, or
    the element side (``cli.plan_spada``, densify off)."""
    from spada_tpu_torch.cli import plan_spada

    run = plan_spada(a, b, config, device=str(device), log=log)
    if run.row_remap is not None:
        raise RuntimeError("the plan permutes C's rows; the benchmark plans "
                           "with densify off")
    return run


def compile_kernels(device: torch.device) -> float:
    """Seconds to build (where stale) and load the port's CUDA kernels."""
    if device.type != "cuda":
        return 0.0
    from spada_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    return time.perf_counter() - t0


def launches() -> int:
    """Kernel launches the port has counted: a launch of the thin block
    also counts under ``<kernel>_thin``, so those are left out."""
    from spada_tpu_torch import _build

    return sum(n for k, n in _build.launches.items()
               if not k.endswith("_thin"))


class TileSide:
    """One ``prepare_worklist`` launch per plan segment and value set."""

    kind = "tile"

    def __init__(self, run, pairs, device: torch.device, control: bool):
        from spada_tpu_torch.ops.spgemm import _resolve_engine, tile_dtype
        from spada_tpu_torch.convert import bsr_to_torch
        from spada_tpu_torch.ops.engine import prepare_worklist
        from spada_tpu_torch.plan.execute import iter_plan_segments
        from spada_tpu_torch.sparse.bsr import BsrMatrix, BsrValueMap

        config, p = run.config, run.plan
        engine = _resolve_engine(config)
        dtype = CONTROL_DTYPE if control else tile_dtype(config)
        self.shape = (pairs[0][0].shape[0], pairs[0][1].shape[1])
        self.tile_n = p.tile_n
        b_map = BsrValueMap.from_structure(pairs[0][1], p.tile_k, p.tile_n)
        segments = {}   # id(A) -> [(tm, bases, A's tiles on device, wl)]
        self.calls = []
        for a, b in pairs:
            b_bsr = BsrMatrix(b.shape, p.tile_k, p.tile_n, b_map.fill(b.data),
                              b_map.tile_col, b_map.tile_rowptr,
                              b_map.nnz_per_tile)
            if id(a) not in segments:
                segments[id(a)] = [
                    (tm, bases, a_bsr.shape[0], bsr_to_torch(a_bsr, device,
                                                             dtype), wl)
                    for tm, _, bases, a_bsr, wl in iter_plan_segments(
                        a, b_bsr, p)]
            b_t = bsr_to_torch(b_bsr, device, dtype)
            self.calls.append([
                prepare_worklist(wl, a_t, b_t, precision=config.precision,
                                 engine=engine)
                for _, _, _, a_t, wl in segments[id(a)]])
        self.maps = [(tm, bases, rows, wl.c_tile_row, wl.c_tile_col,
                      wl.n_items)
                     for tm, bases, rows, _, wl in segments[id(pairs[0][0])]]
        self.items = sum(m[5] for m in self.maps)

    def product(self, s: int):
        return [call() for call in self.calls[s]]

    def readback(self, outs):
        """("dense", C) through the port's ``PlanResult``."""
        from spada_tpu_torch.convert import c_tiles_to_numpy
        from spada_tpu_torch.ops.spgemm import SpGemmResult
        from spada_tpu_torch.plan.execute import PlanResult, _Segment

        segs = []
        for c, (tm, bases, rows, c_row, c_col, _) in zip(outs, self.maps):
            res = SpGemmResult(shape=(rows, self.shape[1]), tm=tm,
                               tn=self.tile_n, c_tiles=c_tiles_to_numpy(c),
                               c_tile_row=c_row, c_tile_col=c_col)
            segs.append(_Segment(tm, res, bases))
        return "dense", PlanResult(self.shape, segs).todense()


class ElementSide:
    """One grouped launch of every class per product (``'pallas'``), or the
    ``'xla'`` backend's operations."""

    kind = "element"

    def __init__(self, run, pairs, device: torch.device, control: bool):
        from spada_tpu_torch.convert import stream_operands_to_torch
        from spada_tpu_torch.ops import element as el
        from spada_tpu_torch.ops import element_stream as es

        config = run.config
        backend = "xla" if control else el.resolve_element_backend(
            config.element_backend)
        a0, b0 = pairs[0]
        if el.expansion_products(a0, b0) > 2**28:
            raise RuntimeError("the product needs the element side's row "
                               "slabs, which the benchmark does not drive")
        self.plan = el.build_esc_plan(a0, b0, cap=config.element_cap)
        self.backend = backend
        self.ops = []
        if backend == "pallas":
            self.layout = es.build_stream_layout(self.plan)
            for a, b in pairs:
                self.ops.append(stream_operands_to_torch(
                    es.stream_operands(self.layout, self.plan, a, b),
                    device))
            self._run = lambda ops: es.stream_execute(self.layout, ops)
        elif backend == "xla":
            for a, b in pairs:
                ops = el.esc_transfer(el.esc_operands(self.plan, a, b),
                                      device)
                if control:
                    ops = tuple((x.to(CONTROL_DTYPE), y.to(CONTROL_DTYPE))
                                for x, y in ops)
                self.ops.append(ops)
            self._run = el.esc_execute
        else:
            raise ValueError(f"unknown element backend {backend!r}")
        self.items = len(self.plan.esc_to_csr)

    def product(self, s: int):
        return self._run(self.ops[s])

    def readback(self, outs):
        """("csr", (indptr, indices, data)) through the port's
        ``stream_to_csr`` or ``EscResult.to_csr``."""
        from spada_tpu_torch.ops import element as el
        from spada_tpu_torch.ops import element_stream as es

        c = (es.stream_to_csr(self.layout, outs) if self.backend == "pallas"
             else el.EscResult(self.plan, outs).to_csr())
        return "csr", (np.asarray(c.indptr), np.asarray(c.indices),
                       np.asarray(c.data))


def prepare(run, pairs, device: torch.device, control: bool = False):
    """The side the plan chose, with every value set's operands on
    ``device`` and its launches prepared."""
    side = TileSide if run.choice == "tile" else ElementSide
    return side(run, pairs, device, control)
