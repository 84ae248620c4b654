"""The value-refresh serving loop on the card (port of
``tools/bench_value_refresh.py``).

The reference's NN workload is pruned-network GEMMs with a STATIC sparsity
structure and fresh values every batch (``py2rust.rs:5-60``).  The serving
loop pays every structure-dependent cost once:

  cold (once per structure): the value maps, BSR tiles, worklist and the
        prepared launch (``prepare_cached``: ids checked and uploaded once);
  per batch: the host scatter of the new values into tile payloads
        (``BsrValueMap.fill``), their upload into the tile tensors the
        prepared launch holds (``copy_`` with a cast; no id is uploaded
        again), one ``tile_spgemm`` launch.

It times each stage on the bench's NN pair (``block_sparse_csr(16384,
16384, 384, 0.2, seed=5)`` x ``relu_activation_csr(16384, 4096, 0.35,
seed=6)``, T = 384, bf16 tiles, as the reference runs it) over 5 batches in
which both operands get new values (the worst case: a deployed model would
refresh only the activations), beside the naive per-batch ``from_csr``
rebuild.  The last batch's C is gated against scipy of the refreshed pair
on its first 2048 rows (1e-2 of max|C|).

The element side runs the same loop on the locpl pair
(``localized_powerlaw_csr(65536, 65536, 32, seed=1 / 2)``): one ESC plan and
stream layout built once; per batch the reference's per-refresh gather
(``stream_operands``), the upload into the held operand tensors and one
``esc_stream_group`` launch; the last batch gated to 1e-3.  The values are
scattered on the host, as in the reference.

Host stages are wall seconds; the launches are device time on CUDA events.
On the CPU the plain versions run and are gated; the uploads and launches
are not timed.

    python -m spada_tpu_torch.tools.bench_value_refresh
    python -m spada_tpu_torch.tools.bench_value_refresh --device cpu --scale 16
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from spada_tpu_torch.convert import synchronize
from spada_tpu_torch.tools.harness import (card_name, device_s,
                                           first_rows_ref, gate, tile_rows)


def refreshed(m, data: np.ndarray):
    """The CSR matrix ``m`` with its values replaced by ``data``."""
    from spada_tpu_torch.sparse.csr import CsrMatrix

    return CsrMatrix(m.shape, m.indptr, m.indices, data)


class TileRefresh:
    """The tile side's serving loop: built once per structure, then
    :meth:`fill`, :meth:`upload` and :meth:`launch` per batch."""

    def __init__(self, a, b, T: int, dev, dtype=torch.bfloat16):
        from spada_tpu_torch.convert import bsr_to_torch
        from spada_tpu_torch.ops.engine import prepare_cached
        from spada_tpu_torch.ops.worklist import build_worklist
        from spada_tpu_torch.sparse.bsr import BsrMatrix, BsrValueMap

        self.T = T
        self.vm_a = BsrValueMap.from_structure(a, T, T)
        self.vm_b = BsrValueMap.from_structure(b, T, T)
        a_bsr = BsrMatrix.from_csr(a, T, T)
        b_bsr = BsrMatrix.from_csr(b, T, T)
        self.wl = wl = build_worklist(a_bsr, b_bsr, order="row")
        self.a_t = bsr_to_torch(a_bsr, dev, dtype)
        self.b_t = bsr_to_torch(b_bsr, dev, dtype)
        # upload() rewrites A's tiles under the call: no slice mask
        self.launch = prepare_cached(self.a_t, self.b_t, wl.a_tid, wl.b_tid,
                                     wl.o_tid, wl.n_c_tiles, a_fixed=False)

    def fill(self, a_data: np.ndarray, b_data: np.ndarray) -> tuple:
        """The host tile payloads of new values (f32)."""
        return self.vm_a.fill(a_data), self.vm_b.fill(b_data)

    def upload(self, a_tiles: np.ndarray, b_tiles: np.ndarray) -> None:
        """Copy host payloads into the held tile tensors, cast to their
        dtype."""
        self.a_t.copy_(torch.from_numpy(a_tiles))
        self.b_t.copy_(torch.from_numpy(b_tiles))

    def first_rows(self, c, shape: tuple, rows: int):
        return tile_rows(c, self.wl.c_tile_row, self.wl.c_tile_col, self.T,
                         self.T, shape, rows)


class ElementRefresh:
    """The element side's serving loop: one ESC plan and stream layout,
    the operands held on the device; :meth:`gather`, :meth:`upload` and
    :meth:`launch` per batch."""

    def __init__(self, a, b, dev, cap: int = 512):
        from spada_tpu_torch.convert import stream_operands_to_torch
        from spada_tpu_torch.ops.element import build_esc_plan
        from spada_tpu_torch.ops.element_stream import (build_stream_layout,
                                                        stream_operands)

        self.a, self.b = a, b
        self.plan = build_esc_plan(a, b, cap=cap)
        self.layout = build_stream_layout(self.plan)
        self.ops = stream_operands_to_torch(
            stream_operands(self.layout, self.plan, a, b), dev)

    def gather(self, a_data: np.ndarray, b_data: np.ndarray) -> list:
        """The per-class host operands of new values (``stream_operands``
        of the refreshed pair)."""
        from spada_tpu_torch.ops.element_stream import stream_operands

        return stream_operands(self.layout, self.plan,
                               refreshed(self.a, a_data),
                               refreshed(self.b, b_data))

    def upload(self, host_ops) -> None:
        for (a_d, b_d), (a_h, b_h) in zip(self.ops, host_ops):
            a_d.copy_(torch.from_numpy(a_h))
            b_d.copy_(torch.from_numpy(b_h))

    def launch(self) -> tuple:
        from spada_tpu_torch.ops.element_stream import stream_execute

        return stream_execute(self.layout, self.ops)

    def to_csr(self, values):
        from spada_tpu_torch.ops.element_stream import stream_to_csr

        return stream_to_csr(self.layout, values).to_scipy()


def _batches(a, b, n_batches: int, seed: int):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield (rng.standard_normal(a.nnz).astype(np.float32),
               np.abs(rng.standard_normal(b.nnz)).astype(np.float32))


def _median_ms(xs) -> Optional[float]:
    return None if not xs or xs[0] is None else float(np.median(xs)) * 1e3


def run_tile(a, b, T: int, dev, n_batches: int = 5, seed: int = 0,
             gate_rows: int = 2048, dtype=torch.bfloat16,
             log: Callable[[str], None] = print) -> dict:
    """The tile loop's stage times (ms; cold in s) and the last batch's
    gate."""
    from spada_tpu_torch.sparse.bsr import BsrMatrix

    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    loop = TileRefresh(a, b, T, dev, dtype)
    synchronize(dev)
    cold_s = time.perf_counter() - t0
    log(f"tile cold build: {cold_s:.2f} s (W={loop.wl.n_items} "
        f"nC={loop.wl.n_c_tiles}, T={T}, {dtype})")
    loop.launch()               # the first use builds and loads the kernels
    fill_s, up_s, eng_s = [], [], []
    for new_a, new_b in _batches(a, b, n_batches, seed):
        t0 = time.perf_counter()
        at, bt = loop.fill(new_a, new_b)
        t1 = time.perf_counter()
        loop.upload(at, bt)
        synchronize(dev)
        t2 = time.perf_counter()
        eng_s.append(device_s(loop.launch, dev))
        fill_s.append(t1 - t0)
        up_s.append(t2 - t1 if cuda else None)
    a2, b2 = refreshed(a, new_a), refreshed(b, new_b)
    limit = 1e-2 if dtype == torch.bfloat16 else 1e-4
    err = gate(loop.first_rows(loop.launch(), (a.shape[0], b.shape[1]),
                               gate_rows),
               first_rows_ref(a2, b2, gate_rows), limit, "tile refresh")
    t0 = time.perf_counter()
    BsrMatrix.from_csr(a2, T, T)
    BsrMatrix.from_csr(b2, T, T)
    rebuild_s = time.perf_counter() - t0
    out = {"cold_s": cold_s, "fill_ms": _median_ms(fill_s),
           "upload_ms": _median_ms(up_s), "engine_ms": _median_ms(eng_s),
           "rebuild_ms": rebuild_s * 1e3, "relerr": err}
    log(f"per batch: host value scatter {out['fill_ms']:8.1f} ms")
    log(f"           upload + cast      {_ms(out['upload_ms'])}")
    log(f"           engine             {_ms(out['engine_ms'])}")
    log(f"naive per-batch from_csr rebuild: {out['rebuild_ms']:.0f} ms "
        f"(vs {out['fill_ms']:.0f} ms refresh scatter); last batch gate "
        f"{err:.1e}")
    return out


def run_element(a, b, dev, n_batches: int = 5, seed: int = 0,
                gate_rows: int = 2048,
                log: Callable[[str], None] = print) -> dict:
    """The element loop's stage times (ms; cold in s) and the last batch's
    gate."""
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    loop = ElementRefresh(a, b, dev)
    synchronize(dev)
    cold_s = time.perf_counter() - t0
    log(f"element cold build: {cold_s:.2f} s (E={loop.plan.n_products}, "
        f"{len(loop.layout.classes)} classes)")
    loop.launch()
    gather_s, up_s, eng_s = [], [], []
    for new_a, new_b in _batches(a, b, n_batches, seed):
        t0 = time.perf_counter()
        host_ops = loop.gather(new_a, new_b)
        t1 = time.perf_counter()
        loop.upload(host_ops)
        synchronize(dev)
        t2 = time.perf_counter()
        eng_s.append(device_s(loop.launch, dev))
        gather_s.append(t1 - t0)
        up_s.append(t2 - t1 if cuda else None)
    err = gate(loop.to_csr(loop.launch())[:gate_rows],
               first_rows_ref(refreshed(a, new_a), refreshed(b, new_b),
                              gate_rows), 1e-3, "element refresh")
    out = {"cold_s": cold_s, "gather_ms": _median_ms(gather_s),
           "upload_ms": _median_ms(up_s), "engine_ms": _median_ms(eng_s),
           "relerr": err}
    log(f"per batch: host operand gather {out['gather_ms']:8.1f} ms")
    log(f"           upload             {_ms(out['upload_ms'])}")
    log(f"           engine             {_ms(out['engine_ms'])}; last batch "
        f"gate {err:.1e}")
    return out


def _ms(x: Optional[float]) -> str:
    return "not timed" if x is None else f"{x:8.3f} ms"


def run(device="cuda", scale: int = 1, n_batches: int = 5,
        log: Callable[[str], None] = print) -> dict:
    """Both loops at the bench's sizes divided by ``scale``."""
    from spada_tpu_torch.convert import check_device
    from spada_tpu_torch.io.workloads import (block_sparse_csr,
                                              localized_powerlaw_csr,
                                              relu_activation_csr)

    dev = check_device(device)
    log(f"card {card_name(dev) or 'none (cpu)'}")
    t0 = time.perf_counter()
    n = 16384 // scale
    a = block_sparse_csr(n, n, 384, 0.2, seed=5, dtype=np.float32)
    b = relu_activation_csr(n, 4096 // scale, 0.35, seed=6, dtype=np.float32)
    log(f"nn pair gen {time.perf_counter() - t0:.1f} s  nnzA={a.nnz} "
        f"nnzB={b.nnz}")
    out = {"tile": run_tile(a, b, 384, dev, n_batches, log=log)}
    del a, b
    t0 = time.perf_counter()
    m = 65536 // scale
    a = localized_powerlaw_csr(m, m, 32.0, seed=1, dtype=np.float32)
    b = localized_powerlaw_csr(m, m, 32.0, seed=2, dtype=np.float32)
    log(f"locpl pair gen {time.perf_counter() - t0:.1f} s  nnzA={a.nnz} "
        f"nnzB={b.nnz}")
    out["element"] = run_element(a, b, dev, n_batches, log=log)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=int, default=1,
                   help="divide the pairs' sizes by this")
    args = p.parse_args(argv)
    run(args.device, args.scale)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
