"""Execution metrics and roofline reporting.

The reference emits counter totals at the end of a run (main.rs:102-111:
exec cycles, A/B/C read+write element counts, cache read/write).  The rebuild
reports the same counters through the functional traffic model
(:mod:`spada_tpu.models.traffic`) and adds the hardware-truth metrics the
BASELINE north star asks for: GFLOP/s, nnz(C)/s, modeled HBM bytes, and
achieved fraction of roofline speed-of-light.

Copy of :mod:`spada_tpu.utils.metrics`
for spada_tpu_torch, held equal to it by ``tests/test_torch_host.py``; only
the imports differ.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from spada_tpu_torch.config import SpadaConfig


@dataclasses.dataclass
class PerfReport:
    """Hardware-execution report for one SpGEMM."""

    workload: str
    dataflow: str
    elapsed_s: float
    useful_flops: int          # 2 * scalar multiply count
    mxu_flops: int             # FLOPs issued to the MXU (incl. tile padding)
    nnz_c: int
    hbm_bytes_model: int       # tile-engine byte model (A+B tiles, C once)
    n_work_items: int = 0
    backend: str = "tpu"

    @property
    def useful_gflops(self) -> float:
        return self.useful_flops / max(self.elapsed_s, 1e-12) / 1e9

    @property
    def mxu_gflops(self) -> float:
        return self.mxu_flops / max(self.elapsed_s, 1e-12) / 1e9

    @property
    def nnz_c_per_s(self) -> float:
        return self.nnz_c / max(self.elapsed_s, 1e-12)

    @property
    def density_efficiency(self) -> float:
        """Useful / issued FLOPs — how well tiles are packed (the analog of
        the reference's multiplier utilization, simulator.rs:762-775)."""
        return self.useful_flops / max(self.mxu_flops, 1)

    def sol_seconds(self, config: Optional[SpadaConfig] = None) -> float:
        """Roofline time bound: max(HBM time, MXU time)."""
        config = config or SpadaConfig()
        t_mem = self.hbm_bytes_model / config.hbm_bytes_per_s
        t_flop = self.mxu_flops / config.peak_flops_f32
        return max(t_mem, t_flop)

    def pct_of_sol(self, config: Optional[SpadaConfig] = None) -> float:
        return self.sol_seconds(config) / max(self.elapsed_s, 1e-12)

    def as_dict(self, config: Optional[SpadaConfig] = None) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            useful_gflops=self.useful_gflops,
            mxu_gflops=self.mxu_gflops,
            nnz_c_per_s=self.nnz_c_per_s,
            density_efficiency=self.density_efficiency,
            pct_of_sol=self.pct_of_sol(config),
        )
        return d

    def json_line(self, config: Optional[SpadaConfig] = None) -> str:
        return json.dumps(self.as_dict(config))


def format_report(perf: PerfReport, traffic=None,
                  config: Optional[SpadaConfig] = None) -> str:
    """Human-readable end-of-run report (the rebuild's main.rs:95-116)."""
    lines = [
        f"workload: {perf.workload}   dataflow: {perf.dataflow}   "
        f"backend: {perf.backend}",
        f"elapsed: {perf.elapsed_s*1e3:.3f} ms   "
        f"useful: {perf.useful_gflops:.2f} GFLOP/s   "
        f"mxu: {perf.mxu_gflops:.2f} GFLOP/s   "
        f"nnz(C)/s: {perf.nnz_c_per_s:.3e}",
        f"work items: {perf.n_work_items}   nnz(C): {perf.nnz_c}   "
        f"tile packing: {perf.density_efficiency*100:.2f}%   "
        f"%-of-SoL: {perf.pct_of_sol(config)*100:.1f}%",
    ]
    if traffic is not None:
        t = traffic.as_dict()
        lines += [
            "traffic model (reference counter semantics):",
            f"  A read: {t['a_mem_read']}   B read: {t['b_mem_read']}   "
            f"C read: {t['psum_mem_read']}   C write: {t['psum_mem_write']}",
            f"  cache read: {t['cache_read']}   cache write: {t['cache_write']}   "
            f"miss: {t['miss_count']}   b_evict: {t['b_evict_count']}   "
            f"psum_evict: {t['psum_evict_count']}",
            f"  b_reuse: {t['b_reuse']:.3f}   c_reuse: {t['c_reuse']:.3f}   "
            f"modeled DRAM: {t['dram_bytes']/1e6:.2f} MB",
        ]
    return "\n".join(lines)
