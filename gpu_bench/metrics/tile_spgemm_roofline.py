"""The ``tile_spgemm`` kernels' share of their roofline, in percent: the
product's least time over the device time of the window's ``tile_spgemm``
kernels per product.

Least time: the larger of the useful FLOP over the tensor cores' rate at
the cell's tile precision (its ``port_config``'s ``engine_dtype``, float32
by default) and the least bytes over the HBM bandwidth, both counted from
the cell's inputs (``counts``).  The tile kernels multiply on the tensor
cores: bf16 tiles at the dense bf16 rate, f32 tiles as 3xTF32, three TF32
products for each f32 one (``spada_tpu_torch/csrc/tile_mma.cuh``), so at a
third of the dense TF32 rate.  ``spgemm_roofline`` divides by the f32 rate
outside the tensor cores instead, which the tile kernels are not held to.
Device time: the operations of the traced window whose name holds
``tile_spgemm`` (the thin and the wide block), over the products the window
completed.  None without a device trace, or where the window ran no
``tile_spgemm`` kernel.
"""

from gpu_bench.cells import load_cell
from gpu_bench.counts import PEAK_HBM_BYTES_S

#: NVIDIA H100 SXM data sheet, dense tensor-core rates at the full 700 W:
#: TF32 495 TFLOP/s, bf16 989 TFLOP/s
PEAK_TF32_FLOP_S = 495e12
PEAK_BF16_FLOP_S = 989e12
PEAK_TILE_FLOP_S = {"float32": PEAK_TF32_FLOP_S / 3,
                    "bfloat16": PEAK_BF16_FLOP_S}


def least_time(flop: int, nbytes: int, dtype: str) -> float:
    return max(flop / PEAK_TILE_FLOP_S[dtype], nbytes / PEAK_HBM_BYTES_S)


def read(rec):
    if rec.trace is None or not rec.products:
        return None
    kernel_s = sum(t for name, t in rec.trace["device_ops"]
                   if "tile_spgemm" in name)
    if kernel_s <= 0:
        return None
    dtype = load_cell(rec.cell).config.get("port_config", {}).get(
        "engine_dtype", "float32")
    return 100 * least_time(rec.flop, rec.nbytes, dtype) / (
        kernel_s / rec.products)
