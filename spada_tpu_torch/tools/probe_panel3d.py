"""Run-of-two products per item or as one contraction (port of
``tools/probe_panel3d.py``).

The TPU probe asked whether one dot over two adjacent cache slots (a
depth-2T panel) beats two per-item dots and an accumulate.  Here the slot
caches are S = 12 A and B tiles of T = 384 bf16 in device memory (3.5 MB
each, held in L2: a 288 KiB tile does not fit an SM's shared memory), and
G x OG = 1200 runs of two items (slots s, s + 1) go through:

- ``peritem``: ``tile_spgemm`` on that worklist (per-item k loop, one
  accumulator in registers across the run);
- ``panel2``: ``tile_panel`` on the same worklist (the run as one
  contraction over k-transposed A);
- ``panel2s``: ``panel2`` with s = j % (S - 2) for the run's place j in its
  group of OG, the TPU's static s (the kernel reads ids at run time either
  way).

Every run's C is written (G·OG·T·T f32, 708 MB), so the card cannot drop
work.  Prints ms and ns per item beside the bound (dense bf16 slot tiles:
every product is useful; the slots read and C written once):

    python -m spada_tpu_torch.tools.probe_panel3d
    python -m spada_tpu_torch.tools.probe_panel3d --device cpu --T 128 --G 4
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict

import numpy as np
import torch

S = 12    # slot tiles of A and of B
OG = 6    # runs per TPU grid step
L = 2     # run length
VARIANTS = ("peritem", "panel2", "panel2s")


def slot_data(T: int, G: int, device, seed: int = 0):
    """Each run's first slot, and the slot caches: A k-major ([tk, tm] per
    slot, as the TPU caches hold it) and B natural, bf16."""
    rng = np.random.default_rng(seed)
    slots = rng.integers(0, S - L, size=G * OG).astype(np.int32)
    a_t = torch.from_numpy(rng.standard_normal((S, T, T), np.float32)).to(
        device, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((S, T, T), np.float32)).to(
        device, torch.bfloat16)
    return slots, a_t, b


def library_case(T: int, G: int, device, seed: int = 0):
    """(call, label): one PyTorch call computing ``peritem``'s C, a
    ``torch.bmm`` of the G * OG runs' operands gathered beforehand, A
    [T, L*T] @ B [L*T, T] in bf16, f32 out where ``bmm`` takes
    ``out_dtype`` (bf16 out otherwise)."""
    slots, a_t, b = slot_data(T, G, device, seed)
    idx = torch.from_numpy(slots[:, None] + np.arange(L, dtype=np.int32)).to(
        a_t.device).long()
    n_runs = len(slots)
    a_run = a_t[idx].permute(0, 3, 1, 2).reshape(n_runs, T, L * T)
    b_run = b[idx].reshape(n_runs, L * T, T)
    del a_t, b
    try:
        torch.bmm(a_run[:1, :8, :8], b_run[:1, :8, :8],
                  out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return (lambda: torch.bmm(a_run, b_run),
                f"torch.bmm of {n_runs} gathered [{T}, {L * T}]·"
                f"[{L * T}, {T}] bf16 run pairs, bf16 out")
    return (lambda: torch.bmm(a_run, b_run, out_dtype=torch.float32),
            f"torch.bmm of {n_runs} gathered [{T}, {L * T}]·[{L * T}, {T}] "
            f"bf16 run pairs, f32 out")


def panel3d_case(T: int, G: int, device, variant: str, seed: int = 0):
    """(kernel, plain, n_items) for one variant: zero-argument calls of the
    kernel's wrapper and its plain version on the probe's slot worklist."""
    from spada_tpu_torch.convert import tile_ptr_of
    from spada_tpu_torch.ops import engine as E

    slots, a_t, b = slot_data(T, G, device, seed)
    if variant == "panel2s":
        slots = (np.arange(G * OG) % OG % (S - L)).astype(np.int32)
    ids = (slots[:, None] + np.arange(L, dtype=np.int32)).reshape(-1)
    n_c = G * OG
    o = np.repeat(np.arange(n_c, dtype=np.int32), L)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    ai = bi = dev(ids)
    tp = dev(tile_ptr_of(o, n_c))
    if variant == "peritem":
        a = a_t.transpose(1, 2).contiguous()
        return (lambda: E.tile_spgemm(a, b, ai, bi, tp),
                lambda: E.run_worklist_reference(a, b, ai, bi, dev(o), n_c),
                len(ids))
    return (lambda: E.tile_panel(a_t, b, ai, bi, tp),
            lambda: E.tile_panel_reference(a_t, b, ai, bi, tp), len(ids))


def run(T: int = 384, G: int = 200, device="cuda",
        log: Callable[[str], None] = print) -> Dict[str, dict]:
    """Each variant once against its plain version, then timed on a CUDA
    device.  Returns {variant: {"relerr", "max_abs_err", "ms",
    "ns_per_item", "plain_ms"}} (times None on the CPU)."""
    from spada_tpu_torch.convert import check_device
    from spada_tpu_torch.config import roofline_bound, tile_work

    dev = check_device(device)
    cuda = dev.type == "cuda"
    n_items = G * OG * L
    # the slot tiles are dense: every element of an item's tiles is a
    # useful product
    slot = torch.empty((S, T, T), dtype=torch.bfloat16, device="meta")
    flops, nbytes = tile_work(slot, slot, n_items, G * OG)
    bound, by = roofline_bound(
        flops, nbytes, torch.cuda.get_device_name(dev) if cuda else None,
        torch.bfloat16, matmul=True)
    log(f"{G * OG} runs of {L} items, T={T} bf16, S={S} slots; bound "
        f"{bound * 1e3:.3f} ms ({by}; {bound / n_items * 1e9:.0f} ns/item)")
    out = {}
    for variant in VARIANTS:
        kernel, plain, _ = panel3d_case(T, G, dev, variant)
        got, ref = kernel(), plain()
        err = float((got.float() - ref.float()).abs().max())
        rec = {"max_abs_err": err,
               "relerr": err / max(float(ref.abs().max()), 1e-30),
               "ms": None, "ns_per_item": None, "plain_ms": None}
        del got, ref
        if cuda:
            from spada_tpu_torch.utils.timing import cuda_time

            t, _ = cuda_time(kernel)
            tp, _ = cuda_time(plain, warmup=1, reps=3)
            rec.update(ms=t * 1e3, ns_per_item=t / n_items * 1e9,
                       plain_ms=tp * 1e3)
            log(f"  {variant:8s} {t * 1e3:8.3f} ms ({rec['ns_per_item']:5.0f}"
                f" ns/item; bound {bound * 1e3:.3f} ms)  plain "
                f"{tp * 1e3:8.3f} ms  max|d|/max|ref| {rec['relerr']:.1e}")
        else:
            log(f"  {variant:8s} max|d|/max|ref| {rec['relerr']:.1e} (plain "
                f"version on the CPU, not timed)")
        out[variant] = rec
        del kernel, plain
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--T", type=int, default=384, help="tile edge")
    p.add_argument("--G", type=int, default=200, help="TPU grid steps")
    args = p.parse_args(argv)
    return run(args.T, args.G, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
