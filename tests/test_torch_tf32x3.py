"""The arithmetic of the tensor-core tile block on the CPU: 3xTF32.

``csrc/tile_mma.cuh`` runs f32 tiles on TF32 tensor cores by splitting each
operand element x into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x -
big) and summing a_small*b_big + a_big*b_small + a_big*b_big, small terms
first.  The tensor cores' f32 sums round toward zero, so the block sums the
mmas of one k-slice from zero and folds that into the run's accumulator
with an f32 add, which rounds to nearest.  A CUDA kernel has no CPU mode,
so this file emulates that arithmetic in plain PyTorch (TF32 rounding on
the int32 view: to nearest, ties away from zero, a 10-bit mantissa; each
mma's sum rounded toward zero) and shows on runs of nn-like tiles (normal A
blocks, ReLU-sparse non-negative B) that it stays at f32-level error,
inside the kernels' 1e-5 gate against the f32 plain engine, where a single
TF32 pass would not, and where sums carried through the tensor cores over
a whole run would not.  The kernels themselves are held to the plain
engine on the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from spada_tpu_torch.ops.engine import run_worklist_reference

TM, TN = 128, 128
RUNS = (1, 8, 64)
KI, BK = 8, 32  # k per mma (m16n8k8) and per k-slice of f32 tiles


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to a 10-bit mantissa, to nearest,
    ties away from zero (add half of the dropped 13 bits to the magnitude,
    then clear them; the sign bit is untouched)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def mma_add(d: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """One mma's sum: f32 ``d`` plus the exact f64 sum ``p`` of its products,
    rounded toward zero to f32 (rounded to nearest, then one step toward
    zero where that grew the magnitude)."""
    x = d.double() + p
    y = x.float()
    up = y.double().abs() > x.abs()
    return torch.where(up, torch.nextafter(y, torch.zeros_like(y)), y)


def tf32x3_run(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_w a[w] @ b[w] from the split alone: per item the three TF32
    products (each exact in f32: 11 x 11 significant bits) added into an
    f32 accumulator, small terms first, rounding to nearest.  The kernel's
    sums round otherwise (:func:`kernel_run`)."""
    acc = torch.zeros((a.shape[1], b.shape[2]), dtype=torch.float32)
    for aw, bw in zip(a, b):
        (ab, as_), (bb, bs) = split(aw), split(bw)
        acc = acc + as_ @ bb
        acc = acc + ab @ bs
        acc = acc + ab @ bb
    return acc


def kernel_run(a: torch.Tensor, b: torch.Tensor,
               fold: bool = True) -> torch.Tensor:
    """sum_w a[w] @ b[w] as the kernel forms it.  Per k8 step three mmas,
    small*big, big*small, big*big, each adding its eight TF32 products
    to its f32 input with :func:`mma_add`.  ``fold``: the mmas of each
    BK-deep k-slice sum from zero, and the slice's sum is added into the
    f32 accumulator (round to nearest), as the kernel does; otherwise they
    sum into the accumulator over the whole run."""
    acc = torch.zeros((a.shape[1], b.shape[2]), dtype=torch.float32)
    for aw, bw in zip(a, b):
        (ab, as_), (bb, bs) = split(aw), split(bw)
        passes = [(x.double(), y.double())
                  for x, y in ((as_, bb), (ab, bs), (ab, bb))]
        for k0 in range(0, aw.shape[1], BK):
            d = torch.zeros_like(acc) if fold else acc
            for k in range(k0, k0 + BK, KI):
                for x, y in passes:
                    d = mma_add(d, x[:, k:k + KI] @ y[k:k + KI])
            acc = acc + d if fold else d
    return acc


def tf32x1_run(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return sum(tf32(aw) @ tf32(bw) for aw, bw in zip(a, b))


def _run(n_items: int, tk: int, seed: int):
    """One C tile's run of nn-like items: normal A, ReLU-sparse B."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_items, TM, tk)).astype(np.float32)
    b = np.maximum(rng.standard_normal((n_items, tk, TN)), 0).astype(
        np.float32)
    return a, b


def test_tf32_rounding():
    """Round to nearest, ties away from zero, on both signs."""
    one = 1.0
    ulp = 2.0 ** -10                      # TF32 spacing at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 0.0, -0.0, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 0.0, -0.0,
                         3.0], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


def test_mma_add_rounds_toward_zero():
    one, ulp = 1.0, 2.0 ** -23
    d = torch.tensor([one, -one, one, 0.0], dtype=torch.float32)
    p = torch.tensor([0.75 * ulp, -0.75 * ulp, -0.25 * ulp, 3.0],
                     dtype=torch.float64)
    want = torch.tensor([one, -one, one - ulp / 2, 3.0], dtype=torch.float32)
    assert torch.equal(mma_add(d, p), want)


@pytest.mark.parametrize("n_items", RUNS)
@pytest.mark.parametrize("tk", [128, 512])
def test_tf32x3_run_is_f32_accurate(tk, n_items):
    a, b = _run(n_items, tk, seed=tk + n_items)
    ref = np.einsum("wmk,wkn->mn", a.astype(np.float64), b.astype(np.float64))
    scale = np.abs(ref).max()
    at, bt = torch.from_numpy(a), torch.from_numpy(b)

    # the split rebuilds every operand to 2^-21 of its value
    for x in (at, bt):
        big, small = split(x)
        gap = (big.double() + small.double() - x.double()).abs()
        assert bool((gap <= 2.0 ** -21 * x.double().abs()).all())

    x3 = tf32x3_run(at, bt).double().numpy()
    assert np.abs(x3 - ref).max() <= 1e-6 * scale
    # the kernels' gate against the f32 plain engine
    ids = torch.arange(n_items, dtype=torch.int32)
    plain = run_worklist_reference(at, bt, ids, ids,
                                   torch.zeros(n_items, dtype=torch.int32),
                                   1)[0].double().numpy()
    assert np.abs(x3 - plain).max() <= 1e-5 * np.abs(plain).max()
    # one TF32 pass misses 1e-4: the gate tells the two apart
    x1 = tf32x1_run(at, bt).double().numpy()
    assert np.abs(x1 - ref).max() > 1e-4 * scale


def test_kernel_sums_fold_per_slice():
    """The kernel's sums on a 64-item run at tk = 512.  Folded per k-slice
    they stay inside the 1e-5 gate against the f32 plain engine.  Carried
    through the tensor cores over the whole run (12288 mmas rounding toward
    zero into one accumulator) they drift one way and miss it."""
    a, b = _run(64, 512, seed=7)
    ref = np.einsum("wmk,wkn->mn", a.astype(np.float64), b.astype(np.float64))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    ids = torch.arange(64, dtype=torch.int32)
    plain = run_worklist_reference(at, bt, ids, ids,
                                   torch.zeros(64, dtype=torch.int32),
                                   1)[0].double().numpy()
    gate = 1e-5 * np.abs(plain).max()
    folded = kernel_run(at, bt).double().numpy()
    whole = kernel_run(at, bt, fold=False).double().numpy()
    assert np.abs(folded - plain).max() <= gate
    assert np.abs(whole - plain).max() > gate
    assert np.abs(folded - ref).max() * 10 < np.abs(whole - ref).max()
