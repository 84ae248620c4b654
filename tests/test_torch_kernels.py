"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  These tests need a CUDA device and skip without one (a CUDA kernel has
no CPU mode).  The file imports no JAX, so on a machine without JAX it runs
on its own:

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from spada_tpu_torch import _build
from spada_tpu_torch.convert import item_ptr_of, tile_ptr_of
from spada_tpu_torch.ops import engine
from spada_tpu_torch.ops.element_stream import (esc_stream_mul,
                                                esc_stream_mul_reference,
                                                esc_stream_red,
                                                esc_stream_red_reference)
from spada_tpu_torch.ops.engine import run_worklist_reference, tile_spgemm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _relerr(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm,tk,tn", [
    # narrow blocks (BM = min(tm, 64) x 64)
    (8, 128, 128), (16, 64, 128), (32, 128, 64), (64, 256, 256),
    (192, 128, 64),
    # wide blocks (128 x 128)
    (128, 64, 256), (384, 384, 384), (512, 512, 512)])
def test_tile_kernel_matches_plain(cuda_device, tm, tk, tn, dtype):
    """f32 products of the same values on both sides: only the summation
    order differs (1e-5 of max|C|); empty runs are exact zero tiles."""
    rng = np.random.default_rng(tm + tk)
    runs = np.array([2, 0, 5, 1, 0, 3])
    n_c, w = len(runs), int(runs.sum())
    o_ids = np.repeat(np.arange(n_c), runs).astype(np.int32)

    def dev(x, dt=None):
        return torch.from_numpy(x).to(cuda_device, dt)

    a = dev(rng.standard_normal((4, tm, tk), np.float32), dtype)
    b = dev(rng.standard_normal((3, tk, tn), np.float32), dtype)
    ai = dev(rng.integers(0, 4, w).astype(np.int32))
    bi = dev(rng.integers(0, 3, w).astype(np.int32))
    before = _build.launches["tile_spgemm"]
    got = tile_spgemm(a, b, ai, bi, dev(tile_ptr_of(o_ids, n_c)))
    ref = run_worklist_reference(a, b, ai, bi, dev(o_ids), n_c)
    torch.cuda.synchronize()
    assert _build.launches["tile_spgemm"] == before + 1
    assert _relerr(got, ref) <= 1e-5
    assert bool((got[dev(runs == 0)] == 0).all())


@pytest.mark.cuda
def test_tile_kernel_rejects_what_it_cannot_take(cuda_device):
    a = torch.zeros((1, 24, 64), device=cuda_device)
    b = torch.zeros((1, 64, 64), device=cuda_device)
    ids = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    ptr = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="tm"):
        tile_spgemm(a, b, ids, ids, ptr)
    shifted = torch.zeros(8 * 64 + 1, device=cuda_device)[1:].view(1, 8, 64)
    with pytest.raises(ValueError, match="aligned"):
        tile_spgemm(shifted, b, ids, ids, ptr)
    # no items: zeros without a launch
    before = _build.launches["tile_spgemm"]
    out = tile_spgemm(a[:, :8], b, ids[:0], ids[:0],
                      torch.zeros(2, dtype=torch.int32, device=cuda_device))
    assert _build.launches["tile_spgemm"] == before
    assert out.shape == (1, 8, 64) and bool((out == 0).all())


@pytest.mark.cuda
def test_stream_mul_kernel_bitwise(cuda_device):
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 1024), np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 1024), np.float32))
    a, b = a.to(cuda_device), b.to(cuda_device)
    before = _build.launches["esc_stream_mul"]
    got = esc_stream_mul(a, b)
    torch.cuda.synchronize()
    assert _build.launches["esc_stream_mul"] == before + 1
    assert torch.equal(got, esc_stream_mul_reference(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [2, 4, 32, 512])
def test_stream_red_kernel(cuda_device, L):
    """Products rounded to f32 on both sides, summed in another order:
    1e-6 of max|out|."""
    rng = np.random.default_rng(L)
    a = torch.from_numpy(rng.standard_normal((L, 4096), np.float32))
    b = torch.from_numpy(rng.standard_normal((L, 4096), np.float32))
    a, b = a.to(cuda_device), b.to(cuda_device)
    got = esc_stream_red(a, b)
    ref = esc_stream_red_reference(a, b)
    torch.cuda.synchronize()
    assert got.shape == (1, 4096)
    assert _relerr(got, ref) <= 1e-6


# the tile shapes of test_tile_kernel_matches_plain, both block shapes
ENGINE_SHAPES = [(8, 128, 128), (16, 64, 128), (32, 128, 64), (64, 256, 256),
                 (192, 128, 64), (128, 64, 256), (512, 512, 512)]


def _engine_case(device, tm, tk, tn, dtype):
    """A random o-sorted worklist with empty runs; C tiles 8-15 have no
    items, so an ogroup of 8 gives a whole group with none."""
    rng = np.random.default_rng(tm + tk + tn)
    runs = np.array([2, 0, 5, 1, 0, 3, 0, 0] + [0] * 8 + [1, 2])
    n_c, w = len(runs), int(runs.sum())
    o_ids = np.repeat(np.arange(n_c), runs).astype(np.int32)

    def dev(x, dt=None):
        return torch.from_numpy(x).to(device, dt)

    a = dev(rng.standard_normal((4, tm, tk), np.float32), dtype)
    b = dev(rng.standard_normal((3, tk, tn), np.float32), dtype)
    ai = dev(rng.integers(0, 4, w).astype(np.int32))
    bi = dev(rng.integers(0, 3, w).astype(np.int32))
    return a, b, ai, bi, o_ids, n_c, dev(runs == 0), dev


def _launched_once(name, fn, *args):
    before = _build.launches[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ogroup,nbuf", [(1, 2), (8, 8), (3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm,tk,tn", ENGINE_SHAPES)
def test_stream_kernel_matches_plain(cuda_device, tm, tk, tn, dtype, ogroup,
                                     nbuf):
    """Same bar as the tile kernel; empty runs and groups are zero tiles."""
    a, b, ai, bi, o_ids, n_c, empty, dev = _engine_case(cuda_device, tm, tk,
                                                        tn, dtype)
    args = (a, b, ai, bi, dev(o_ids), dev(item_ptr_of(o_ids, n_c, ogroup)),
            n_c, ogroup, nbuf)
    got = _launched_once("tile_stream", engine.tile_stream, *args)
    ref = engine.tile_stream_reference(*args)
    assert _relerr(got, ref) <= 1e-5
    assert bool((got[empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm,tk,tn", ENGINE_SHAPES)
def test_panel_kernel_matches_plain(cuda_device, tm, tk, tn, dtype,
                                    out_dtype):
    """f32 output: 1e-5 of max|C|.  bf16 output: the kernel's own f32 sum
    rounded once, bitwise; against the plain value rounded the same way,
    one bf16 ulp plus the f32 bar (the two f32 sums differ in order, and
    near a cancellation a bf16 ulp is smaller than their gap)."""
    a, b, ai, bi, o_ids, n_c, empty, dev = _engine_case(cuda_device, tm, tk,
                                                        tn, dtype)
    args = (a.transpose(1, 2).contiguous(), b, ai, bi,
            dev(tile_ptr_of(o_ids, n_c)), out_dtype)
    got = _launched_once("tile_panel", engine.tile_panel, *args)
    ref = engine.tile_panel_reference(*args)
    assert got.dtype == out_dtype
    assert bool((got[empty] == 0).all())
    if out_dtype == torch.bfloat16:
        own = engine.tile_panel(*args[:-1], torch.float32)
        assert torch.equal(got, own.to(torch.bfloat16))
    got, ref = got.float(), ref.float()
    if out_dtype == torch.float32:
        assert _relerr(got, ref) <= 1e-5
    else:
        ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-38)))
                         - 7)
        assert bool(((got - ref).abs() <= ulp + 1e-5 * ref.abs().max())
                    .all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm,tk,tn", ENGINE_SHAPES)
def test_grid_kernel_matches_plain(cuda_device, tm, tk, tn, dtype):
    """Atomic adds in a run-dependent order: 1e-5 of max|C|.  Any item
    order is right; the worklist is shuffled to show it."""
    a, b, ai, bi, o_ids, n_c, empty, dev = _engine_case(cuda_device, tm, tk,
                                                        tn, dtype)
    perm = dev(np.random.default_rng(0).permutation(len(o_ids)))
    args = (a, b, ai[perm], bi[perm], dev(o_ids)[perm], n_c)
    got = _launched_once("tile_grid", engine.tile_grid, *args)
    ref = engine.tile_grid_reference(*args)
    assert _relerr(got, ref) <= 1e-5
    assert bool((got[empty] == 0).all())


@pytest.mark.cuda
def test_engine_kernels_reject_what_they_cannot_take(cuda_device):
    a = torch.zeros((1, 24, 64), device=cuda_device)
    b = torch.zeros((1, 64, 64), device=cuda_device)
    ids = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    ptr = torch.tensor([0, 1], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="tm"):
        engine.tile_stream(a, b, ids, ids, ids, ptr, 1, 1)
    with pytest.raises(ValueError, match="tm"):
        engine.tile_panel(a.transpose(1, 2).contiguous(), b, ids, ids, ptr)
    with pytest.raises(ValueError, match="tm"):
        engine.tile_grid(a, b, ids, ids, ids, 1)
    # no items: zero tiles without a launch
    before = dict(_build.launches)
    none = ids[:0]
    outs = [engine.tile_stream(a[:, :8], b, none, none, none,
                               torch.zeros(2, dtype=torch.int32,
                                           device=cuda_device), 1, 1),
            engine.tile_panel(a[:, :8].transpose(1, 2).contiguous(), b, none,
                              none, torch.zeros(2, dtype=torch.int32,
                                                device=cuda_device)),
            engine.tile_grid(a[:, :8], b, none, none, none, 1)]
    assert dict(_build.launches) == before
    for out in outs:
        assert out.shape == (1, 8, 64) and bool((out == 0).all())
