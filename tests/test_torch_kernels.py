"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  These tests need a CUDA device and skip without one (a CUDA kernel has
no CPU mode).  The file imports no JAX, so on a machine without JAX it runs
on its own:

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from spada_tpu_torch import _build
from spada_tpu_torch.convert import item_ptr_of, tile_ptr_of
from spada_tpu_torch.ops import engine
from spada_tpu_torch.ops.element_stream import (esc_stream_group,
                                                esc_stream_mul,
                                                esc_stream_mul_reference,
                                                esc_stream_red,
                                                esc_stream_red_reference,
                                                red_group, red_slices)
from spada_tpu_torch.ops.engine import run_worklist_reference, tile_spgemm
from spada_tpu_torch.tools import probe_pallas_stream, tile_probe


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _relerr(got, ref):
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


# items per C tile (0: an empty run): short runs, and a 64-item run
TILE_RUNS = {"short": [2, 0, 5, 1, 0, 3], "long": [0, 64, 0, 1]}


@pytest.mark.cuda
@pytest.mark.parametrize("runs", TILE_RUNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm,tk,tn", [
    # narrow SIMT blocks (BM = min(tm, 64) x 64), every BM: tn = 64, or
    # tk = 16
    (8, 128, 64), (32, 128, 64), (64, 128, 64), (192, 128, 64),
    (16, 16, 128),
    # thin tensor-core blocks (BM x 128, tm = 8 on 16 rows), tn 128 and 512
    (8, 128, 128), (16, 64, 128), (32, 128, 128), (64, 256, 256),
    (192, 128, 128), (8, 512, 512), (16, 512, 512), (32, 512, 512),
    (64, 512, 512),
    # tensor-core blocks (128 x 128), T = 384 and 512 among them
    (128, 64, 256), (384, 384, 384), (512, 512, 512),
    # a wide tile whose tk the tensor-core block does not take: SIMT block
    (128, 40, 128)])
def test_tile_kernel_matches_plain(cuda_device, tm, tk, tn, dtype, runs):
    """Wide and thin tiles run 3xTF32 (f32) or bf16 mma with f32 sums, the
    others f32 FMAs; the plain version sums exact f32 products in another
    order: 1e-5 of max|C|.  Empty runs are exact zero tiles.  The kernel
    reports the block it ran on (the wrapper raises where tile_block names
    another), and a launch of the thin block also counts as
    tile_spgemm_thin."""
    rng = np.random.default_rng(tm + tk)
    runs = np.array(TILE_RUNS[runs])
    n_c, w = len(runs), int(runs.sum())
    o_ids = np.repeat(np.arange(n_c), runs).astype(np.int32)

    def dev(x, dt=None):
        return torch.from_numpy(x).to(cuda_device, dt)

    a = dev(rng.standard_normal((4, tm, tk), np.float32), dtype)
    b = dev(rng.standard_normal((3, tk, tn), np.float32), dtype)
    ai = dev(rng.integers(0, 4, w).astype(np.int32))
    bi = dev(rng.integers(0, 3, w).astype(np.int32))
    before = _build.launches.copy()
    got = tile_spgemm(a, b, ai, bi, dev(tile_ptr_of(o_ids, n_c)))
    ref = run_worklist_reference(a, b, ai, bi, dev(o_ids), n_c)
    torch.cuda.synchronize()
    thin = engine.tile_block(tm, tk, tn, dtype) == "mma_thin"
    assert _build.launches - before == collections.Counter(
        {"tile_spgemm": 1, **({"tile_spgemm_thin": 1} if thin else {})})
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


@pytest.mark.cuda
@pytest.mark.parametrize("L,n_pad", [(2, 4), (3, 132), (8, 4096), (96, 260),
                                     (512, 1024), (64, 40000)])
def test_stream_red_block_shapes(cuda_device, L, n_pad):
    """Any row split and row group the kernel takes gives the plain sums to
    1e-6 of max|out|, and the same bits when run twice."""
    rng = np.random.default_rng(L + n_pad)
    a = torch.from_numpy(rng.standard_normal((L, n_pad), np.float32))
    b = torch.from_numpy(rng.standard_normal((L, n_pad), np.float32))
    a, b = a.to(cuda_device), b.to(cuda_device)
    ref = esc_stream_red_reference(a, b)
    s0 = red_slices(L, n_pad // 4)
    shapes = {(s0, red_group(L, s0)), (1, 1), (s0, 1)}
    shapes |= {(s, red_group(L, s)) for s in (1, 2, 4, 8, 16, 32)
               if L % s == 0}
    for slices, group in sorted(shapes):
        got = esc_stream_red(a, b, slices=slices, group=group)
        again = esc_stream_red(a, b, slices=slices, group=group)
        torch.cuda.synchronize()
        assert _relerr(got, ref) <= 1e-6, (slices, group)
        assert torch.equal(got, again), (slices, group)
    for slices, group in [(3, 1), (64, 1), (1, 8), (1, -1)]:
        with pytest.raises(RuntimeError, match="invalid"):
            esc_stream_red(a, b, slices=slices, group=group)


def _group_case(rng, device, Ls, sizes):
    pairs = []
    for L, n in zip(Ls, sizes):
        shape = (n // 1024, 1024) if L == 1 and n >= 1024 else (
            (1, n) if L == 1 else (L, n))
        pairs.append(tuple(torch.from_numpy(rng.standard_normal(
            shape, np.float32)).to(device) for _ in "ab"))
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(8))
def test_grouped_launch_matches_per_class_and_plain(cuda_device, seed):
    """Random plans of 1 to 10 classes, L = 1 and L from 2 to 512, class
    sizes from one float4 up: one launch, every class bitwise what its own
    kernel gives (mul also bitwise a * b, red within 1e-6 of max|out| of the
    plain sums), and the same bits when run twice."""
    rng = np.random.default_rng(seed)
    n_classes = [1, 2, 3, 5, 7, 10, 10, 4][seed]
    Ls = sorted(rng.choice([1, 2, 4, 8, 16, 32, 64, 128, 256, 512],
                           n_classes, replace=False).tolist())
    sizes = [int(rng.choice([4, 8, 132, 1024, 4096, 40000, 300000]))
             for _ in Ls]
    pairs = _group_case(rng, cuda_device, Ls, sizes)
    before = dict(_build.launches)
    got = esc_stream_group(pairs, Ls)
    again = esc_stream_group(pairs, Ls)
    torch.cuda.synchronize()
    after = dict(_build.launches)
    assert after.get("esc_stream_group", 0) == before.get(
        "esc_stream_group", 0) + 2
    assert all(after.get(k, 0) == before.get(k, 0)
               for k in ("esc_stream_mul", "esc_stream_red"))
    assert len(got) == len(Ls)
    for L, (x, y), g, g2 in zip(Ls, pairs, got, again):
        assert torch.equal(g, g2)
        if L == 1:
            assert g.shape == x.shape
            assert torch.equal(g, esc_stream_mul_reference(x, y))
            assert torch.equal(g, esc_stream_mul(x, y))
        else:
            assert g.shape == (1, x.shape[1])
            assert torch.equal(g, esc_stream_red(x, y))
            assert _relerr(g, esc_stream_red_reference(x, y)) <= 1e-6


@pytest.mark.cuda
def test_grouped_launch_edges(cuda_device):
    """No classes: no launch.  A class with no elements is left out of the
    grid and comes back empty.  More classes than the kernel's table holds
    raise.  Any class order gives the same bits."""
    rng = np.random.default_rng(3)
    before = _build.launches["esc_stream_group"]
    assert esc_stream_group([], []) == ()
    assert _build.launches["esc_stream_group"] == before
    Ls = [1, 2, 16]
    pairs = _group_case(rng, cuda_device, Ls, [2048, 0, 260])
    got = esc_stream_group(pairs, Ls)
    assert got[1].shape == (1, 0)
    for order in ([0, 2], [2, 0]):
        other = esc_stream_group(pairs, Ls, order=order)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, other))
    assert torch.equal(got[0], pairs[0][0] * pairs[0][1])
    assert _relerr(got[2], esc_stream_red_reference(*pairs[2])) <= 1e-6
    many = _group_case(rng, cuda_device, [2] * 17, [8] * 17)
    with pytest.raises(ValueError, match="at most 16"):
        esc_stream_group(many, [2] * 17)


# the tile shapes of test_tile_kernel_matches_plain, both block shapes;
# tn = 64 keeps every narrow SIMT geometry (Geo8-Geo64) of tile_stream and
# tile_panel held to plain, since their thin shapes run the thin block
ENGINE_SHAPES = [(8, 128, 128), (16, 64, 128), (32, 128, 64), (64, 256, 256),
                 (192, 128, 64), (128, 64, 256), (512, 512, 512),
                 (8, 128, 64), (16, 128, 64)]

# items per C tile.  "groups": empty runs inside a group and at its end, and
# with ogroup 8 a whole group (C tiles 8-15) with none.  "long": a 64-item
# run, empty C tiles inside group 0 and at the end of both groups of 8.
ENGINE_RUNS = {"groups": [2, 0, 5, 1, 0, 3, 0, 0] + [0] * 8 + [1, 2],
               "long": [1, 64, 0, 2, 0, 0, 0, 0, 3, 0]}


def _engine_case(device, tm, tk, tn, dtype, runs="groups"):
    """A random o-sorted worklist with empty runs (``ENGINE_RUNS``)."""
    rng = np.random.default_rng(tm + tk + tn)
    runs = np.array(ENGINE_RUNS[runs])
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
@pytest.mark.parametrize("runs", ENGINE_RUNS)
@pytest.mark.parametrize("ogroup,nbuf", [(1, 2), (8, 8), (3, 5), (2, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm,tk,tn", ENGINE_SHAPES + [(384, 384, 384),
                                                      (128, 40, 128)])
def test_stream_kernel_matches_plain(cuda_device, tm, tk, tn, dtype, ogroup,
                                     nbuf, runs):
    """Same bar as the tile kernel (the tensor-core path rings 2, 3 or 4
    stages deep for nbuf 2, 3 and above); empty runs and groups are zero
    tiles."""
    a, b, ai, bi, o_ids, n_c, empty, dev = _engine_case(cuda_device, tm, tk,
                                                        tn, dtype, runs)
    args = (a, b, ai, bi, dev(o_ids), dev(item_ptr_of(o_ids, n_c, ogroup)),
            n_c, ogroup, nbuf)
    got = _launched_once("tile_stream", engine.tile_stream, *args)
    ref = engine.tile_stream_reference(*args)
    assert _relerr(got, ref) <= 1e-5
    assert bool((got[empty] == 0).all())


# the thin shapes of tile_stream and tile_panel: every piece height (tm = 8
# on 16 rows, 192 = three 64-row pieces), one and four 128-column pieces
THIN_SHAPES = [(tm, tk, tk) for tm in (8, 16, 32, 64, 192)
               for tk in (128, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("runs", ENGINE_RUNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm,tk,tn", THIN_SHAPES)
def test_thin_stream_and_panel_match_plain_and_tile_spgemm(
        cuda_device, tm, tk, tn, dtype, runs):
    """The thin tensor-core block in tile_stream (ogroup 1 and 8) and
    tile_panel (f32 and bf16 output): 1e-5 of max|C| against the plain
    versions, empty runs and groups exact zero tiles, every launch on the
    thin block (the kernels report it).  The same arithmetic on the same
    values as tile_spgemm's thin block: tile_stream at ogroup 1 and
    tile_panel's f32 output are its C bit for bit, the bf16 output that C
    rounded once."""
    a, b, ai, bi, o_ids, n_c, empty, dev = _engine_case(cuda_device, tm, tk,
                                                        tn, dtype, runs)
    tp = dev(tile_ptr_of(o_ids, n_c))
    a_t = a.transpose(1, 2).contiguous()
    before = _build.launches.copy()
    spg = tile_spgemm(a, b, ai, bi, tp)
    streams = {}
    for og in (1, 8):
        args = (a, b, ai, bi, dev(o_ids), dev(item_ptr_of(o_ids, n_c, og)),
                n_c, og)
        streams[og] = engine.tile_stream(*args)
        ref = engine.tile_stream_reference(*args)
        assert _relerr(streams[og], ref) <= 1e-5
        assert bool((streams[og][empty] == 0).all())
    p32 = engine.tile_panel(a_t, b, ai, bi, tp)
    p16 = engine.tile_panel(a_t, b, ai, bi, tp, torch.bfloat16)
    torch.cuda.synchronize()
    assert _build.launches - before == collections.Counter(
        {"tile_spgemm": 1, "tile_spgemm_thin": 1, "tile_stream": 2,
         "tile_stream_thin": 2, "tile_panel": 2, "tile_panel_thin": 2})
    ref = engine.tile_panel_reference(a_t, b, ai, bi, tp)
    assert _relerr(p32, ref) <= 1e-5
    assert bool((p32[empty] == 0).all())
    assert torch.equal(streams[1], spg)
    assert torch.equal(p32, spg)
    assert torch.equal(p16, spg.to(torch.bfloat16))


# ENGINE_SHAPES and three wide tiles: T = 384 (tensor cores), tk = 32 (the
# tensor-core block for f32 tiles, tile_pipe.cuh for bf16) and tk = 40
# (tile_pipe.cuh for both)
PANEL_GRID_SHAPES = ENGINE_SHAPES + [(384, 384, 384), (128, 32, 128),
                                     (128, 40, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("runs", ENGINE_RUNS)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm,tk,tn", PANEL_GRID_SHAPES)
def test_panel_kernel_matches_plain(cuda_device, tm, tk, tn, dtype,
                                    out_dtype, runs):
    """f32 output: 1e-5 of max|C|.  bf16 output: the kernel's own f32 sum
    rounded once, bitwise; against the plain value rounded the same way,
    one bf16 ulp plus the f32 bar (the two f32 sums differ in order, and
    near a cancellation a bf16 ulp is smaller than their gap)."""
    a, b, ai, bi, o_ids, n_c, empty, dev = _engine_case(cuda_device, tm, tk,
                                                        tn, dtype, runs)
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
@pytest.mark.parametrize("runs", ENGINE_RUNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm,tk,tn", PANEL_GRID_SHAPES)
def test_grid_kernel_matches_plain(cuda_device, tm, tk, tn, dtype, runs):
    """Atomic adds in a run-dependent order: 1e-5 of max|C|.  Any item
    order is right; the worklist is shuffled to show it."""
    a, b, ai, bi, o_ids, n_c, empty, dev = _engine_case(cuda_device, tm, tk,
                                                        tn, dtype, runs)
    perm = dev(np.random.default_rng(0).permutation(len(o_ids)))
    args = (a, b, ai[perm], bi[perm], dev(o_ids)[perm], n_c)
    got = _launched_once("tile_grid", engine.tile_grid, *args)
    ref = engine.tile_grid_reference(*args)
    assert _relerr(got, ref) <= 1e-5
    assert bool((got[empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("runs", ENGINE_RUNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm,tk,tn", THIN_SHAPES)
def test_thin_grid_matches_plain(cuda_device, tm, tk, tn, dtype, runs):
    """tile_grid's thin tensor-core block: 1e-5 of max|C| against the plain
    version with the worklist o-sorted (each chunk's runs added once) and
    shuffled (one add per item), empty C tiles exact zeros, each call one
    launch counted as tile_grid and as tile_grid_thin.  Chunks of G = 2 and
    4 items, given to the C entry point, split the 64-item run of "long"
    (and every run of two or more) across blocks."""
    a, b, ai, bi, o_ids, n_c, empty, dev = _engine_case(cuda_device, tm, tk,
                                                        tn, dtype, runs)
    o = dev(o_ids)
    perm = dev(np.random.default_rng(1).permutation(len(o_ids)))
    orders = {"sorted": (ai, bi, o), "shuffled": (ai[perm], bi[perm],
                                                  o[perm])}
    for order, ids in orders.items():
        args = (a, b, *ids, n_c)
        before = _build.launches.copy()
        got = engine.tile_grid(*args)
        torch.cuda.synchronize()
        assert _build.launches - before == collections.Counter(
            {"tile_grid": 1, "tile_grid_thin": 1}), order
        ref = engine.tile_grid_reference(*args)
        assert _relerr(got, ref) <= 1e-5, order
        assert bool((got[empty] == 0).all()), order
        for g in (2, 4):
            got = engine._tile_grid_launch(*args, chunk=g)
            torch.cuda.synchronize()
            assert _relerr(got, ref) <= 1e-5, (order, g)
            assert bool((got[empty] == 0).all()), (order, g)


def _f64_relerr(got, a, b, ai, bi, o_ids, n_c):
    """max|got - C| / max|C| of the f64 product of the worklist."""
    a64, b64 = a.double().cpu(), b.double().cpu()
    ref = torch.zeros((n_c,) + tuple(got.shape[1:]), dtype=torch.float64)
    ref.index_add_(0, torch.from_numpy(o_ids).long(),
                   torch.bmm(a64[ai.long().cpu()], b64[bi.long().cpu()]))
    return _relerr(got.double().cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_panel_kernel_long_run_against_f64(cuda_device, dtype):
    """A 64-item run at tk = 512 (one contraction of depth 32768) on the
    tensor cores: each k-slice's sums folded into f32 keeps C within 1e-5
    of max|C| of the f64 product, as for tile_spgemm.  Its f32 output is
    tile_spgemm's C bit for bit (the same arithmetic on the same values);
    its bf16 output that C rounded once."""
    rng = np.random.default_rng(64)
    runs = np.array([1, 64, 0, 8])
    n_c, w = len(runs), int(runs.sum())
    o_ids = np.repeat(np.arange(n_c), runs).astype(np.int32)
    a = torch.from_numpy(rng.standard_normal((16, 128, 512), np.float32))
    b = torch.from_numpy(rng.standard_normal((16, 512, 256), np.float32))
    a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
    ai = torch.from_numpy(rng.integers(0, 16, w).astype(np.int32))
    bi = torch.from_numpy(rng.integers(0, 16, w).astype(np.int32))
    ai, bi = ai.to(cuda_device), bi.to(cuda_device)
    tp = torch.from_numpy(tile_ptr_of(o_ids, n_c)).to(cuda_device)
    a_t = a.transpose(1, 2).contiguous()
    got = _launched_once("tile_panel", engine.tile_panel, a_t, b, ai, bi, tp)
    assert _f64_relerr(got, a, b, ai, bi, o_ids, n_c) <= 1e-5
    assert torch.equal(got, tile_spgemm(a, b, ai, bi, tp))
    out16 = engine.tile_panel(a_t, b, ai, bi, tp, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(out16, got.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tm", [256, 16, 64])
def test_grid_kernel_atomics_collide(cuda_device, tm, dtype):
    """96 shuffled items into one C tile (and a few into two others): the
    blocks of every item add into the same addresses at once, on the wide
    block (tm 256) and the thin one (tm 16 and 64).  The sum of the folded
    tensor-core products stays within 1e-5 of max|C| of the f64 product
    and of the plain version."""
    rng = np.random.default_rng(96)
    o_ids = np.r_[np.full(96, 1), [0, 0, 2]].astype(np.int32)
    n_c, w = 3, len(o_ids)
    perm = rng.permutation(w)
    o_ids = o_ids[perm]
    a = torch.from_numpy(rng.standard_normal((8, tm, 512), np.float32))
    b = torch.from_numpy(rng.standard_normal((8, 512, 256), np.float32))
    a, b = a.to(cuda_device, dtype), b.to(cuda_device, dtype)
    ai = torch.from_numpy(rng.integers(0, 8, w).astype(np.int32))
    bi = torch.from_numpy(rng.integers(0, 8, w).astype(np.int32))
    ai, bi = ai.to(cuda_device), bi.to(cuda_device)
    args = (a, b, ai, bi, torch.from_numpy(o_ids).to(cuda_device), n_c)
    got = _launched_once("tile_grid", engine.tile_grid, *args)
    assert _f64_relerr(got, a, b, ai, bi, o_ids, n_c) <= 1e-5
    assert _relerr(got, engine.tile_grid_reference(*args)) <= 1e-5


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


@pytest.mark.cuda
def test_wide_kernels_run_on_tensor_cores(cuda_device):
    """Every tensor-core kernel of the four main-path tile kernels (their
    wide and their thin blocks) and of the probe holds HMMA instructions in
    the built library (cuobjdump -sass): none compiled back to FFMA."""
    _build.load()
    counts = _build.sass_counts("HMMA")
    for kernel in ("tile_spgemm_mma", "tile_spgemm_thin", "tile_stream_mma",
                   "tile_stream_thin", "tile_panel_mma", "tile_panel_thin",
                   "tile_grid_mma", "tile_grid_thin", "tile_probe_mma"):
        names = [n for n in counts if kernel in n]
        assert names, f"no {kernel} in the library"
        assert all(counts[n] > 0 for n in names), counts


# ---- the probe kernel and the stream block sizes ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", tile_probe.GPU_MODES)
@pytest.mark.parametrize("tm,tk,tn", [(128, 64, 256), (256, 256, 256)])
def test_probe_kernel_matches_plain(cuda_device, tm, tk, tn, dtype, mode):
    """The FP32 SIMT block.  The modes that write zeros or nothing: their
    plain C bitwise; the rest, full and flat among them, 1e-5 of max|C|."""
    a, b, ai, bi, o_ids, n_c, empty, dev = _engine_case(cuda_device, tm, tk,
                                                        tn, dtype)
    args = (a, b, ai, bi, dev(tile_ptr_of(o_ids, n_c)), mode, 3, 2)
    got = _launched_once("tile_probe", tile_probe.tile_probe, *args, "simt")
    ref = tile_probe.tile_probe_reference(*args)
    if mode in ("nodma", "loop", "empty", "empty0", "nocopy", "dots",
                  "stat"):
        assert torch.equal(got, ref)
    else:
        assert _relerr(got, ref) <= 1e-5
        assert bool((got[empty] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("runs", ENGINE_RUNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", tile_probe.ALL_GPU_MODES)
@pytest.mark.parametrize("tm,tk,tn", [(256, 256, 256), (384, 384, 384),
                                      (128, 64, 256)])
def test_probe_mma_kernel_matches_plain(cuda_device, tm, tk, tn, dtype, mode,
                                        runs):
    """The tensor-core block, T = 256 and 384 among the shapes, short runs
    and a 64-item run.  The modes that write zeros or nothing: their plain
    C bitwise; onepass: the product of the operands rounded to TF32, 1e-5
    of max|C|; nofold (sums rounded toward zero): 5e-4; the rest 1e-5.  The
    default block for these shapes is the tensor-core one."""
    if mode in tile_probe.F32_MODES and dtype != torch.float32:
        with pytest.raises(ValueError, match="f32 tiles"):
            tile_probe.tile_probe(*_engine_case(cuda_device, tm, tk, tn,
                                                dtype)[:4],
                                  torch.zeros(2, dtype=torch.int32,
                                              device=cuda_device), mode)
        return
    a, b, ai, bi, o_ids, n_c, empty, dev = _engine_case(cuda_device, tm, tk,
                                                        tn, dtype, runs)
    args = (a, b, ai, bi, dev(tile_ptr_of(o_ids, n_c)), mode, 3, 2)
    got = _launched_once("tile_probe_mma", tile_probe.tile_probe, *args)
    ref = tile_probe.tile_probe_reference(*args)
    if mode in ("nodma", "loop", "empty", "empty0", "nobar", "nocopy",
                "dots", "stat", "bigonly"):
        assert torch.equal(got, ref)
    else:
        assert _relerr(got, ref) <= tile_probe.mode_tolerance(mode)
        assert bool((got[empty] == 0).all())
    if mode == "akmajor":
        # a k-transposed copy made by the caller gives the same bits
        own = tile_probe.tile_probe(
            *args, a_tiles_t=a.transpose(1, 2).contiguous())
        assert torch.equal(got, own)
    if mode in ("full", "flat", "ring2", "ring3"):
        # the probe's build of the block in mode full is tile_spgemm's
        assert torch.equal(got, tile_spgemm(*args[:5]))


@pytest.mark.cuda
def test_probe_block_argument(cuda_device):
    a, b, ai, bi, o_ids, n_c, empty, dev = _engine_case(
        cuda_device, 128, 40, 128, torch.float32)
    args = (a, b, ai, bi, dev(tile_ptr_of(o_ids, n_c)))
    kw = dict(a_slots=3, b_slots=2)
    # a tk the tensor-core block does not take: the SIMT block, by default
    before = _build.launches["tile_probe"]
    tile_probe.tile_probe(*args, **kw)
    torch.cuda.synchronize()
    assert _build.launches["tile_probe"] == before + 1
    with pytest.raises(ValueError, match="tensor-core block takes"):
        tile_probe.tile_probe(*args, block="mma", **kw)
    with pytest.raises(ValueError, match="mode of the tensor-core block"):
        tile_probe.tile_probe(*args, mode="nofold", **kw)
    with pytest.raises(ValueError, match="unknown block"):
        tile_probe.tile_probe(*args, block="wgmma", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [4, 512, 4096, 1 << 20, 2869 * 1024])
def test_stream_kernels_at_block_sizes(cuda_device, block):
    """The probe's launches at any block size give the main path's values:
    mul bitwise, red the same sums in the same order."""
    rng = np.random.default_rng(block)
    a = torch.from_numpy(rng.standard_normal((96, 1024), np.float32))
    b = torch.from_numpy(rng.standard_normal((96, 1024), np.float32))
    a, b = a.to(cuda_device), b.to(cuda_device)
    got = _launched_once("esc_stream_mul_blocked",
                         probe_pallas_stream.esc_stream_mul_blocked, a, b,
                         block)
    assert torch.equal(got, a * b)
    for L in (2, 32):
        x, y = a[:L].contiguous(), b[:L].contiguous()
        got = _launched_once("esc_stream_red_blocked",
                             probe_pallas_stream.esc_stream_red_blocked, x,
                             y, block)
        assert torch.equal(got, esc_stream_red(x, y))
    with pytest.raises(ValueError, match="block"):
        probe_pallas_stream.esc_stream_mul_blocked(a, b, 6)


@pytest.mark.cuda
def test_measure_device_perf_on_the_card(cuda_device):
    """The device report of a small tile pair and a small element pair:
    device seconds, and every share of a peak at most 100%."""
    from spada_tpu_torch.config import h100_config
    from spada_tpu_torch.io.workloads import (block_sparse_csr,
                                              localized_powerlaw_csr,
                                              relu_activation_csr)
    from spada_tpu_torch.ops.spgemm import measure_device_perf, spgemm
    from spada_tpu_torch.plan.planner import plan_spgemm

    cfg = h100_config(torch.cuda.get_device_name(cuda_device))
    a = block_sparse_csr(1024, 1024, 128, 0.3, seed=1, dtype=np.float32)
    b = relu_activation_csr(1024, 512, 0.35, seed=2, dtype=np.float32)
    res = spgemm(a, b, cfg, dataflow="ip", device=cuda_device)
    plan = plan_spgemm(a, b, cfg)
    # the run's launches; the same rebuilt; a plan's segments
    for kw in ({"dataflow": "ip", "host_state": res.host_state},
               {"dataflow": "ip"}, {"dataflow": "spada", "plan": plan}):
        perf = measure_device_perf(a, b, cfg, device=cuda_device, **kw)
        assert perf["engine_s"] > 0
        assert 0 < perf["mxu_util_pct"] <= 100
        assert 0 < perf["pct_hbm_sol"] <= 100
    a = localized_powerlaw_csr(4096, 4096, 8.0, seed=1, dtype=np.float32)
    b = localized_powerlaw_csr(4096, 4096, 8.0, seed=2, dtype=np.float32)
    for backend in ("auto", "xla"):
        perf = measure_device_perf(
            a, b, dataclasses.replace(cfg, element_backend=backend),
            "element", device=cuda_device)
        assert perf["engine_s"] > 0 and perf["mxu_util_pct"] is None
        assert 0 < perf["pct_hbm_sol"] <= 100


@pytest.mark.cuda
def test_spgemm_csr_slabs_equal_one_shot(cuda_device):
    """Several output slabs, each a launch of tile_spgemm, give the one-shot
    product's CSR bit for bit (each C tile sums the same run)."""
    from spada_tpu_torch.config import SpadaConfig
    from spada_tpu_torch.io.workloads import random_csr
    from spada_tpu_torch.ops.spgemm import spgemm, spgemm_csr

    a = random_csr(300, 256, 0.06, seed=70)
    b = random_csr(256, 300, 0.06, seed=71)
    before = _build.launches["tile_spgemm"]
    many = spgemm_csr(a, b, SpadaConfig(dense_c_budget=3 * 32 * 128 * 4),
                      dataflow="rowwise", tm=32, device=cuda_device)
    assert _build.launches["tile_spgemm"] - before >= 4
    one = spgemm(a, b, SpadaConfig(), dataflow="rowwise", tm=32,
                 device=cuda_device).to_csr()
    np.testing.assert_array_equal(many.indptr, one.indptr)
    np.testing.assert_array_equal(many.indices, one.indices)
    np.testing.assert_array_equal(many.data, one.data)
