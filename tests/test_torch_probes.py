"""The probe tools of the port on the CPU: every mode's plain version gives
the C that ``csrc/tile_probe.cu`` is to write, and each probe entry point
runs with ``--device cpu`` at a small size.  The kernels themselves are held
to these plain versions on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py`` phase 7)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spada_tpu_torch.convert import tile_ptr_of
from spada_tpu_torch.ops.element_stream import esc_stream_mul, esc_stream_red
from spada_tpu_torch.ops.engine import run_worklist_reference
from spada_tpu_torch.tools import (probe_kernel, probe_manual,
                                   probe_pallas_stream, probe_panel3d)
from spada_tpu_torch.tools import tile_probe as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--n", "1024", "--band", "100", "--T", "128"]


def _case(seed=0, T=128):
    """A worklist of six C tiles with two empty runs, f32 tiles."""
    rng = np.random.default_rng(seed)
    runs = np.array([3, 0, 1, 4, 0, 2])
    n_c, w = len(runs), int(runs.sum())
    a = rng.standard_normal((5, T, T)).astype(np.float32)
    b = rng.standard_normal((4, T, T)).astype(np.float32)
    ai = rng.integers(0, 5, w).astype(np.int32)
    bi = rng.integers(0, 4, w).astype(np.int32)
    o = np.repeat(np.arange(n_c), runs).astype(np.int32)
    tp = tile_ptr_of(o, n_c)
    t = [torch.from_numpy(x) for x in (a, b, ai, bi, tp)]
    return (a, b, ai, bi, o, tp, runs), t


@pytest.mark.parametrize("mode", TP.GPU_MODES)
def test_probe_mode_plain_versions(mode):
    (a, b, ai, bi, o, tp, runs), t = _case()
    got = TP.tile_probe(*t, mode=mode, a_slots=3, b_slots=2).numpy()
    ref = TP.tile_probe_reference(*t, mode=mode, a_slots=3, b_slots=2)
    assert np.array_equal(got, ref.numpy())
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    want = np.zeros(got.shape)
    if mode in ("full", "flat"):
        full = run_worklist_reference(t[0], t[1], t[2], t[3],
                                      torch.from_numpy(o), len(runs))
        assert np.array_equal(got, full.numpy())
        np.add.at(want, o, a64[ai] @ b64[bi])
    elif mode == "statslot":
        c = np.arange(len(runs))
        want = runs[:, None, None] * (a64[c % 3] @ b64[c % 2])
    elif mode == "oneslot":
        want = runs[:, None, None] * (a64[0] @ b64[0])[None]
    elif mode == "noacc":
        # probe_kernel's noacc: oneslot, each product stored, not added
        want[runs > 0] = a64[0] @ b64[0]
    elif mode in ("nocopy", "dots", "stat"):
        want[:] = TP.SENTINEL
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("mode", TP.MMA_MODES)
def test_tensor_core_block_mode_plain_versions(mode):
    """The modes of the tensor-core block alone: onepass is the product of
    the operands rounded to TF32 (10-bit mantissa, ties away from zero),
    bigonly writes nothing, nobar zeros, and nofold, ring2, ring3 and
    akmajor the C of the run."""
    (a, b, ai, bi, o, tp, runs), t = _case()
    got = TP.tile_probe(*t, mode=mode, a_slots=3, b_slots=2).numpy()
    assert np.array_equal(got, TP.tile_probe_reference(
        *t, mode=mode, a_slots=3, b_slots=2).numpy())
    full = run_worklist_reference(t[0], t[1], t[2], t[3],
                                  torch.from_numpy(o), len(runs)).numpy()
    if mode == "bigonly":
        assert (got == TP.SENTINEL).all()
    elif mode == "nobar":
        assert (got == 0).all()
    elif mode == "onepass":
        def tf32(x):
            bits = x.view(np.uint32).astype(np.uint64)
            return ((bits + 0x1000) & ~np.uint64(0x1FFF)).astype(
                np.uint32).view(np.float32)

        ra, rb = tf32(a), tf32(b)
        assert np.abs(ra - a).max() <= 2.0 ** -11 * np.abs(a).max()
        want = np.zeros(got.shape)
        np.add.at(want, o, ra.astype(np.float64)[ai] @ rb.astype(
            np.float64)[bi])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        # TF32 accuracy against the f32 product, not f32 accuracy
        gap = np.abs(got - full).max() / np.abs(full).max()
        assert 1e-5 < gap < 2e-3
    else:
        assert np.array_equal(got, full)
    assert TP.mode_tolerance(mode) == (5e-4 if mode == "nofold" else 1e-5)


def test_probe_block_argument_on_cpu():
    _, t = _case()
    kw = dict(a_slots=3, b_slots=2)
    assert TP.mma_takes(torch.float32, 128, 32, 256)
    assert not TP.mma_takes(torch.bfloat16, 128, 32, 256)
    assert not TP.mma_takes(torch.float32, 64, 32, 128)
    narrow = (t[0][:, :, :40].contiguous(), t[1][:, :40].contiguous(), *t[2:])
    for block in ("auto", "simt"):
        TP.tile_probe(*narrow, block=block, **kw)
    with pytest.raises(ValueError, match="tensor-core block takes"):
        TP.tile_probe(*narrow, block="mma", **kw)
    with pytest.raises(ValueError, match="mode of the tensor-core block"):
        TP.tile_probe(*narrow, mode="ring2", **kw)
    with pytest.raises(ValueError, match="mode of the tensor-core block"):
        TP.tile_probe(*t, mode="nofold", block="simt", **kw)
    with pytest.raises(ValueError, match="unknown block"):
        TP.tile_probe(*t, block="wgmma", **kw)
    with pytest.raises(ValueError, match="f32 tiles"):
        TP.tile_probe(t[0].bfloat16(), t[1].bfloat16(), *t[2:],
                      mode="onepass", **kw)
    with pytest.raises(ValueError, match="a_tiles_t goes with mode akmajor"):
        TP.tile_probe(*t, a_tiles_t=t[0].transpose(1, 2).contiguous(),
                      **kw)
    a_t = t[0].transpose(1, 2).contiguous()
    assert torch.equal(TP.tile_probe(*t, mode="akmajor", a_tiles_t=a_t,
                                     **kw),
                       TP.tile_probe(*t, mode="full", **kw))


def test_tpu_mode_table():
    assert set(TP.TPU_MODES.values()) == set(TP.GPU_MODES)
    assert set(probe_kernel.ALL_MODES) | set(probe_manual.ALL_MODES) == set(
        TP.TPU_MODES)
    assert set(probe_kernel.DEFAULT_MODES) <= set(probe_kernel.ALL_MODES)
    assert set(probe_manual.DEFAULT_MODES) <= set(probe_manual.ALL_MODES)
    # probe_kernel's suffixes: _par is the base mode, _bf16 and _tiny have
    # no GPU mode and say why
    assert set(TP.TPU_SUFFIXES) == {"par", "bf16", "tiny"}
    for name, mode in TP.TPU_MODES.items():
        assert TP.gpu_mode(name) == TP.gpu_mode(f"{name}_par") == mode
    for suffix in ("bf16", "tiny"):
        with pytest.raises(ValueError, match=f"_{suffix} has no GPU mode"):
            TP.gpu_mode(f"noacc_{suffix}")
    with pytest.raises(ValueError, match="unknown probe mode"):
        TP.gpu_mode("full_wide")
    # the tensor-core block's own modes have no TPU name and are their own
    assert TP.ALL_GPU_MODES == TP.GPU_MODES + TP.MMA_MODES
    assert set(TP.F32_MODES) < set(TP.MMA_MODES)
    assert not set(TP.MMA_MODES) & set(TP.TPU_MODES)
    for mode in TP.MMA_MODES:
        assert TP.gpu_mode(mode) == mode


def test_probe_wrapper_refuses():
    _, t = _case()
    with pytest.raises(ValueError, match="unknown mode"):
        TP.tile_probe(*t, mode="v9")
    with pytest.raises(ValueError, match="multiples of 128"):
        TP.tile_probe(t[0][:, :64], t[1], *t[2:])
    with pytest.raises(ValueError, match="a_slots"):
        TP.tile_probe(*t, a_slots=6)
    with pytest.raises(ValueError, match="unknown probe mode"):
        TP.run_modes(None, ["full", "v9"])


@pytest.mark.parametrize("probe,modes", [(probe_kernel, "ALL_MODES"),
                                         (probe_manual, "ALL_MODES"),
                                         (probe_kernel, "DEFAULT_MODES")])
def test_tile_probes_on_cpu(probe, modes):
    names = getattr(probe, modes)
    res = probe.main(SMALL + names)
    assert set(res) == {TP.TPU_MODES[m] for m in names}
    assert sorted(sum((r["tpu"] for r in res.values()), [])) == sorted(names)
    for mode, rec in res.items():
        assert rec["relerr"] == 0.0 and rec["ms"] is None
        assert rec["exact"] in (None, True)


@pytest.mark.parametrize("extra", [
    ["--block", "simt", "full", "nodma"],
    ["--block", "mma", "full", "nofold", "nobar", "ring2", "akmajor"],
    ["--dtype", "float32", "v2full", "onepass", "bigonly", "ring3"],
])
def test_tile_probe_blocks_and_types_on_cpu(extra):
    res = probe_kernel.main(SMALL + extra)
    names = [x for x in extra if not x.startswith("--")
             and x not in ("simt", "mma", "float32")]
    assert set(res) == {TP.gpu_mode(m) for m in names}
    for mode, rec in res.items():
        assert rec["relerr"] == 0.0 and rec["ms"] is None
        assert rec["tol"] == TP.mode_tolerance(mode)


def test_probe_workload_counts():
    work = TP.probe_work(1024, 100, 128, "cpu")
    assert work.a_tiles.dtype == torch.bfloat16
    flops, nbytes = work.work()
    # the useful products of the banded pair, fewer than the whole tiles'
    a = (work.a_csr.to_scipy() != 0).astype(np.int64)
    b = (work.b_csr.to_scipy() != 0).astype(np.int64)
    assert flops == 2 * int((a @ b).sum()) < 2 * work.n_items * 128 ** 3
    assert nbytes == (2 * (work.a_tiles.numel() + work.b_tiles.numel())
                      + 4 * (2 * work.n_items + work.n_c + 1)
                      + 4 * work.n_c * 128 * 128)
    assert work.n_c == int(work.tile_ptr.shape[0]) - 1 > 0
    assert work.a_csr.shape == (1024, 1024)
    # bf16 tiles are bound at the bf16 peak
    assert work.bound()[0] == max(flops / 989e12, nbytes / 3.35e12)


@pytest.mark.parametrize("dtype,peak", [("float32", 67e12),
                                        (torch.float32, 67e12),
                                        (torch.bfloat16, 989e12),
                                        (np.dtype(np.float16), 989e12)])
def test_roofline_bound_by_operand_type(dtype, peak):
    from spada_tpu_torch.config import roofline_bound

    assert roofline_bound(1e12, 1e6, "NVIDIA H100 80GB HBM3", dtype) == (
        1e12 / peak, "operations")
    assert roofline_bound(1e6, 1e12, None, dtype) == (1e12 / 3.35e12,
                                                      "bytes")


@pytest.mark.parametrize("dtype,peak", [("float32", 495e12 / 3),
                                        (torch.float32, 495e12 / 3),
                                        (torch.bfloat16, 989e12)])
def test_roofline_bound_of_matrix_products(dtype, peak):
    """f32 operands of a matrix product count at the 3xTF32 rate (a third
    of the dense TF32 peak), bf16 operands at the bf16 peak."""
    from spada_tpu_torch.config import roofline_bound

    assert roofline_bound(1e12, 1e6, "NVIDIA H100 80GB HBM3", dtype,
                          matmul=True) == (1e12 / peak, "operations")
    assert roofline_bound(1e6, 1e12, None, dtype, matmul=True) == (
        1e12 / 3.35e12, "bytes")


def test_work_counts():
    from spada_tpu_torch.config import spgemm_flops, stream_work, tile_work
    from spada_tpu_torch.io.workloads import localized_powerlaw_csr

    a = localized_powerlaw_csr(300, 200, 4.0, seed=1, dtype=np.float32)
    b = localized_powerlaw_csr(200, 100, 4.0, seed=2, dtype=np.float32)
    ones = lambda m: (m.to_scipy() != 0).astype(np.int64)  # noqa: E731
    assert spgemm_flops(a, b) == 2 * int((ones(a) @ ones(b)).sum())
    tiles = np.zeros((3, 8, 16), np.float32)
    assert tile_work(tiles, np.zeros((2, 16, 32), np.float32), 5, 4) == (
        2 * 5 * 8 * 16 * 32,
        tiles.nbytes + 2 * 16 * 32 * 4 + 4 * (2 * 5 + 4 + 1) + 4 * 4 * 8 * 32)
    assert tile_work(tiles, tiles, 5, 4, a, b)[0] == spgemm_flops(a, b)
    assert stream_work(1, 100) == (100, 1200)
    assert stream_work(4, 100) == (700, 3600)


def test_panel3d_probe_on_cpu():
    res = probe_panel3d.run(T=128, G=2, device="cpu")
    assert set(res) == set(probe_panel3d.VARIANTS)
    assert all(r["relerr"] == 0.0 for r in res.values())
    # the C of a run is the sum of its two slot products, A k-major
    for variant in probe_panel3d.VARIANTS:
        kernel, _, n_items = probe_panel3d.panel3d_case(128, 2, "cpu",
                                                        variant)
        assert n_items == 2 * 2 * probe_panel3d.OG
        c = kernel().double()
        assert c.shape == (2 * probe_panel3d.OG, 128, 128)


def test_panel3d_case_values():
    kernel, plain, _ = probe_panel3d.panel3d_case(128, 1, "cpu", "panel2")
    rng = np.random.default_rng(0)
    slots = rng.integers(0, probe_panel3d.S - 2, size=probe_panel3d.OG)
    a_t = torch.from_numpy(rng.standard_normal(
        (probe_panel3d.S, 128, 128), np.float32)).bfloat16().double()
    b = torch.from_numpy(rng.standard_normal(
        (probe_panel3d.S, 128, 128), np.float32)).bfloat16().double()
    want = torch.stack([a_t[s].T @ b[s] + a_t[s + 1].T @ b[s + 1]
                        for s in slots])
    got = kernel().double()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert torch.equal(kernel(), plain())


def test_panel3d_library_call():
    """The library yardstick of peritem, one bmm of the gathered runs,
    computes peritem's C (to its output type's rounding)."""
    kernel, _, _ = probe_panel3d.panel3d_case(128, 2, "cpu", "peritem")
    call, label = probe_panel3d.library_case(128, 2, "cpu")
    assert label.startswith("torch.bmm of 12 gathered [128, 256]")
    want, got = kernel(), call().float()
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 2 ** -8 * float(
        want.abs().max())


def test_stream_probe_on_cpu():
    res = probe_pallas_stream.run(rows=16, n2=3000, device="cpu")
    rows = {L: probe_pallas_stream.stage_rows(L) for L in (1, 2)}
    assert len(res) == 2 + len(rows[1]) + len(rows[2])
    assert all(r["relerr"] == 0.0 and r["bound_ms"] > 0 and r["ms"] is None
               for r in res.values())
    assert all(r["exact"] for r in res.values() if r["block"] is not None)
    assert {r["kernel"] for r in res.values()} == {
        "esc_stream_mul", "esc_stream_red", "esc_stream_mul_blocked",
        "esc_stream_red_blocked"}
    for kname, _, main, stage_calls, plain, library, work in (
            probe_pallas_stream.stream_cases(16, 3000, "cpu")):
        ref, lib = plain(), library()
        assert torch.equal(main(), ref)
        assert len(stage_calls) == len(rows[1 if "mul" in kname else 2])
        for label, block, stages, grid_factor, call in stage_calls:
            assert torch.equal(call(), ref), label
        if kname.startswith("esc_stream_mul"):
            assert torch.equal(ref, lib)
        else:
            np.testing.assert_allclose(ref.numpy()[0], lib.numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_stream_sweep_fits_the_card():
    """Every stage row's blocks fit on an SM at its blocks per SM; each
    kernel's sweep spans 4-32 KiB a stage, 2-4 stages, 1-2 blocks per SM;
    and no TPU block fits in a block's shared memory."""
    P = probe_pallas_stream
    for L in (1, 2):
        rows = P.stage_rows(L)
        assert {r[2] for r in rows} == set(P.STAGES)
        assert {r[3] for r in rows} == set(P.GRID_FACTORS)
        assert {4 * L * r[1] // 1024 for r in rows} == set(P.STAGE_KIB)
        for _, block, stages, grid_factor in rows:
            smem = P.stage_smem(L, block, stages)
            assert smem <= P.SMEM_PER_BLOCK
            assert P.fits_per_sm(smem, grid_factor)
        assert len(rows) == 19
    for rows in (1024, 2048, 2869):
        assert P.stage_smem(1, rows * 1024, 1) > P.SMEM_PER_BLOCK
    assert P.stage_smem(2, P.CHL, 1) > P.SMEM_PER_BLOCK


def test_stream_block_argument():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((8, 1024), np.float32))
    b = torch.from_numpy(rng.standard_normal((8, 1024), np.float32))
    mul_blocked = probe_pallas_stream.esc_stream_mul_blocked
    red_blocked = probe_pallas_stream.esc_stream_red_blocked
    assert torch.equal(mul_blocked(a, b, 2048), esc_stream_mul(a, b))
    assert torch.equal(red_blocked(a, b, 512), esc_stream_red(a, b))
    assert torch.equal(red_blocked(a, b, 4, 1, 4), esc_stream_red(a, b))
    assert torch.equal(esc_stream_red(a, b), (a * b).sum(0, keepdim=True))
    for bad in (0, -4, 6):
        with pytest.raises(ValueError, match="block"):
            mul_blocked(a, b, bad)
        with pytest.raises(ValueError, match="block"):
            red_blocked(a, b, bad)


def _misaligned(rows, cols):
    """A contiguous [rows, cols] f32 view 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(rows * cols + 4)
    base = (-flat.data_ptr() // 4) % 4
    return flat[base + 1:base + 1 + rows * cols].view(rows, cols)


# (kernel, operand shape, block, stages, grid_factor, what the error names)
STREAM_REFUSED = [
    # a stage too large for a block's shared memory: the TPU's blocks, and
    # the smallest ring over 227 KB
    ("mul", (8, 1024), 1024 * 1024, 1, 1, "shared memory"),
    ("mul", (8, 1024), 7264, 4, 1, "shared memory"),
    ("red", (2, 1024), 1 << 20, 1, 1, "shared memory"),
    ("red", (32, 1024), 444, 2, 1, "shared memory"),
    # ring depth and blocks per SM out of range
    ("mul", (8, 1024), 1024, 9, 1, "stages"),
    ("red", (2, 1024), 1024, 0, 1, "stages"),
    ("mul", (8, 1024), 1024, 2, 5, "grid_factor"),
    # rows that are not a multiple of 4 floats, and misaligned operands
    ("mul", (8, 1022), 1024, 2, 1, "multiple of 4"),
    ("red", (2, 1022), 1024, 2, 1, "multiple of 4"),
    ("mul", "misaligned", 1024, 2, 1, "16-byte aligned"),
    ("red", "misaligned", 1024, 2, 1, "16-byte aligned"),
]


@pytest.mark.parametrize("kernel,shape,block,stages,grid_factor,match",
                         STREAM_REFUSED)
def test_stream_pipeline_refuses(kernel, shape, block, stages, grid_factor,
                                 match):
    """What the card's launch cannot take raises ValueError on the CPU
    too, where the wrapper runs the plain version."""
    if shape == "misaligned":
        a = b = _misaligned(2, 1024)
        assert a.is_contiguous() and a.data_ptr() % 16 == 4
    else:
        a = b = torch.ones(shape)
    fn = (probe_pallas_stream.esc_stream_mul_blocked if kernel == "mul"
          else probe_pallas_stream.esc_stream_red_blocked)
    with pytest.raises(ValueError, match=match):
        fn(a, b, block, stages, grid_factor)


@pytest.mark.parametrize("argv", [
    ["probe_kernel", *SMALL, "full", "noacc"],
    ["probe_manual", *SMALL, "v2full", "flat"],
    ["probe_panel3d", "--device", "cpu", "--T", "128", "--G", "1"],
    ["probe_pallas_stream", "--device", "cpu", "--rows", "8", "--n2", "100"],
])
def test_probe_entry_points(argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-m", f"spada_tpu_torch.tools.{argv[0]}", *argv[1:]],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "not timed" in out.stdout and "max|d|/max|ref| 0.0e+00" in \
        out.stdout
