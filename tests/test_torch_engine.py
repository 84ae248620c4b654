"""The port's tile engine against the JAX reference engines.

On the CPU the ``tile_spgemm`` wrapper and ``run_worklist`` take the plain
PyTorch version; it must equal ``run_worklist_xla(precision='highest')`` and
the Pallas cached kernel in interpret mode (``run_worklist_cached``) on the
same NumPy worklist.  Tolerance 1e-5: all three take f32 products of the
same values, only the summation order differs.  The CUDA kernel itself is
held to the plain version on the card by ``tests/test_torch_kernels.py``.
"""

import os

import numpy as np
import pytest
import torch

from spada_tpu.io.workloads import powerlaw_csr, random_csr
from spada_tpu.ops.engine import run_worklist_cached, run_worklist_xla
from spada_tpu.ops.worklist import build_worklist as jax_build_worklist
from spada_tpu.sparse.bsr import BsrMatrix
from spada_tpu_torch.convert import from_reference as P
from spada_tpu_torch import _build
from spada_tpu_torch.convert import (bsr_to_torch, c_tiles_to_numpy,
                                     tile_ptr_of, worklist_to_torch)
from spada_tpu_torch.ops.engine import (run_worklist, run_worklist_reference,
                                        select_engine, tile_block,
                                        tile_spgemm)
from spada_tpu_torch.ops.worklist import build_worklist


def _case(tm, seed=41):
    a = powerlaw_csr(256, 256, 12.0, seed=seed, dtype=np.float32)
    b = random_csr(256, 256, 0.08, seed=seed + 1, dtype=np.float32)
    ab = P(BsrMatrix.from_csr(a, tm, 64, dtype=np.float32))
    bb = P(BsrMatrix.from_csr(b, 64, 64, dtype=np.float32))
    return ab, bb, build_worklist(ab, bb, order="row")


def _relerr(got, ref):
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


@pytest.mark.parametrize("tm", [8, 16, 32, 64])
def test_plain_tile_engine_matches_xla_and_cached(tm):
    ab, bb, wl = _case(tm)
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    got = c_tiles_to_numpy(run_worklist(wl, a_t, b_t))
    xla = np.asarray(run_worklist_xla(
        ab.tiles, bb.tiles, wl.a_tid, wl.b_tid, wl.o_tid,
        n_c_tiles=wl.n_c_tiles, precision="highest"))
    cached, _, _ = run_worklist_cached(
        ab.tiles, bb.tiles, wl.a_tid, wl.b_tid, wl.o_tid,
        n_c_tiles=wl.n_c_tiles, a_slots=10, b_slots=10, depth=4,
        interpret=True, precision="highest")
    assert got.shape == xla.shape == (wl.n_c_tiles, tm, 64)
    assert _relerr(got, xla) <= 1e-5
    assert _relerr(got, np.asarray(cached)) <= 1e-5
    # the wrapper's CPU path is the same plain version
    dwl = worklist_to_torch(wl, "cpu")
    wrapped = c_tiles_to_numpy(tile_spgemm(a_t, b_t, dwl.a_tid, dwl.b_tid,
                                           dwl.tile_ptr))
    np.testing.assert_array_equal(wrapped, got)


def test_empty_runs_give_zero_tiles():
    """C tiles with no items (interior empty runs) are exact zeros, as the
    reference's cached kernel gives them (engine.py:579-587)."""
    ab, bb, wl = _case(32, seed=7)
    keep = wl.o_tid % 3 != 1          # empty every third C tile's run
    a_ids, b_ids, o_ids = wl.a_tid[keep], wl.b_tid[keep], wl.o_tid[keep]
    n_c = wl.n_c_tiles
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    got = c_tiles_to_numpy(tile_spgemm(
        a_t, b_t, torch.from_numpy(a_ids), torch.from_numpy(b_ids),
        torch.from_numpy(tile_ptr_of(o_ids, n_c))))
    cached, _, _ = run_worklist_cached(
        ab.tiles, bb.tiles, a_ids, b_ids, o_ids, n_c_tiles=n_c,
        a_slots=10, b_slots=10, depth=4, interpret=True, precision="highest")
    xla = np.asarray(run_worklist_xla(ab.tiles, bb.tiles, a_ids, b_ids,
                                      o_ids, n_c_tiles=n_c))
    empty = np.setdiff1d(np.arange(n_c), o_ids)
    assert len(empty) > 0
    assert np.all(got[empty] == 0.0)
    assert _relerr(got, np.asarray(cached)) <= 1e-5
    assert _relerr(got, xla) <= 1e-5


@pytest.mark.parametrize("tm", [8, 16, 32, 64])
def test_bf16_tiles_match_reference_in_f32(tm):
    """bf16 tiles: the port and the reference round the same f32 values to
    bf16 and accumulate in f32; compare in f32."""
    import jax.numpy as jnp

    ab, bb, wl = _case(tm, seed=21)
    a16 = np.asarray(jnp.asarray(ab.tiles).astype(jnp.bfloat16))
    b16 = np.asarray(jnp.asarray(bb.tiles).astype(jnp.bfloat16))
    a_t = bsr_to_torch(ab, "cpu", torch.bfloat16)
    b_t = bsr_to_torch(bb, "cpu", torch.bfloat16)
    # the same rounding on both sides
    np.testing.assert_array_equal(a_t.float().numpy(), a16.astype(np.float32))
    got = c_tiles_to_numpy(run_worklist(wl, a_t, b_t, precision="default"))
    ref = np.asarray(run_worklist_xla(
        a16.astype(np.float32), b16.astype(np.float32), wl.a_tid, wl.b_tid,
        wl.o_tid, n_c_tiles=wl.n_c_tiles, precision="highest"))
    assert _relerr(got, ref) <= 1e-5


def _expected_block(tm, tk, tn, dtype, kernel):
    """The launch rule of csrc/tile_spgemm.cu, tile_stream.cu and
    tile_panel.cu, written out case by case: tensor cores where the k-slice
    (32 f32, 64 bf16) divides tk and 128 divides tn, wide pieces for
    tm % 128 == 0, thin ones for the planner's panel heights (not in
    tile_grid); FP32 SIMT blocks otherwise."""
    k_slice = {torch.float32: 32, torch.bfloat16: 64}[dtype]
    panel = tm in (8, 16, 32) or tm % 64 == 0
    if tn % 128 == 0 and tk % k_slice == 0 and tm % 128 == 0:
        return "mma"
    if (tn % 128 == 0 and tk % k_slice == 0 and panel
            and kernel != "tile_grid"):
        return "mma_thin"
    if tm % 128 == 0 and tn % 128 == 0 and tk % 8 == 0:
        return "wide_simt"
    if panel and tn % 64 == 0 and tk % 16 == 0:
        return "narrow_simt"
    return None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tk", [40, 128])
@pytest.mark.parametrize("tn", [64, 128, 512])
@pytest.mark.parametrize("tm", [8, 16, 32, 64, 128, 192, 512])
def test_tile_block_mirrors_the_launch_rule(tm, tn, tk, dtype):
    """tile_block names the block each tile kernel's launch() picks:
    tile_spgemm, tile_stream and tile_panel run the thin shapes on the thin
    tensor-core block, tile_grid on its SIMT blocks; a shape no block takes
    (tk = 40 below tm, tn = 128) raises."""
    for kernel in ("tile_spgemm", "tile_stream", "tile_panel", "tile_grid"):
        want = _expected_block(tm, tk, tn, dtype, kernel)
        if want is None:
            with pytest.raises(ValueError, match="tm"):
                tile_block(tm, tk, tn, dtype, kernel)
        else:
            assert tile_block(tm, tk, tn, dtype, kernel) == want
    # numpy and string dtypes name the same block
    name = str(dtype).rsplit(".", 1)[-1]
    if _expected_block(tm, tk, tn, dtype, "tile_spgemm") is not None:
        assert tile_block(tm, tk, tn, name) == tile_block(tm, tk, tn, dtype)
    # the thin block takes the planner's panel heights below 128 exactly
    if tn % 128 == 0 and tk == 128 and tm % 128:
        for kernel in ("tile_spgemm", "tile_stream", "tile_panel"):
            assert tile_block(tm, tk, tn, dtype, kernel) == "mma_thin"


def _csrc(name):
    from spada_tpu_torch.ops import engine

    return open(os.path.join(os.path.dirname(engine.__file__), os.pardir,
                             "csrc", name)).read()


def test_block_numbers_match_the_kernels_report():
    """The wrapper reads tile_spgemm's block from the number launch()
    reports: engine._BLOCKS and the kernels' enum (csrc/tile_pipe.cuh,
    under tile_spgemm.cu's includes) list the blocks in the same order."""
    import re

    from spada_tpu_torch.ops import engine

    enum = re.search(r"enum : int \{([^}]*kBlock[^}]*)\}",
                     _csrc("tile_pipe.cuh")).group(1)
    pairs = re.findall(r"kBlock(\w+) = (\d+)", enum)
    names = {"Mma": "mma", "Thin": "mma_thin", "Wide": "wide_simt",
             "Narrow": "narrow_simt"}
    assert sorted((int(v), names[k]) for k, v in pairs) == list(
        enumerate(engine._BLOCKS))


@pytest.mark.parametrize("kernel", ["tile_stream", "tile_panel"])
def test_stream_and_panel_report_their_blocks(kernel):
    """tile_stream and tile_panel report the block each launch ran on, as
    tile_spgemm does: both entry points take an int* out-parameter just
    before the stream (the wrappers check the block it names against
    tile_block on the card)."""
    import ctypes

    from spada_tpu_torch import _build

    for suffix in ("f32", "bf16"):
        assert _build._SIGNATURES[f"{kernel}_{suffix}"][-2:] == [
            ctypes.c_void_p, ctypes.c_void_p]


def test_k_major_worklist_uses_plain_engine():
    a = powerlaw_csr(200, 256, 10.0, seed=5, dtype=np.float32)
    b = random_csr(256, 192, 0.1, seed=6, dtype=np.float32)
    ab = P(BsrMatrix.from_csr(a, 16, 64))
    bb = P(BsrMatrix.from_csr(b, 64, 64))
    wl = build_worklist(ab, bb, order="k")
    assert select_engine("k") == "xla" and select_engine("row") == "cached"
    got = c_tiles_to_numpy(run_worklist(wl, bsr_to_torch(ab, "cpu"),
                                        bsr_to_torch(bb, "cpu")))
    jwl = jax_build_worklist(ab, bb, order="k")
    ref = np.asarray(run_worklist_xla(ab.tiles, bb.tiles, jwl.a_tid,
                                      jwl.b_tid, jwl.o_tid,
                                      n_c_tiles=jwl.n_c_tiles))
    assert _relerr(got, ref) <= 1e-5
    with pytest.raises(ValueError, match="row-major"):
        run_worklist(wl, bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu"),
                     engine="cached")


@pytest.mark.parametrize("engine", ["streaming", "panel", "pallas_grid"])
def test_unported_engines_raise(engine):
    """The streaming, panel and pallas_grid engines run (their plain
    versions on the CPU) and equal the cached engine; a k-major worklist,
    which they cannot take, raises."""
    ab, bb, wl = _case(8)
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    got = c_tiles_to_numpy(run_worklist(wl, a_t, b_t, engine=engine))
    ref = c_tiles_to_numpy(run_worklist(wl, a_t, b_t, engine="cached"))
    assert _relerr(got, ref) <= 1e-5
    wl_k = build_worklist(ab, bb, order="k")
    with pytest.raises(ValueError, match="row-major"):
        run_worklist(wl_k, a_t, b_t, engine=engine)


def test_tile_wrapper_checks_arguments():
    ab, bb, wl = _case(8)
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    dwl = worklist_to_torch(wl, "cpu")
    with pytest.raises(TypeError):
        tile_spgemm(a_t.double(), b_t.double(), dwl.a_tid, dwl.b_tid,
                    dwl.tile_ptr)
    with pytest.raises(TypeError):
        tile_spgemm(a_t, b_t, dwl.a_tid.long(), dwl.b_tid, dwl.tile_ptr)
    with pytest.raises(ValueError, match="tk mismatch"):
        tile_spgemm(a_t, b_t[:, :32], dwl.a_tid, dwl.b_tid, dwl.tile_ptr)
    with pytest.raises(ValueError, match="precision"):
        run_worklist(wl, a_t, b_t, precision="fast")
    with pytest.raises(ValueError, match="exceed"):
        run_worklist(wl, a_t[:1], b_t)
    # no kernel ran on the CPU
    assert _build.launches["tile_spgemm"] == 0


def test_reference_chunking_is_exact_partition():
    """Small chunk budgets split the worklist without changing C."""
    ab, bb, wl = _case(32, seed=3)
    a_t, b_t = bsr_to_torch(ab, "cpu"), bsr_to_torch(bb, "cpu")
    dwl = worklist_to_torch(wl, "cpu")
    whole = run_worklist_reference(a_t, b_t, dwl.a_tid, dwl.b_tid, dwl.o_tid,
                                   dwl.n_c_tiles)
    # 7 items per chunk: the last chunk is partial
    tm, tk, tn = a_t.shape[1], a_t.shape[2], b_t.shape[2]
    tiny = run_worklist_reference(a_t, b_t, dwl.a_tid, dwl.b_tid, dwl.o_tid,
                                  dwl.n_c_tiles,
                                  chunk_bytes=7 * (tm * tk + tk * tn
                                                   + tm * tn) * 4)
    assert dwl.n_items % 7 and dwl.n_items > 7
    torch.testing.assert_close(tiny, whole, rtol=1e-6, atol=1e-6)

