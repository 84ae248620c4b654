"""The thin block's k-slice mask (``ops.engine.thin_slice_mask``) on the CPU:
its words against a NumPy count of the nonzero BM x BK sub-blocks of A's
tiles, its counts, the prepared call that builds it and the wrapper that
checks it.  The kernel that reads it is held to the unmasked launch on the
card by ``tests/test_torch_kernels.py``.  The file imports no JAX.
"""

import numpy as np
import pytest
import torch

from spada_tpu_torch.convert import tile_ptr_of
from spada_tpu_torch.ops import engine
from spada_tpu_torch.ops.engine import (prepare_cached, thin_pieces,
                                        thin_slice_mask, tile_spgemm)

#: every piece height of the thin block (tm = 8 on its 8 rows, 192 three
#: 64-row pieces), each k-slice width (f32 32, bf16 64)
THIN_TM = (8, 16, 32, 64, 192)
DTYPES = (torch.float32, torch.bfloat16)


def _sliced_tiles(rng, n, tm, tk, bk, zero_share):
    """[n, tm, tk] f32 tiles in which each 8-row x BK block is all zero with
    probability ``zero_share``, one tile entirely zero."""
    a = rng.standard_normal((n, tm // 8, 8, tk // bk, bk)).astype(np.float32)
    a[rng.random((n, tm // 8, 1, tk // bk, 1)).repeat(8, 2).repeat(bk, 4)
      < zero_share] = 0
    a = a.reshape(n, tm, tk)
    a[n // 2] = 0
    return a


def _numpy_words(a, ids, tm, tk, bk):
    """Each item's word per piece row, and the set bits in all, counted in
    NumPy."""
    bm = min(tm, 64)
    words = np.zeros((len(ids), tm // bm), np.uint32)
    for w, t in enumerate(ids):
        for r in range(tm // bm):
            for s in range(tk // bk):
                if np.any(a[t, r * bm:(r + 1) * bm, s * bk:(s + 1) * bk]):
                    words[w, r] |= np.uint32(1 << s)
    bits = sum(bin(int(x)).count("1") for x in words.ravel())
    return words, bits


@pytest.fixture
def every_skip(monkeypatch):
    """The mask kept whatever share of slices it skips."""
    monkeypatch.setattr(engine, "MASK_MIN_SKIP", 0)


@pytest.mark.parametrize("tk", [128, 256, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tm", THIN_TM)
def test_mask_words_count_nonzero_sub_blocks(every_skip, tm, dtype, tk):
    """Bit s of an item's word for piece row r is set exactly where rows
    [r BM, (r + 1) BM) x columns [s BK, (s + 1) BK) of its A tile hold a
    nonzero; tk = 1024 f32 fills all 32 bits of a word."""
    bk = 64 if dtype == torch.bfloat16 else 32
    rng = np.random.default_rng(tm * 7 + tk)
    a = _sliced_tiles(rng, 6, tm, tk, bk, 0.6)
    ids = rng.integers(0, 6, 40).astype(np.int32)
    tn = 256
    got = thin_slice_mask(torch.from_numpy(a).to(dtype),
                          torch.from_numpy(ids), tn)
    words, bits = _numpy_words(a, ids, tm, tk, bk)
    assert got.words.dtype == torch.int32
    assert np.array_equal(got.words.numpy().view(np.uint32), words)
    assert got.slices == 40 * (tk // bk) * thin_pieces(tm, tn)
    assert got.slices_run == bits * (tn // 128)
    assert got.slices_run < got.slices


def test_mask_builds_in_chunks(every_skip, monkeypatch):
    """Chunks of a few tiles give the words of one pass."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(_sliced_tiles(rng, 9, 32, 128, 32, 0.5))
    ids = torch.from_numpy(rng.integers(0, 9, 30).astype(np.int32))
    whole = thin_slice_mask(a, ids, 128)
    monkeypatch.setattr(engine, "_MASK_CHUNK", 2 * 32 * 128)
    assert torch.equal(thin_slice_mask(a, ids, 128).words,
                       whole.words)


def test_nonfinite_values_count_as_nonzero():
    a = torch.zeros(2, 16, 64)
    a[0, 3, 40] = float("nan")
    a[1, 15, 0] = float("inf")
    got = thin_slice_mask(a, torch.tensor([0, 1], dtype=torch.int32), 128)
    assert got.words.tolist() == [[2], [1]]


@pytest.mark.parametrize("tm,tk,tn,dtype,thin", [
    (128, 128, 128, torch.float32, False),   # the wide tensor-core block
    (32, 128, 64, torch.float32, False),     # narrow SIMT (tn 64)
    (32, 40, 128, torch.float32, False),     # tk not of the slice width
    (32, 2048, 128, torch.float32, False),   # 64 slices: more than a word
    (16, 64, 128, torch.bfloat16, True)])
def test_a_mask_only_on_the_thin_block(tm, tk, tn, dtype, thin):
    a = torch.ones(2, tm, tk, dtype=dtype)
    got = thin_slice_mask(a, torch.zeros(3, dtype=torch.int32), tn)
    assert (got is not None) == thin


@pytest.mark.parametrize("skipped", [0, 1, 3, 4, 5])
def test_the_mask_is_used_where_it_skips_enough(skipped):
    """64 items of one f32 slice each: the words are kept where they skip
    at least MASK_MIN_SKIP (1/16, 4 of 64) of the steps; otherwise every
    slice runs and slices_run is slices."""
    a = torch.ones(64, 16, 32)
    a[:skipped] = 0
    ids = torch.arange(64, dtype=torch.int32)
    got = thin_slice_mask(a, ids, 128)
    assert got.slices == 64
    if skipped * 16 >= 64:
        assert got.words is not None and got.slices_run == 64 - skipped
    else:
        assert got.words is None and got.slices_run == 64


def _pruned_case(seed=3, tm=32, tk=128, tn=128):
    """A 32 x 32-block-pruned A (10% of blocks kept) in tm x tk tiles, the
    nonzero tiles only, and a dense B, as an o-sorted worklist."""
    rng = np.random.default_rng(seed)
    keep = rng.random((8, 16)) < 0.1
    keep[0, 0] = True
    dense = rng.standard_normal((8 * 32, 16 * 32)).astype(np.float32)
    dense *= np.kron(keep, np.ones((32, 32), np.float32))
    tiles = dense.reshape(8 * 32 // tm, tm, 16 * 32 // tk, tk).swapaxes(1, 2)
    nz = [(i, j) for i in range(tiles.shape[0]) for j in range(tiles.shape[1])
          if tiles[i, j].any()]
    a = np.stack([tiles[i, j] for i, j in nz])
    n_b = 3
    b = rng.standard_normal((16 * 32 // tk * n_b, tk, tn)).astype(np.float32)
    a_ids, b_ids, o_ids = [], [], []
    for t, (i, j) in enumerate(nz):
        for c in range(n_b):
            a_ids.append(t)
            b_ids.append(j * n_b + c)
            o_ids.append(i * n_b + c)
    order = np.argsort(o_ids, kind="stable")
    ids = [np.asarray(x, np.int32)[order] for x in (a_ids, b_ids, o_ids)]
    return a, b, ids, tiles.shape[0] * n_b


def test_prepared_call_keeps_the_mask_and_its_counts():
    """The prepared call of a block-pruned A skips the slices that hold
    none of its kept blocks: slices_run counts the kept blocks of each
    item, once per 128-column piece; C is the unmasked C."""
    a, b, (ai, bi, oi), n_c = _pruned_case()
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    call = prepare_cached(at, bt, ai, bi, oi, n_c)
    assert call.mask.slices == len(ai) * 4
    # each item's slices run: the kept 32 x 32 blocks in its A tile
    per_tile = a.reshape(len(a), 32, 4, 32).any(axis=(1, 3)).sum(1)
    assert call.mask.slices_run == int(per_tile[ai].sum())
    assert call.mask.slices_run * 4 < call.mask.slices * 2
    plain = prepare_cached(at, bt, ai, bi, oi, n_c, a_fixed=False)
    assert plain.mask is None
    assert torch.equal(call(), plain())
    # the call takes other B tiles; the mask stays A's
    b2 = bt * 2
    assert torch.equal(call(b2), plain(b2))
    # A dense along k: nothing to skip, every slice runs
    dense = prepare_cached(at + (at == 0), bt, ai, bi, oi, n_c)
    assert dense.mask.words is None
    assert dense.mask.slices_run == dense.mask.slices == call.mask.slices


def test_wrapper_checks_the_mask(every_skip):
    rng = np.random.default_rng(2)
    a = torch.from_numpy(_sliced_tiles(rng, 3, 32, 128, 32, 0.5))
    b = torch.randn(2, 128, 128)
    ai = torch.tensor([0, 1, 2, 1], dtype=torch.int32)
    bi = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    tp = torch.from_numpy(tile_ptr_of(np.array([0, 0, 1, 1], np.int32), 2))
    mask = thin_slice_mask(a, ai, 128)
    assert torch.equal(tile_spgemm(a, b, ai, bi, tp, mask=mask),
                       tile_spgemm(a, b, ai, bi, tp))
    short = mask._replace(words=mask.words[:3])
    with pytest.raises(ValueError, match="slice mask"):
        tile_spgemm(a, b, ai, bi, tp, mask=short)
    wide = torch.randn(3, 128, 128)
    with pytest.raises(ValueError, match="thin block"):
        tile_spgemm(wide, b, ai, bi, tp, mask=mask)
