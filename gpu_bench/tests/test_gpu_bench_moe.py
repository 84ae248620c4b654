"""The expert cell's parts on the CPU at a tiny size: the grouped generator's
structure and routing, the grouped reference's judgement of sound and
faulty products, and the ``tile_useful_pct`` reader on spans made by hand."""

import collections

import numpy as np
import pytest
import torch

from gpu_bench import harness
from gpu_bench.cells import load_cell, load_part
from gpu_bench.csr import Csr
from gpu_bench.generators import moe_grouped_down as gen
from spada_tpu_torch.utils import trace

CELL = "deepseek-v3-experts-ep32.prefill-4k"
ref = load_part("references", "deepseek_v3_experts_f64")


def _config(**changes):
    config = load_cell(CELL).config
    config.update({"hidden_size": 256, "moe_intermediate_size": 128},
                  **changes)
    return config


def _pairs(seed=3, tokens=512, **changes):
    return gen.generate(_config(**changes), {"tokens": tokens}, seed, 2)


@pytest.mark.parametrize("seed", [3, 2**35 + 1])
def test_the_grouped_rows_lie_in_their_experts_columns(seed):
    config = _config()
    sizes = gen.group_sizes(config, 512)
    (h, w), (h1, w1) = _pairs(seed)
    inter, held = 128, config["experts_held"]
    assert len(sizes) == held and sizes.sum() == h.shape[0]
    assert h.shape[1] == held * inter == w.shape[0]
    assert w.shape[1] == 256 and w.nnz == w.shape[0] * w.shape[1]
    group = np.repeat(np.arange(held), sizes)
    for r in range(h.shape[0]):
        cols = h.indices[h.indptr[r]:h.indptr[r + 1]]
        assert np.array_equal(cols, group[r] * inter + np.arange(inter))
    # one W2stack; H's values differ between the sets, signed
    assert w1 is w and h1.same_structure(h)
    assert not np.array_equal(h1.data, h.data)
    assert (h.data < 0).any() and (h.data > 0).any()


def test_the_routing_seed_fixes_the_groups():
    (h, w), _ = _pairs(3)
    (h2, w2), _ = _pairs(4)
    assert h2.same_structure(h) and w2.same_structure(w)
    assert not np.array_equal(h2.data, h.data)
    assert not np.array_equal(w2.data, w.data)
    other = gen.group_sizes(_config(assumed=dict(
        _config()["assumed"], routing_seed=7)), 512)
    assert not np.array_equal(other, gen.group_sizes(_config(), 512))


def test_the_generators_routing_is_the_ports():
    """The generator's NumPy routing and the port's layer choose the same
    experts for the same logits (DeepSeek-V3's router: 256 experts, 8
    groups, 4 kept, top-8)."""
    from spada_tpu_torch.models.moe import route

    config = _config()
    logits = np.random.default_rng(5).standard_normal((2048, 256),
                                                      dtype=np.float32)
    mine = np.sort(gen.route(logits, 8, 4, 8), axis=1)
    port, _ = route(torch.from_numpy(logits), torch.zeros(256), 8, 4, 8,
                    config["routed_scaling_factor"])
    assert np.array_equal(mine, np.sort(port.numpy(), axis=1))
    # a held expert's copies: about top-8 of 256, a 32nd of the tokens
    held = gen.group_sizes(config, 4096)
    assert 0.5 * 4096 / 32 < held.mean() < 2 * 4096 / 32


def test_the_groups_are_read_from_the_structure():
    a = Csr((5, 8), np.array([0, 2, 4, 4, 6, 8]),
            np.array([0, 1, 0, 1, 4, 5, 4, 5], np.int32),
            np.ones(8, np.float32))
    assert ref.groups(a) == [(0, 2, 0, 2), (2, 3, 0, 0), (3, 5, 4, 6)]


def _dense_c(h, w):
    def dense(m):
        d = np.zeros(m.shape, np.float64)
        rows = np.repeat(np.arange(m.shape[0]), np.diff(m.indptr))
        d[rows, m.indices] = m.data
        return d

    return dense(h) @ dense(w)


def _as_csr(c):
    rows, cols = np.nonzero(np.ones_like(c, bool))
    indptr = np.arange(c.shape[0] + 1, dtype=np.int64) * c.shape[1]
    return indptr, cols.astype(np.int32), c[rows, cols]


def test_a_sound_product_and_each_fault_are_judged():
    (h, w), _ = _pairs(6)
    c = _dense_c(h, w)
    indptr, cols, vals = _as_csr(c)
    dropped = (np.concatenate(([0], indptr[1:] - 1)),
               np.delete(cols, 0), np.delete(vals, 0))
    added = (np.concatenate(([0], indptr[1:] + 1)),
             np.insert(cols, 0, 0), np.insert(vals, 0, 0.0))
    wrong = vals.copy()
    wrong[17] *= 1.01
    control = (torch.from_numpy(c).to(torch.bfloat16).double().numpy())
    got = ref.judge(h, w, [("dense", c), ("csr", (indptr, cols, vals)),
                           ("csr", dropped), ("csr", added),
                           ("csr", (indptr, cols, wrong)),
                           ("dense", control)], "cpu")
    assert got["nnz_c"] == c.size
    sound, as_csr, drop, add, alter, ctrl = got["each"]
    limit = load_cell(CELL).config["limits"]["max_rel_err"]
    for each in (sound, as_csr):
        assert each == {"max_rel_err": pytest.approx(0, abs=1e-12),
                        "stray_entries": 0, "missing_entries": 0}
    assert drop["missing_entries"] == 1
    assert add["stray_entries"] == 1
    assert alter["max_rel_err"] > 1e-3
    assert ctrl["max_rel_err"] > 30 * limit


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(trace, "_done",
                        collections.deque(maxlen=trace.LIMIT))


def _read(products, launches, flop):
    rec = harness.Record("c", "cuda", products=products, launches=launches,
                         flop=flop)
    return load_part("metrics", "tile_useful_pct").read(rec)


def test_the_useful_share_of_the_windows_macs(fresh):
    # before the window: left out by the count of the window's launches
    trace.launch("tile_spgemm", items=1, macs=10**9).end()
    for _ in range(4):
        trace.launch("tile_spgemm", items=2, macs=1000).end()
    # 2 products of 900 useful FLOP (450 multiply-adds) over 4 launches
    assert _read(2, 4, 900) == pytest.approx(100 * 900 / 4000)
    # the element kernel's launch carries no macs
    trace.launch("esc_stream_group", classes=3).end()
    assert _read(2, 4, 900) == pytest.approx(100 * 2 * 450 / 3000)


def test_no_macs_reads_none(fresh, monkeypatch):
    assert _read(2, 2, 900) is None
    trace.launch("tile_spgemm", items=2).end()
    trace.launch("esc_stream_group", classes=3).end()
    assert _read(2, 2, 900) is None
    monkeypatch.delattr(trace, "spans")
    assert _read(2, 2, 900) is None


def test_a_tiny_traced_run_of_each_tile_cell(fresh, monkeypatch):
    """Dense expert tiles: most of the macs are useful (at this size, with
    groups of about 16 rows in tm-8 panels, the rows rounded up and the
    panels that straddle two experts waste a third); the tile cell's 32 x
    32-pruned W2 times 10% H wastes most of them."""
    from gpu_bench.tests.test_gpu_bench_port_spans import _measure

    monkeypatch.setattr(trace, "_enabled", True)
    read = load_part("metrics", "tile_useful_pct").read
    assert 50 < read(_measure(CELL)) <= 100
    trace.clear()
    assert 0 < read(_measure("opt-1.3b-fc2-blk32.prefill-16k")) < 50
