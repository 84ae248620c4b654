"""The routed-expert layer (``models.moe.ExpertShard``) on the CPU, held to
the plain layer (``models.moe_reference``): the router's rule on a case
worked by hand, one shard against the reference, the shares of disjoint
shards adding up to the uncut layer, the layer's spans, and the ``macs``
that every tile launch span carries.  Small sizes: hidden 64, expert width
32, 16 experts in 4 groups, top-4, 4 held.  The file imports no JAX.

Tolerance: the port's two products run in f32 on the plain versions of the
tile kernels, which sum each C tile's k-products in another order than the
reference's ``matmul``; in f32 over these k-lengths (at most 4 x 64) that
moves an output by a few units of its last place, about 1e-6 of the
largest output.  ``TOL`` = 2e-5 of the largest output leaves room for
that, while bf16 products (8 bits of mantissa, about 4e-3) miss it a
hundredfold.
"""

import collections
import math

import numpy as np
import pytest
import torch

from spada_tpu_torch.convert import bsr_to_torch, tile_ptr_of
from spada_tpu_torch.models import moe_reference
from spada_tpu_torch.models.moe import (ExpertShard, grouped_csr, route,
                                        stacked_csr)
from spada_tpu_torch.ops import engine
from spada_tpu_torch.ops.worklist import build_worklist
from spada_tpu_torch.sparse.bsr import BsrMatrix
from spada_tpu_torch.utils import trace
from tests.test_torch_trace import LAUNCHES, _prepared

CONFIG = dict(hidden_size=64, moe_intermediate_size=32, n_routed_experts=16,
              num_experts_per_tok=4, n_group=4, topk_group=2,
              norm_topk_prob=True, routed_scaling_factor=2.5,
              n_shared_experts=1)
TOL = 2e-5
#: enough copies that dispatch sends both products to the tile side
TOKENS = 512


@pytest.fixture
def fresh(monkeypatch):
    """An empty store of spans and tracing off."""
    monkeypatch.setattr(trace, "_done",
                        collections.deque(maxlen=trace.LIMIT))
    monkeypatch.setattr(trace, "_enabled", False)


def _x(seed=1, tokens=TOKENS):
    return torch.randn(tokens, CONFIG["hidden_size"],
                       generator=torch.Generator().manual_seed(seed))


def _shard(held, shared, seed):
    return ExpertShard(CONFIG, held=held, shared=shared, device="cpu",
                       seed=seed)


def _close(got, want):
    return float((got - want).abs().max()) <= TOL * float(want.abs().max())


def _logit(p):
    return math.log(p / (1 - p))


@pytest.mark.parametrize("rule", ["port", "reference"])
def test_router_keeps_the_best_groups_and_normalises(rule):
    """8 experts in 4 groups of 2, 2 groups kept, top-2.  Group sums of the
    two scores: 1.0, 1.5, 0.86, 0.4, so groups 1 and 0 are kept; the best
    two experts there are 0 (0.9) and 2 (0.8), though expert 4 (0.85, in
    group 2) scores above expert 2.  Gates: 0.9 and 0.8 over their sum,
    times 2.5.  A bias moves the choice, not the gates."""
    s = [0.9, 0.1, 0.8, 0.7, 0.85, 0.01, 0.2, 0.2]
    logits = torch.tensor([[_logit(p) for p in s]])
    cfg = dict(n_group=4, topk_group=2, num_experts_per_tok=2,
               norm_topk_prob=True, routed_scaling_factor=2.5)

    def choose(bias):
        if rule == "port":
            return route(logits, bias, 4, 2, 2, 2.5)
        return moe_reference.route(logits, bias, cfg)

    experts, gates = choose(torch.zeros(8))
    assert sorted(experts[0].tolist()) == [0, 2]
    got = dict(zip(experts[0].tolist(), gates[0].tolist()))
    assert got[0] == pytest.approx(2.5 * 0.9 / 1.7, rel=1e-6)
    assert got[2] == pytest.approx(2.5 * 0.8 / 1.7, rel=1e-6)
    assert sum(got.values()) == pytest.approx(2.5, rel=1e-6)
    # a bias of 1 on expert 4 puts groups 2 and 1 first: experts 4 and 2,
    # their gates from s alone
    bias = torch.tensor([0, 0, 0, 0, 1.0, 0, 0, 0])
    experts, gates = choose(bias)
    got = dict(zip(experts[0].tolist(), gates[0].tolist()))
    assert sorted(got) == [2, 4]
    assert got[4] == pytest.approx(2.5 * 0.85 / 1.65, rel=1e-6)


@pytest.mark.parametrize("held,shared,tokens", [
    (range(4), True, TOKENS), (range(4, 8), False, TOKENS),
    ((1, 6, 11, 12), True, TOKENS),
    # few copies: dispatch sends the products to the element side
    (range(4), True, 96)])
def test_a_shard_matches_the_reference(held, shared, tokens):
    x = _x(tokens=tokens)
    shard = _shard(held, shared, seed=7)
    got = shard(x)
    want = moe_reference.expert_layer(x, shard.weights(), CONFIG,
                                      held=held, shared=shared)
    assert want.abs().max() > 0
    assert _close(got, want)


def test_given_logits_route_as_the_router_would():
    x = _x(2)
    shard = _shard(range(8, 12), False, seed=3)
    logits = x @ shard.router.t()
    assert torch.equal(shard(x, logits=logits), shard(x))


def test_the_shares_add_up_to_the_uncut_layer():
    """Four cards of 4 experts each, the shared expert on the first alone,
    give together what the reference gives for all 16 experts."""
    x = _x(3)
    parts = sum(_shard(range(4 * i, 4 * i + 4), i == 0, seed=11)(x)
                for i in range(4))
    whole = _shard(range(16), True, seed=11)
    want = moe_reference.expert_layer(x, whole.weights(), CONFIG,
                                      held=range(16), shared=True)
    assert _close(parts, want)


def test_the_grouped_rows_and_the_stacks():
    """Row r of the grouped CSR holds its values in its group's columns; a
    stack of dense blocks lists every entry, zeros too."""
    vals = torch.arange(12, dtype=torch.float32).view(4, 3)
    m = grouped_csr(vals, np.array([0, 0, 2, 3]), 4)
    dense = np.zeros((4, 12), np.float32)
    for r, g in enumerate([0, 0, 2, 3]):
        dense[r, 3 * g:3 * g + 3] = vals[r].numpy()
    assert m.shape == (4, 12) and m.nnz == 12
    assert np.array_equal(m.todense(), dense)
    blocks = [torch.zeros(2, 3), torch.ones(1, 3)]
    s = stacked_csr(blocks)
    assert s.nnz == 9
    assert np.array_equal(s.todense(), torch.cat(blocks).numpy())


def test_the_layer_records_its_spans(fresh):
    x = _x(4)
    shard = _shard(range(4, 8), True, seed=5)
    trace.enable(True)
    shard(x)
    spans = trace.spans()
    by_name = {s.name: s for s in spans}
    routed = by_name["moe.route"]
    experts, _ = route(x @ shard.router.t(), shard.bias, 4, 2, 4, 2.5)
    load = torch.bincount(experts.reshape(-1), minlength=16)[4:8]
    assert routed.attrs["tokens"] == TOKENS
    assert routed.attrs["copies_held"] == int(load.sum())
    assert routed.attrs["load_max"] == int(load.max())
    assert routed.attrs["load_mean"] == pytest.approx(float(load.sum()) / 4)
    # the copies and every token once more for the shared expert
    assert by_name["moe.dispatch"].attrs["copies"] == int(load.sum()) + TOKENS
    assert by_name["moe.experts"].attrs["groups"] == 5
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert by_name[name].parent is None
    ids = {s.id: s for s in spans}

    def under_experts(s):
        while s.parent is not None:
            s = ids[s.parent]
        return s.name == "moe.experts"

    # both products planned and launched inside moe.experts
    plans = [s for s in spans if s.name == "plan"]
    launches = [s for s in spans if s.name == "launch"]
    assert len(plans) == 2 and all(under_experts(s) for s in plans)
    assert [s.attrs["choice"] for s in plans] == ["tile", "tile"]
    assert launches and all(under_experts(s) for s in launches)
    assert all(s.attrs["kernel"] == "tile_spgemm" and s.attrs["macs"] > 0
               for s in launches)


@pytest.mark.parametrize("kind", [k for k in LAUNCHES if k != "element"])
def test_a_tile_launch_counts_its_macs(fresh, kind):
    """Unmasked: tm x tk x tn per item, on every tile kernel's span; the
    element kernel's span carries none."""
    call = _prepared(kind)
    trace.enable(True)
    call()
    (launch,) = trace.spans("launch")
    # the pair of _prepared: tm 32 x tk 32 x tn 128 tiles
    assert launch.attrs["macs"] == launch.attrs["items"] * 32 * 32 * 128
    trace.clear()
    _prepared("element")()
    (launch,) = trace.spans("launch")
    assert "macs" not in launch.attrs


def test_a_masked_launch_counts_the_slices_it_runs(fresh, monkeypatch):
    """With the slice mask, the macs of the slice steps run: each step is
    BM x BK x 128 multiply-adds (tm 32 x tk 128 f32 tiles: 32 x 32 x
    128)."""
    monkeypatch.setattr(engine, "MASK_MIN_SKIP", 0)
    rng = np.random.default_rng(8)
    a = rng.standard_normal((64, 256)).astype(np.float32)
    a[:, 32:96] = 0           # two of each A tile's four k-slices empty
    a[:, 160:192] = 0
    b = rng.standard_normal((256, 128)).astype(np.float32)
    from spada_tpu_torch.sparse.csr import CsrMatrix

    a_bsr = BsrMatrix.from_csr(CsrMatrix.from_dense(a), 32, 128)
    b_bsr = BsrMatrix.from_csr(CsrMatrix.from_dense(b), 128, 128)
    wl = build_worklist(a_bsr, b_bsr, order="row")
    call = engine.prepare_worklist(wl, bsr_to_torch(a_bsr, "cpu"),
                                   bsr_to_torch(b_bsr, "cpu"))
    mask = call.mask
    assert mask.words is not None and mask.slices_run < mask.slices
    trace.enable(True)
    c = call()
    (launch,) = trace.spans("launch")
    items = launch.attrs["items"]
    assert launch.attrs["macs"] == mask.slices_run * 32 * 32 * 128
    assert launch.attrs["macs"] == (items * 32 * 128 * 128
                                    * mask.slices_run // mask.slices)
    assert launch.attrs["macs"] < items * 32 * 128 * 128
    assert c.shape[0] == int(tile_ptr_of(wl.o_tid, wl.n_c_tiles).shape[0]) - 1


def test_the_full_width_check_runs_at_a_small_size(capsys):
    """``tools/check_moe`` (the card's check at DeepSeek-V3's widths) on
    the CPU at hidden 64: f32 tiles within its limit, bf16 tiles not."""
    import json

    from spada_tpu_torch.tools import check_moe

    for dtype, within in (("float32", True), ("bfloat16", False)):
        check_moe.main(["--device", "cpu", "--hidden", "64", "--inter", "32",
                        "--tokens", "1024", "--dtype", dtype, "--shared"])
        got = json.loads(capsys.readouterr().out)
        assert got["within"] is within, got
        assert got["route"]["tokens"] == 1024


def test_the_check_routes_as_the_expert_cell_does():
    """``tools/check_moe``'s layer and routing seed are the benchmark's
    expert configuration's, so the check routes the cell's groups."""
    import json
    import pathlib

    from spada_tpu_torch.tools import check_moe

    path = (pathlib.Path(__file__).resolve().parents[1] / "gpu_bench"
            / "configs" / "deepseek-v3-experts-ep32.json")
    config = json.loads(path.read_text())
    assert check_moe.ROUTING_SEED == config["assumed"]["routing_seed"]
    assert check_moe.EXPERTS_HELD == config["experts_held"]
    assert all(config[k] == v for k, v in check_moe.DEEPSEEK_V3.items())
