"""The port's distributed strategies against the JAX package's.

Every case of ``tests/test_parallel.py`` and the two sharded cases of
``tests/test_sparse_nn.py`` has its counterpart here.  The JAX side runs in
this process on the 8 virtual CPU devices (``engine='xla'``, or the cached
kernel in interpret mode where the reference's test runs it); the problem it
ran is carried to the port with ``convert.from_reference``.  The port runs
in a spawned gloo group of n_dp·n_tp ranks (``tests/torch_ranks.py``), one
group per world size, which runs all of that world's cases; on the CPU the
kernel wrappers take their plain versions.  Every rank must return the
whole result, the same on all ranks.

Tolerances: f32 tiles 1e-5 of max|C| against the reference, and the
reference's own gates against scipy.  bf16 tiles (the cached engine's
default): 3e-3 of max|C| against the reference's cached engine (whose C
rounds to bf16 on a one-tp mesh; the port's stays f32), and 1e-5 against
the reference's f32 engine on the operands rounded to bf16 (products of bf16
values are exact in f32, so only the order of the sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_ranks
from spada_tpu.io.mtx import load_mtx
from spada_tpu.io.workloads import GemmWorkload, powerlaw_csr, random_csr
from spada_tpu.models import sparse_nn as ref_nn
from spada_tpu.parallel import (choose_parallel_strategy, partition_halo,
                                partition_spgemm, spgemm_halo,
                                spgemm_sharded)
from spada_tpu_torch.convert import from_reference, sparse_mlp_from_reference
from spada_tpu_torch.models.sparse_nn import make_train_step
from spada_tpu_torch.parallel import choose_parallel_strategy as port_choose
from spada_tpu_torch.parallel import spgemm_sharded as port_sharded
from spada_tpu_torch.parallel.halo import halo_view
from spada_tpu_torch.parallel.spgemm import ShardedResult, sharded_rank

CARI = __file__.rsplit("/", 1)[0] + "/../matrices/cari.mtx"
RS = "reduce_scatter"
F32 = (("xla", None, RS), ("cached", "float32", RS))


def _scipy(a, b):
    return np.asarray((a.to_scipy() @ b.to_scipy()).todense(), np.float64)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _bf16(m):
    """A reference CSR with its values rounded to bf16 (to nearest even)."""
    from spada_tpu.sparse.csr import CsrMatrix

    data = torch.from_numpy(np.asarray(m.data, np.float32)).to(
        torch.bfloat16).float().numpy()
    return CsrMatrix(m.shape, m.indptr, m.indices, data)


# ---- the cases: key -> (world size, make) ---------------------------------
# ``make()`` returns (the rank function of tests/torch_ranks.py, its kwargs,
# what the test needs of the reference); it runs once, on first use.

def _pair(name):
    return {
        "rand": lambda: (random_csr(300, 260, 0.05, seed=1),
                         random_csr(260, 310, 0.06, seed=2)),
        "powerlaw": lambda: (powerlaw_csr(500, 400, 10.0, seed=3),
                             random_csr(400, 500, 0.04, seed=4)),
        "single": lambda: (random_csr(256, 256, 0.08, seed=5),
                           random_csr(256, 256, 0.08, seed=6)),
        "to_csr": lambda: (random_csr(200, 180, 0.05, seed=7),
                           random_csr(180, 150, 0.05, seed=8)),
        "cari": lambda: (lambda w: (w.a, w.b))(
            GemmWorkload.from_matrix("cari", load_mtx(CARI))),
        "empty": lambda: (random_csr(40, 64, 0.02, seed=9),
                          random_csr(64, 40, 0.05, seed=10)),
        "halo": lambda: (random_csr(300, 260, 0.05, seed=11),
                         random_csr(260, 310, 0.06, seed=12)),
        "halo_reduce": lambda: (powerlaw_csr(400, 320, 8.0, seed=13),
                                random_csr(320, 400, 0.05, seed=14)),
        "choose": lambda: (random_csr(256, 128, 0.2, seed=20),
                           random_csr(128, 256, 0.2, seed=21)),
        "merge": lambda: (random_csr(96, 80, 0.12, seed=51, dtype=np.float32),
                          random_csr(80, 72, 0.12, seed=52, dtype=np.float32)),
        "cached": lambda: (random_csr(300, 260, 0.05, seed=31),
                           random_csr(260, 310, 0.06, seed=32)),
        "cached_xla": lambda: (random_csr(200, 160, 0.08, seed=33),
                               random_csr(160, 220, 0.08, seed=34)),
        "halo_cached": lambda: (powerlaw_csr(400, 320, 8.0, seed=35),
                                random_csr(320, 400, 0.05, seed=36)),
        "tp1": lambda: (random_csr(120, 100, 0.08, seed=81),
                        random_csr(100, 140, 0.08, seed=82)),
        "big": lambda: (random_csr(200, 160, 0.08, seed=83),
                        random_csr(160, 220, 0.08, seed=84)),
    }[name]()


def _sharded_case(pair, n_dp, n_tp, tm, runs, **kw):
    def build():
        a, b = _pair(pair)
        prob = partition_spgemm(a, b, n_dp, n_tp, tm=tm)
        return ("sharded", {"problem": from_reference(prob), "runs": runs,
                            **kw}, {"a": a, "b": b, "prob": prob})
    return n_dp * n_tp, build


def _halo_case(pair, D, tm, runs):
    def build():
        a, b = _pair(pair)
        prob = partition_halo(a, b, D, tm=tm)
        return ("halo", {"problem": from_reference(prob), "runs": runs},
                {"a": a, "b": b, "prob": prob})
    return D, build


def _csr_case():
    a, b = _pair("to_csr")
    prob = partition_spgemm(a, b, 2, 2, tm=32)
    return ("sharded_csr", {"problem": from_reference(prob)},
            {"a": a, "b": b, "prob": prob})


def _choose_case():
    a, b = _pair("choose")
    strat, det = choose_parallel_strategy(a, b, 4, tm=32)
    key = "halo_problem" if strat == "halo" else "reduce_problem"
    prob = from_reference(det[key])
    if strat == "halo":
        return "halo", {"problem": prob, "runs": [("xla", None)]}, \
            {"a": a, "b": b, "strat": strat, "det": det}
    return "sharded", {"problem": prob, "runs": [F32[0]]}, \
        {"a": a, "b": b, "strat": strat, "det": det}


def _mismatch_case():
    a, b = _pair("tp1")
    prob = from_reference(partition_spgemm(a, b, 2, 2, tm=32))
    return "mesh_mismatch", {"problem": prob}, {}


#: the sharded MLP cases: (dims, density, tm, seed, mesh, lr, batch, x seed)
MLP = {"mlp_4x2": ((64, 64, 32), 0.45, 8, 4, (4, 2), 1e-2, 16, 5),
       "mlp_2x2_padded": ((16, 16), 0.75, 8, 6, (2, 2), 5e-2, 8, 7)}
STEPS = 2


def _mlp_case(key):
    dims, density, tm, seed, shape, lr, batch, xseed = MLP[key]

    def build():
        model = ref_nn.SparseMLP.from_density(dims, density, tm=tm, tk=tm,
                                              seed=seed)
        rng = np.random.default_rng(xseed)
        x = rng.standard_normal((model.in_pad, batch)).astype(np.float32)
        y = rng.standard_normal((model.out_pad, batch)).astype(np.float32)
        port = sparse_mlp_from_reference(model, "cpu")
        return ("mlp", {"specs": port.specs,
                        "params": [np.asarray(p) for p in model.params],
                        "mesh_shape": shape, "lr": lr, "x": x, "y": y,
                        "steps": STEPS},
                {"model": model, "x": x, "y": y})
    return shape[0] * shape[1], build


MESHES = [(2, 1), (4, 1), (1, 2), (2, 2), (4, 2)]

CASES = {
    **{f"sharded_{d}x{t}": _sharded_case(
        "rand", d, t, 64, F32,
        # one case hands spgemm_sharded a mesh it built, the rest mesh=None
        **({"mesh_shape": (d, t)} if (d, t) == (2, 2) else {}))
       for d, t in MESHES},
    "powerlaw_4x2": _sharded_case("powerlaw", 4, 2, 32, F32),
    "single_1x1": _sharded_case("single", 1, 1, 64, F32),
    "single_4x2": _sharded_case("single", 4, 2, 64, F32),
    "to_csr_2x2": (4, _csr_case),
    "cari_4x2": _sharded_case("cari", 4, 2, 128, F32),
    "empty_8x1": _sharded_case("empty", 8, 1, 8, F32),
    "merge_2x4": _sharded_case("merge", 2, 4, 16, [
        (e, dt, m) for e, dt in (("xla", None), ("cached", "float32"))
        for m in (RS, "psum")]),
    "cached_4x2": _sharded_case("cached", 4, 2, 64, [("cached", None, RS)]),
    "cached_xla_2x2": _sharded_case("cached_xla", 2, 2, 32, F32),
    "tp1_2x1": _sharded_case("tp1", 2, 1, 32, [("cached", "float32", RS)]),
    "big_2x1": _sharded_case("big", 2, 1, 32, [("auto", None, RS),
                                               ("cached", None, RS)]),
    "halo_4": _halo_case("halo", 4, 64, [("xla", None),
                                         ("cached", "float32")]),
    "halo_reduce_8": _halo_case("halo_reduce", 8, 32, [("xla", None)]),
    "halo_reduce_4x2": _sharded_case("halo_reduce", 4, 2, 32, F32[:1]),
    "halo_cached_1": _halo_case("halo_cached", 1, 32, [("cached", None)]),
    "halo_cached_8": _halo_case("halo_cached", 8, 32, [("cached", None)]),
    "choose_4": (4, _choose_case),
    "mismatch_2": (2, _mismatch_case),
    **{key: _mlp_case(key) for key in MLP},
}

_built: dict = {}


def _case(key):
    """(rank function, kwargs, reference data) of a case, built once."""
    if key not in _built:
        _built[key] = CASES[key][1]()
    return _built[key]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """key -> [each rank's result], from one group per world size, spawned
    on the first case of that size."""
    done: dict = {}

    def get(key):
        world = CASES[key][0]
        if world not in done:
            cases = [(k, *_case(k)[:2]) for k, (w, _) in CASES.items()
                     if w == world]
            done[world] = torch_ranks.run_group(
                world, cases, tmp_path_factory.mktemp(f"world{world}"))
        res = done[world][key]
        for r, x in enumerate(res):
            if isinstance(x, torch_ranks.RankError):
                pytest.fail(f"rank {r}: {x.text}")
        return res
    return get


def _whole(res):
    """The result every rank returned, checked equal on all ranks."""
    def same(x, y):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            for k in x:
                same(x[k], y[k])
        elif isinstance(x, (list, tuple)):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                same(u, v)
        else:
            np.testing.assert_array_equal(x, y)

    for x in res[1:]:
        same(x, res[0])
    return res[0]


def _dense(problem, c_tiles):
    return ShardedResult(problem, c_tiles).todense()


def _check_f32(key, ranks, ref_c=None):
    """Every f32 run of a sharded or halo case equals the reference's f32
    result to 1e-5 of max|C| and scipy to the reference's gate."""
    _, kw, ref = _case(key)
    got = _whole(ranks(key))
    if ref_c is None:
        run = spgemm_halo if hasattr(ref["prob"], "caps") else spgemm_sharded
        ref_c = run(ref["prob"]).todense()
    oracle = _scipy(ref["a"], ref["b"])
    view = ranks_view(kw["problem"])
    out = {}
    for run, c in got.items():
        d = _dense(view, c)
        assert d.shape == ref_c.shape
        assert _rel(d, ref_c) <= 1e-5, run
        np.testing.assert_allclose(d, oracle, rtol=1e-5, atol=1e-5)
        out[run] = d
    return out


def ranks_view(problem):
    """The ShardedResult surface of a sharded or halo problem."""
    return halo_view(problem) if hasattr(problem, "caps") else problem


# ---- psum-merge: spgemm_sharded ------------------------------------------

@pytest.mark.parametrize("n_dp,n_tp", MESHES)
def test_sharded_matches_reference(ranks, n_dp, n_tp):
    _check_f32(f"sharded_{n_dp}x{n_tp}", ranks)


def test_sharded_8way_powerlaw(ranks):
    _check_f32("powerlaw_4x2", ranks)
    assert _case("powerlaw_4x2")[1]["problem"].imbalance < 3.0


def test_sharded_equals_single_rank(ranks):
    one = _check_f32("single_1x1", ranks)
    eight = _check_f32("single_4x2", ranks)
    for run in one:
        np.testing.assert_allclose(one[run], eight[run], rtol=1e-6,
                                   atol=1e-6)


def test_to_csr_roundtrip(ranks):
    _, kw, ref = _case("to_csr_2x2")
    indptr, indices, data = _whole(ranks("to_csr_2x2"))
    want = spgemm_sharded(ref["prob"]).to_csr()
    from spada_tpu_torch.sparse.csr import CsrMatrix
    got = CsrMatrix(kw["problem"].shape, indptr, indices, data).todense()
    assert _rel(got, want.todense()) <= 1e-5
    np.testing.assert_allclose(got, _scipy(ref["a"], ref["b"]), rtol=1e-5,
                               atol=1e-5)


def test_cari_sharded(ranks):
    _, kw, ref = _case("cari_4x2")
    got = _whole(ranks("cari_4x2"))
    want = spgemm_sharded(ref["prob"]).todense()
    oracle = np.asarray((ref["a"].to_scipy() @ ref["b"].to_scipy()).todense())
    for run, c in got.items():
        d = _dense(kw["problem"], c)
        assert _rel(d, want) <= 1e-5, run
        np.testing.assert_allclose(d, oracle, rtol=1e-4, atol=1e-3)


def test_empty_shards_ok(ranks):
    _check_f32("empty_8x1", ranks)


def test_reduce_scatter_merge_equals_psum(ranks):
    _, kw, ref = _case("merge_2x4")
    got = _whole(ranks("merge_2x4"))
    r_rs = spgemm_sharded(ref["prob"], merge=RS).todense()
    r_ps = spgemm_sharded(ref["prob"], merge="psum").todense()
    oracle = _scipy(ref["a"], ref["b"])
    for run, c in got.items():
        d = _dense(kw["problem"], c)
        assert _rel(d, r_rs) <= 1e-5 and _rel(d, r_ps) <= 1e-5, run
        np.testing.assert_allclose(d, oracle, rtol=1e-4, atol=1e-4)
    for e in ("xla", "cached"):
        dt = None if e == "xla" else "float32"
        np.testing.assert_allclose(got[(e, dt, RS)], got[(e, dt, "psum")],
                                   rtol=1e-6, atol=1e-6)


def test_sharded_cached_bf16_matches_reference(ranks):
    """bf16 tiles (the cached engine's default) against the reference's
    cached kernel (interpret), scipy, and the f32 engine on bf16-rounded
    operands."""
    _, kw, ref = _case("cached_4x2")
    c = _whole(ranks("cached_4x2"))[("cached", None, RS)]
    got = _dense(kw["problem"], c)
    want = spgemm_sharded(ref["prob"], engine="cached").todense()
    assert _rel(got, want) <= 3e-3
    assert _rel(got, _scipy(ref["a"], ref["b"])) < 2e-2
    rounded = partition_spgemm(_bf16(ref["a"]), _bf16(ref["b"]), 4, 2, tm=64)
    assert _rel(got, spgemm_sharded(rounded).todense()) <= 1e-5


def test_sharded_cached_equals_xla_engine(ranks):
    d = _check_f32("cached_xla_2x2", ranks)
    np.testing.assert_allclose(d[F32[0]], d[F32[1]], rtol=1e-5, atol=1e-5)


def test_sharded_cached_f32_request_honored_tp1(ranks):
    _, kw, ref = _case("tp1_2x1")
    c = _whole(ranks("tp1_2x1"))[("cached", "float32", RS)]
    assert c.dtype == np.float32
    got = _dense(kw["problem"], c)
    # the reference's cached kernel on f32 tiles equals its f32 engine to
    # 1e-4 (its test_sharded_cached_equals_xla_engine); the port is held to
    # the f32 engine
    assert _rel(got, spgemm_sharded(ref["prob"]).todense()) <= 1e-5
    np.testing.assert_allclose(got, _scipy(ref["a"], ref["b"]), rtol=1e-4,
                               atol=1e-4)


def test_sharded_cached_has_no_item_cap(ranks):
    """The reference falls back to XLA past its 70k-item SMEM cap (or
    raises under 'cached'); the CUDA kernel has no such cap, so 'auto' and
    'cached' both run the kernel at any Wmax."""
    _, kw, ref = _case("big_2x1")
    got = _whole(ranks("big_2x1"))
    oracle = _scipy(ref["a"], ref["b"])
    assert got[("auto", None, RS)].shape == got[("cached", None, RS)].shape
    np.testing.assert_array_equal(got[("auto", None, RS)],
                                  got[("cached", None, RS)])
    rounded = partition_spgemm(_bf16(ref["a"]), _bf16(ref["b"]), 2, 1, tm=32)
    want = spgemm_sharded(rounded).todense()
    d = _dense(kw["problem"], got[("cached", None, RS)])
    assert _rel(d, want) <= 1e-5
    assert _rel(d, oracle) < 2e-2


def test_rank_body_drops_padding_and_sorts():
    """The port's form of test_cached_plans_cover_padding: a rank's body
    runs its real items only, o-sorted, and its dump tile stays zero; it
    needs no process group."""
    a, b = (random_csr(120, 100, 0.08, seed=37),
            random_csr(100, 140, 0.08, seed=38))
    prob = from_reference(partition_spgemm(a, b, 2, 2, tm=16))
    assert (prob.o_tid == prob.nCmax).any()       # padded shard worklists
    parts = np.stack([np.stack([sharded_rank(prob, d, t, "cpu", "cached",
                                             torch.float32)().numpy()
                                for t in range(2)]) for d in range(2)])
    assert parts.shape == (2, 2, prob.nCmax + 1, 16, 128)
    assert np.all(parts[:, :, prob.nCmax] == 0)
    np.testing.assert_allclose(_dense(prob, parts.sum(1)), _scipy(a, b),
                               rtol=1e-5, atol=1e-5)


# ---- halo exchange -------------------------------------------------------

def test_halo_matches_reference(ranks):
    _check_f32("halo_4", ranks)


def test_halo_equals_reduce_strategy(ranks):
    h = _check_f32("halo_reduce_8", ranks)
    r = _check_f32("halo_reduce_4x2", ranks)
    np.testing.assert_allclose(h[("xla", None)], r[F32[0]], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("D", [1, 8])
def test_halo_cached_matches_reference(ranks, D):
    """bf16 tiles ship over the rounds: against scipy at the reference's
    2e-2, and 1e-5 against the reference's f32 halo on bf16-rounded
    operands (D = 1 is the one-card configuration)."""
    key = f"halo_cached_{D}"
    _, kw, ref = _case(key)
    c = _whole(ranks(key))[("cached", None)]
    got = _dense(ranks_view(kw["problem"]), c)
    assert _rel(got, _scipy(ref["a"], ref["b"])) < 2e-2
    rounded = partition_halo(_bf16(ref["a"]), _bf16(ref["b"]), D, tm=32)
    assert _rel(got, spgemm_halo(rounded).todense()) <= 1e-5


def test_halo_counts_traffic():
    a, b = random_csr(200, 200, 0.05, seed=15), random_csr(200, 200, 0.05,
                                                           seed=16)
    from spada_tpu_torch.parallel import partition_halo as port_halo

    prob = port_halo(from_reference(a), from_reference(b), 4, tm=32)
    assert prob.halo_tiles_sent > 0
    assert prob.halo_tiles_padded == prob.n_dev * sum(prob.caps)
    assert prob.halo_tiles_padded <= prob.n_dev * prob.n_dev * max(prob.caps)
    # the tiles spgemm_halo ships: every round's send list, cap_r tiles each
    shipped = sum(len(s[rank]) for s in prob.send_idx
                  for rank in range(prob.n_dev))
    assert shipped == prob.halo_tiles_padded


def test_choose_parallel_strategy(ranks):
    _, _, ref = _case("choose_4")
    a, b = ref["a"], ref["b"]
    strat, det = port_choose(from_reference(a), from_reference(b), 4, tm=32)
    assert strat == ref["strat"]
    assert det["halo_bytes"] == ref["det"]["halo_bytes"] > 0
    assert det["reduce_bytes"] == ref["det"]["reduce_bytes"] > 0
    got = _whole(ranks("choose_4"))
    prob = det["halo_problem" if strat == "halo" else "reduce_problem"]
    for c in got.values():
        np.testing.assert_allclose(_dense(ranks_view(prob), c),
                                   _scipy(a, b), rtol=1e-5, atol=1e-5)


# ---- what the entry points refuse ----------------------------------------

def test_entry_points_need_a_group_of_the_problem_size(ranks):
    a, b = _pair("tp1")
    prob = from_reference(partition_spgemm(a, b, 2, 2, tm=32))
    # this process has no process group
    with pytest.raises(RuntimeError, match="no.*process group|initialised"):
        port_sharded(prob, device="cpu")
    msg = _whole(ranks("mismatch_2"))
    assert msg is not None and "4 ranks" in msg and "has 2" in msg


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    a, b = _pair("tp1")
    prob = from_reference(partition_spgemm(a, b, 1, 1, tm=32))
    with pytest.raises(RuntimeError, match="cuda"):
        port_sharded(prob, device="cuda")


# ---- the sharded MLP step ------------------------------------------------

@pytest.mark.parametrize("key", list(MLP))
def test_sharded_step_equals_reference(ranks, key):
    """Parameters after two steps on the (dp, tp) mesh equal the reference's
    sharded step and the port's single-device step to 1e-5, padded slots
    (an odd tile count over two tp ranks) staying zero."""
    _, kw, ref = _case(key)
    model, x, y = ref["model"], ref["x"], ref["y"]
    n_dp, n_tp = kw["mesh_shape"]
    lr = kw["lr"]
    devs = np.array(jax.devices()[: n_dp * n_tp]).reshape(n_dp, n_tp)
    sstep, sparams = ref_nn.make_sharded_train_step(
        model, Mesh(devs, ("dp", "tp")), lr=lr)
    sparams = [jnp.asarray(p) for p in sparams]
    ref_losses = []
    for _ in range(STEPS):
        sparams, sl = sstep(sparams, jnp.asarray(x), jnp.asarray(y))
        ref_losses.append(float(np.asarray(sl)[0]))
    # the port's single-device step
    single = sparse_mlp_from_reference(model, "cpu")
    step = make_train_step(single, lr=lr)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    single_losses = [float(step(xt, yt)) for _ in range(STEPS)]
    res = ranks(key)
    assert len(res) == n_dp * n_tp
    for coord, params, losses in res:
        d, t = coord
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(losses, single_losses, rtol=1e-5,
                                   atol=1e-6)
        for layer, p in enumerate(params):
            want = np.asarray(sparams[layer])[t]
            assert p.shape == want.shape
            np.testing.assert_allclose(p, want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"layer {layer} rank {coord}")
            n_tiles = model.params[layer].shape[0]
            ix = np.arange(t, n_tiles, n_tp)
            np.testing.assert_allclose(
                p[: len(ix)], single.params[layer].detach().numpy()[ix],
                rtol=1e-5, atol=1e-6)
            assert np.all(p[len(ix):] == 0.0), "padded slot drifted nonzero"
    if key == "mlp_2x2_padded":
        assert model.params[0].shape[0] == 3
        assert res[0][1][0].shape[0] == 2        # ceil(3 / 2) slots
