"""The port's element dp (``spada_tpu_torch.parallel.element_dp``) against
the JAX package's.

Every case of ``tests/test_element_dp.py`` has its counterpart here.  The
JAX side runs in this process on the 8 virtual CPU devices; its problem is
carried to the port with ``convert.from_reference``.  The port runs in a
spawned gloo group of ``n_dev`` ranks (``tests/torch_ranks.py``), one group
per world size, under both backends: ``'pallas'`` (one ``esc_stream_group``
launch per rank, whose plain version runs on the CPU) and ``'xla'``
(``esc_execute``).  Tolerance: 1e-5 of max|C| against the reference (f32
products summed in another order), and the reference's scipy gates.  The
port's form of the reference's jaxpr check counts the calls a rank makes on
torch.distributed: none in the multiply, one gather in the entry point.
"""

import numpy as np
import pytest

import torch_ranks
from spada_tpu.io.workloads import localized_powerlaw_csr, rmat_csr
from spada_tpu.parallel.element_dp import (partition_element,
                                           spgemm_element_dp)
from spada_tpu_torch.convert import from_reference
from spada_tpu_torch.parallel.element_dp import ElementDpResult

BACKENDS = ("pallas", "xla")


def _scipy(a, b):
    return np.asarray((a.to_scipy() @ b.to_scipy()).todense())


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _locpl(m, n, deg, seed):
    return (localized_powerlaw_csr(m, n, deg, seed=seed, dtype=np.float32),
            localized_powerlaw_csr(n, n, deg, seed=seed + 1,
                                   dtype=np.float32))


#: key -> (n_dev, the pair)
PAIRS = {
    "scipy_8": (8, lambda: _locpl(1024, 1024, 8.0, 60)),
    "rmat_4": (4, lambda: (rmat_csr(2048, 8.0, seed=62, dtype=np.float32),
                           rmat_csr(2048, 8.0, seed=63, dtype=np.float32))),
    "no_collectives_8": (8, lambda: _locpl(512, 512, 6.0, 64)),
    "fewer_rows_8": (8, lambda: (
        localized_powerlaw_csr(4, 64, 3.0, seed=66, dtype=np.float32),
        localized_powerlaw_csr(64, 64, 3.0, seed=67, dtype=np.float32))),
    "pallas_xla_4": (4, lambda: _locpl(256, 256, 4.0, 15)),
}

_built: dict = {}


def _case(key):
    """(a, b, the reference's problem, the port's problem), built once."""
    if key not in _built:
        n_dev, pair = PAIRS[key]
        a, b = pair()
        prob = partition_element(a, b, n_dev=n_dev)
        _built[key] = (a, b, prob, from_reference(prob))
    return _built[key]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    done: dict = {}

    def get(key):
        world = PAIRS[key][0]
        if world not in done:
            cases = [(k, "element", {"problem": _case(k)[3],
                                     "backends": BACKENDS})
                     for k, (w, _) in PAIRS.items() if w == world]
            done[world] = torch_ranks.run_group(
                world, cases, tmp_path_factory.mktemp(f"world{world}"))
        res = done[world][key]
        for r, x in enumerate(res):
            if isinstance(x, torch_ranks.RankError):
                pytest.fail(f"rank {r}: {x.text}")
        return res
    return get


def _check(key, ranks, backends=BACKENDS):
    """Each backend's C, the same on every rank, against the reference's
    and scipy's; returns {backend: dense C}."""
    a, b, ref_prob, prob = _case(key)
    res = ranks(key)
    want = spgemm_element_dp(ref_prob).todense()
    oracle = _scipy(a, b)
    out = {}
    for backend in backends:
        vals = res[0][backend]
        for other in res[1:]:
            for x, y in zip(other[backend], vals):
                np.testing.assert_array_equal(x, y)
        assert [v.shape[0] for v in vals] == [prob.n_dev] * len(vals)
        got = ElementDpResult(prob, vals).todense()
        assert _rel(got, want) <= 1e-5, backend
        np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)
        out[backend] = got
    return out


def test_element_dp_matches_reference(ranks):
    _check("scipy_8", ranks)


def test_element_dp_balances_by_expansion(ranks):
    _, _, ref_prob, prob = _case("rmat_4")
    np.testing.assert_array_equal(prob.e_per_shard, ref_prob.e_per_shard)
    e = prob.e_per_shard.astype(np.float64)
    assert e.max() / max(e.mean(), 1.0) < 2.0, e
    _check("rmat_4", ranks)


def test_element_dp_multiply_has_no_collectives(ranks):
    """A rank's body calls nothing on torch.distributed; the entry point
    adds exactly one gather of the result."""
    _check("no_collectives_8", ranks)
    for r, res in enumerate(ranks("no_collectives_8")):
        for backend in BACKENDS:
            calls = res["collectives"]
            assert calls[f"body {backend}"] == {}, (r, calls)
            assert calls[f"entry {backend}"] == {
                "all_gather_into_tensor": 1}, (r, calls)


def test_element_dp_fewer_rows_than_devices(ranks):
    _, _, _, prob = _case("fewer_rows_8")
    assert prob.row_bounds[-1] == 4 and len(prob.row_bounds) == 9
    _check("fewer_rows_8", ranks)


def test_strategy_chooser_routes_scattered_to_element_dp():
    from spada_tpu.io.workloads import powerlaw_csr
    from spada_tpu.parallel.partition import choose_parallel_strategy
    from spada_tpu_torch.parallel import (
        choose_parallel_strategy as port_choose)

    a = powerlaw_csr(8192, 8192, 4.0, seed=70, dtype=np.float32)
    b = powerlaw_csr(8192, 8192, 4.0, seed=71, dtype=np.float32)
    strat, det = port_choose(from_reference(a), from_reference(b), 8)
    assert strat == "element_dp" and det["comm_bytes"] == 0
    assert (strat, det) == choose_parallel_strategy(a, b, 8)


def test_element_dp_pallas_backend_matches_xla(ranks):
    got = _check("pallas_xla_4", ranks)
    np.testing.assert_allclose(got["pallas"], got["xla"], rtol=1e-6,
                               atol=1e-6)
