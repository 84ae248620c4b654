"""The port's element (ESC) path against the JAX reference.

The ESC plan and the stream layout are mirrors of the JAX package's and
must equal them array by array.  The executor (on the CPU the wrappers take
their plain versions) must match the Pallas stream kernels in interpret
mode and scipy, to 1e-4 (f32 products summed in another order).  The CUDA
kernels are held to the plain versions on the card by
``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from spada_tpu.io.workloads import (localized_powerlaw_csr, powerlaw_csr,
                                    random_csr)
from spada_tpu.ops import element as jax_element
from spada_tpu.ops import element_stream as jax_stream
from spada_tpu_torch.convert import from_reference as P
from spada_tpu_torch import _build
from spada_tpu_torch.convert import stream_operands_to_torch
from spada_tpu_torch.ops.element import (_ceil_pow2, build_esc_plan,
                                         expansion_products, spgemm_element)
from spada_tpu_torch.ops.element_stream import (StreamResult,
                                                build_stream_layout,
                                                esc_stream_mul,
                                                esc_stream_red,
                                                stream_execute,
                                                stream_execute_reference,
                                                stream_operands,
                                                stream_to_csr,
                                                stream_values_host)

# the four cases of tests/test_element_stream.py
CASES = [
    ("uniform", random_csr(60, 80, 0.08, seed=1, dtype=np.float32),
     random_csr(80, 50, 0.08, seed=2, dtype=np.float32)),
    ("powerlaw", powerlaw_csr(300, 300, 5.0, seed=3, dtype=np.float32),
     powerlaw_csr(300, 300, 5.0, seed=4, dtype=np.float32)),
    ("loc-powerlaw",
     localized_powerlaw_csr(512, 512, 12.0, seed=5, dtype=np.float32),
     localized_powerlaw_csr(512, 512, 12.0, seed=6, dtype=np.float32)),
    ("dense-ish", random_csr(48, 48, 0.6, seed=7, dtype=np.float32),
     random_csr(48, 48, 0.6, seed=8, dtype=np.float32)),
]
IDS = [c[0] for c in CASES]


def _oracle(a, b):
    return np.asarray((a.to_scipy() @ b.to_scipy()).todense())


def _assert_plans_equal(got, ref):
    assert got.shape == ref.shape
    assert got.n_products == ref.n_products
    assert got.n_padded == ref.n_padded
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_array_equal(got.esc_to_csr, ref.esc_to_csr)
    assert [bk.L for bk in got.buckets] == [bk.L for bk in ref.buckets]
    for g, r in zip(got.buckets, ref.buckets):
        np.testing.assert_array_equal(g.a_gidx, r.a_gidx)
        np.testing.assert_array_equal(g.b_gidx, r.b_gidx)


@pytest.mark.parametrize("backend", ["auto", "python"])
@pytest.mark.parametrize("cap", [8, 512])
@pytest.mark.parametrize("name,a,b", CASES, ids=IDS)
def test_esc_plan_matches_reference(name, a, b, cap, backend):
    got = build_esc_plan(P(a), P(b), cap=cap, backend=backend)
    ref = jax_element.build_esc_plan(a, b, cap=cap, backend=backend)
    _assert_plans_equal(got, ref)
    assert (expansion_products(P(a), P(b))
            == jax_element.expansion_products(a, b))


@pytest.mark.parametrize("name,a,b", CASES, ids=IDS)
def test_stream_layout_and_operands_match_reference(name, a, b):
    plan = build_esc_plan(P(a), P(b))
    ref_plan = jax_element.build_esc_plan(a, b)
    layout = build_stream_layout(plan)
    ref = jax_stream.build_stream_layout(ref_plan)
    assert layout.classes == ref.classes
    np.testing.assert_array_equal(layout.esc_to_csr, ref.esc_to_csr)
    assert (layout.n_padded, layout.nnz_c, layout.operand_bytes()) == (
        ref.n_padded, ref.nnz_c, ref.operand_bytes())
    for (ga, gb), (ra, rb) in zip(stream_operands(layout, plan, P(a), P(b)),
                                  jax_stream.stream_operands(ref, ref_plan,
                                                             a, b)):
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)


@pytest.mark.parametrize("name,a,b", CASES, ids=IDS)
def test_stream_executor_matches_pallas_and_scipy(name, a, b):
    import jax.numpy as jnp

    plan = build_esc_plan(P(a), P(b))
    layout = build_stream_layout(plan)
    ops = stream_operands(layout, plan, P(a), P(b))
    vals = stream_execute(layout, stream_operands_to_torch(ops, "cpu"))
    run = jax_stream.stream_execute_fn(
        jax_stream.build_stream_layout(jax_element.build_esc_plan(a, b)),
        interpret=True)
    ref_vals = run(tuple((jnp.asarray(av), jnp.asarray(bv))
                         for av, bv in ops))
    np.testing.assert_allclose(stream_values_host(vals),
                               jax_stream.stream_values_host(ref_vals),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(stream_to_csr(layout, vals).todense(),
                               _oracle(a, b), rtol=1e-4, atol=1e-4)


def test_plain_executor_equals_wrappers_on_cpu():
    a, b = CASES[2][1], CASES[2][2]
    plan = build_esc_plan(P(a), P(b))
    layout = build_stream_layout(plan)
    ops = stream_operands_to_torch(
        stream_operands(layout, plan, P(a), P(b)), "cpu")
    assert {c["L"] for c in layout.classes} >= {1, 2}
    for x, y in zip(stream_execute(layout, ops),
                    stream_execute_reference(layout, ops)):
        assert torch.equal(x, y)
    assert _build.launches["esc_stream_mul"] == 0
    assert _build.launches["esc_stream_red"] == 0


def test_spgemm_element_matches_reference_result():
    for name, a, b in CASES:
        res = spgemm_element(a, b, "cpu")
        assert isinstance(res, StreamResult)
        ref = jax_element.spgemm_element(a, b, backend="xla")
        np.testing.assert_allclose(res.todense(), ref.todense(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(res.todense(), _oracle(a, b),
                                   rtol=1e-4, atol=1e-4)


def test_spgemm_element_slab_path_not_ported():
    a, b = CASES[2][1], CASES[2][2]
    with pytest.raises(NotImplementedError, match="row-slab"):
        spgemm_element(a, b, "cpu", max_slab_products=2000)


def test_ceil_pow2_and_backend_guard():
    x = np.array([1, 2, 3, 5, 8, 9, 511, 513])
    np.testing.assert_array_equal(_ceil_pow2(x), jax_element._ceil_pow2(x))
    with pytest.raises(ValueError):
        build_esc_plan(P(CASES[0][1]), P(CASES[0][2]), backend="xla")


def test_stream_wrappers_check_arguments():
    a = torch.ones((2, 8))
    with pytest.raises(TypeError):
        esc_stream_mul(a.double(), a.double())
    with pytest.raises(ValueError):
        esc_stream_red(a, torch.ones((2, 4)))
    torch.testing.assert_close(esc_stream_red(a, 2 * a),
                               torch.full((1, 8), 4.0))

