"""The port's element (ESC) path against the JAX reference.

The ESC plan, the stream layout, the operand gathers and the row-slab
helpers are mirrors of the JAX package's and must equal them array by
array.  The executors (on the CPU the kernel wrappers take their plain
versions) must match the Pallas stream kernels in interpret mode, the
reference's ``backend="xla"`` and scipy: f32 products summed in another
order, 1e-4 for the older cases and rtol 1e-5 / atol 1e-6 for the backend
cases.  The CUDA kernels are held to the plain versions on the card by
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
from spada_tpu_torch.config import SpadaConfig
from spada_tpu_torch.ops import element as port_element
from spada_tpu_torch.ops.element import (EscResult, EscSlabbedResult,
                                         _ceil_pow2, build_esc_plan,
                                         expansion_products, spgemm_element)
from spada_tpu_torch.ops.element_stream import (MAX_GROUP_CLASSES,
                                                StreamResult,
                                                build_stream_layout,
                                                esc_stream_group,
                                                esc_stream_mul,
                                                esc_stream_red,
                                                group_table, red_group,
                                                red_slices,
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
    assert _build.launches["esc_stream_group"] == 0


def test_spgemm_element_matches_reference_result():
    for name, a, b in CASES:
        res = spgemm_element(a, b, "cpu")
        assert isinstance(res, StreamResult)
        ref = jax_element.spgemm_element(a, b, backend="xla")
        np.testing.assert_allclose(res.todense(), ref.todense(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(res.todense(), _oracle(a, b),
                                   rtol=1e-4, atol=1e-4)


def _assert_csr_equal(got, ref, tol=1e-6):
    """The same structure array for array, values to ``tol`` of max|ref|."""
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    assert got.data.dtype == ref.data.dtype
    np.testing.assert_allclose(
        got.data, ref.data, rtol=0,
        atol=tol * max(float(np.abs(ref.data).max(initial=0.0)), 1.0))


# the pairs and budgets of tests/test_element.py's slab cases
SLAB_CASES = [
    ("many-slabs", powerlaw_csr(512, 512, 6.0, seed=50, dtype=np.float32),
     powerlaw_csr(512, 512, 6.0, seed=51, dtype=np.float32), 2000),
    ("giant-row", powerlaw_csr(8, 256, 64.0, seed=52, dtype=np.float32),
     powerlaw_csr(256, 256, 8.0, seed=53, dtype=np.float32), 100),
]


def test_spgemm_element_slab_path_not_ported():
    """Above ``max_slab_products`` the entry point streams row slabs, as the
    reference does (it used to raise NotImplementedError)."""
    a, b = CASES[2][1], CASES[2][2]
    res = spgemm_element(a, b, "cpu", max_slab_products=2000)
    ref = jax_element.spgemm_element(a, b, max_slab_products=2000,
                                     backend="xla")
    assert isinstance(res, EscSlabbedResult) and len(res.parts) >= 3
    assert len(res.parts) == len(ref.parts)
    assert all(isinstance(p, StreamResult) for p in res.parts)
    _assert_csr_equal(res.to_csr(), ref.to_csr())
    np.testing.assert_allclose(res.todense(), _oracle(a, b), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("name,a,b,budget", SLAB_CASES,
                         ids=[c[0] for c in SLAB_CASES])
def test_row_slabs_equal_reference(name, a, b, budget, backend):
    res = spgemm_element(a, b, "cpu", max_slab_products=budget,
                         backend=backend)
    ref = jax_element.spgemm_element(a, b, max_slab_products=budget,
                                     backend="xla")
    assert isinstance(res, EscSlabbedResult)
    assert isinstance(ref, jax_element.EscSlabbedResult)
    part = EscResult if backend == "xla" else StreamResult
    assert all(isinstance(p, part) for p in res.parts)
    assert len(res.parts) == len(ref.parts) > (3 if name == "many-slabs"
                                               else 1)
    for attr in ("shape", "n_products", "n_padded", "nnz_c", "n_chunks"):
        assert getattr(res, attr) == getattr(ref, attr), attr
    assert res.operand_bytes() == ref.operand_bytes()
    assert res.elapsed_s >= 0.0
    _assert_csr_equal(res.to_csr(), ref.to_csr())
    np.testing.assert_allclose(res.todense(), _oracle(a, b), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("name,a,b", CASES, ids=IDS)
def test_spgemm_element_backends(name, a, b, backend):
    """Every backend value against the reference's ``backend="xla"`` and
    scipy; the kernel backends return a StreamResult, 'xla' an EscResult."""
    res = spgemm_element(a, b, "cpu", backend=backend)
    assert type(res) is (EscResult if backend == "xla" else StreamResult)
    assert res.elapsed_s > 0.0
    ref = jax_element.spgemm_element(a, b, backend="xla")
    _assert_csr_equal(res.to_csr(), ref.to_csr())
    np.testing.assert_allclose(res.todense(), ref.todense(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(res.todense(), _oracle(a, b), rtol=1e-5,
                               atol=1e-6)
    if backend == "xla":
        for got, want in zip(res.values, ref.values):
            assert got.dtype == torch.float32 and got.dim() == 1
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6)


def test_unknown_element_backend_raises_in_both_packages():
    a, b = CASES[0][1], CASES[0][2]
    for value in ("cuda", "XLA", ""):
        with pytest.raises(ValueError, match="unknown element backend"):
            spgemm_element(a, b, "cpu", backend=value)
        with pytest.raises(ValueError, match="unknown element backend"):
            jax_element.spgemm_element(a, b, backend=value)
    assert port_element.resolve_element_backend("auto") == "pallas"
    assert port_element.resolve_element_backend("xla") == "xla"


def test_spgemm_element_reuses_a_given_plan(monkeypatch):
    """``plan=`` skips the planner and the slab split, as in the
    reference."""
    a, b = CASES[1][1], CASES[1][2]
    plan = build_esc_plan(P(a), P(b))

    def no_plan(*args, **kw):
        raise AssertionError("the planner ran although a plan was given")

    monkeypatch.setattr(port_element, "build_esc_plan", no_plan)
    for backend in ("pallas", "xla"):
        res = spgemm_element(a, b, "cpu", plan=plan, max_slab_products=10,
                             backend=backend)
        assert res.plan is plan
        np.testing.assert_allclose(res.todense(), _oracle(a, b), rtol=1e-5,
                                   atol=1e-6)


def test_spgemm_element_dtype():
    """float32 runs everywhere; the stream kernels refuse another operand
    type, the fused elementwise executor takes it and sums in f32."""
    a, b = CASES[0][1], CASES[0][2]
    with pytest.raises(TypeError, match="stream kernels take float32"):
        spgemm_element(a, b, "cpu", dtype=np.float64)
    with pytest.raises(TypeError, match="stream kernels take float32"):
        spgemm_element(a, b, "cpu", dtype=np.float16, backend="pallas")
    res = spgemm_element(a, b, "cpu", dtype=np.float64, backend="xla")
    assert all(v.dtype == torch.float32 for v in res.values)
    np.testing.assert_allclose(res.todense(), _oracle(a, b), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name,a,b", CASES, ids=IDS)
def test_esc_operands_and_execute_match_reference(name, a, b):
    """The operand gather array for array (L = 1 flat), the f32 chunk
    values to rtol 1e-5 / atol 1e-6, and the bf16 store within one bf16
    ulp of the reference's."""
    import jax.numpy as jnp

    plan = build_esc_plan(P(a), P(b), cap=8)
    ref_plan = jax_element.build_esc_plan(a, b, cap=8)
    ops = port_element.esc_operands(plan, P(a), P(b))
    ref_ops = jax_element.esc_operands(ref_plan, a, b)
    assert len(ops) == len(ref_ops) == len(plan.buckets)
    for bk, (ga, gb), (ra, rb) in zip(plan.buckets, ops, ref_ops):
        assert ga.ndim == (1 if bk.L == 1 else 2)
        assert ga.dtype == ra.dtype == np.float32
        np.testing.assert_array_equal(ga, ra)
        np.testing.assert_array_equal(gb, rb)
    dev_ops = port_element.esc_transfer(ops, "cpu")
    v32 = port_element.esc_execute(dev_ops)
    r32 = jax_element.esc_values_host(jax_element.esc_execute(ref_ops))
    got32 = port_element.esc_values_host(v32)
    assert got32.dtype == r32.dtype == np.float32
    np.testing.assert_allclose(got32, r32, rtol=1e-5, atol=1e-6)
    v16 = port_element.esc_execute(dev_ops, out_dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in v16)
    r16 = np.asarray(jax_element.esc_values_host(jax_element.esc_execute(
        ref_ops, out_dtype=jnp.bfloat16)).astype(np.float32))
    got16 = port_element.esc_values_host(v16)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(r16), 1e-38))) - 7)
    assert np.all(np.abs(got16 - r16) <= ulp)
    # an EscResult extracts as the reference's does
    _assert_csr_equal(EscResult(plan, v32).to_csr(),
                      jax_element.EscResult(ref_plan, jax_element.esc_execute(
                          ref_ops)).to_csr())


def test_esc_transfer_takes_bfloat16_operands():
    import ml_dtypes

    a, b = CASES[0][1], CASES[0][2]
    plan = build_esc_plan(P(a), P(b))
    ops = port_element.esc_operands(plan, P(a), P(b),
                                    dtype=ml_dtypes.bfloat16)
    dev_ops = port_element.esc_transfer(ops, "cpu")
    assert all(x.dtype == torch.bfloat16 for pair in dev_ops for x in pair)
    np.testing.assert_array_equal(
        dev_ops[0][0].float().numpy(), ops[0][0].astype(np.float32))


@pytest.mark.parametrize("name,a,b,budget", SLAB_CASES,
                         ids=[c[0] for c in SLAB_CASES])
def test_row_slab_helpers_match_reference(name, a, b, budget):
    bounds = port_element._row_slab_bounds(P(a), P(b), budget)
    assert bounds == jax_element._row_slab_bounds(a, b, budget)
    assert bounds[0] == 0 and bounds[-1] == a.shape[0]
    slabs, ref_slabs = [], []
    for s, t in zip(bounds[:-1], bounds[1:]):
        got = port_element._slice_rows(P(a), s, t)
        ref = jax_element._slice_rows(a, s, t)
        _assert_csr_equal(got, ref, tol=0.0)
        slabs.append(got)
        ref_slabs.append(ref)
    _assert_csr_equal(port_element.concat_row_slabs(a.shape, slabs),
                      jax_element.concat_row_slabs(a.shape, ref_slabs),
                      tol=0.0)
    _assert_csr_equal(port_element.concat_row_slabs(a.shape, slabs), a,
                      tol=0.0)
    empty = port_element.concat_row_slabs((3, 5), [])
    ref_empty = jax_element.concat_row_slabs((3, 5), [])
    assert empty.nnz == ref_empty.nnz == 0
    np.testing.assert_array_equal(empty.indptr, ref_empty.indptr)


@pytest.mark.parametrize("backend,kind", [("auto", StreamResult),
                                          ("pallas", StreamResult),
                                          ("xla", EscResult)])
def test_spgemm_hands_element_backend_on(backend, kind):
    """``SpadaConfig.element_backend`` reaches ``spgemm_element`` (it used
    to be dropped), and the result's counts are the plan's."""
    from spada_tpu_torch.ops.spgemm import spgemm

    a, b = P(CASES[1][1]), P(CASES[1][2])
    cfg = SpadaConfig(element_backend=backend)
    res = spgemm(a, b, cfg, dataflow="element", device="cpu")
    assert res.engine_used == "element" and type(res.element) is kind
    plan = build_esc_plan(a, b)
    assert res.n_work_items == len(plan.esc_to_csr)
    assert res.mxu_flops == 2 * plan.n_padded
    assert res.useful_flops == 2 * plan.n_products
    np.testing.assert_allclose(res.todense(), _oracle(a, b), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="unknown element backend"):
        spgemm(a, b, SpadaConfig(element_backend="cuda"),
               dataflow="element", device="cpu")


def test_spgemm_reads_a_slabbed_element_result(monkeypatch):
    """A product over the slab budget comes back through ``spgemm`` as an
    EscSlabbedResult, whose counts are the slabs' sums."""
    from spada_tpu_torch.ops import spgemm as port_spgemm

    a, b = P(SLAB_CASES[0][1]), P(SLAB_CASES[0][2])
    real = port_element.spgemm_element
    monkeypatch.setattr(
        port_element, "spgemm_element",
        lambda *args, **kw: real(*args, **{**kw, "max_slab_products": 2000}))
    res = port_spgemm.spgemm(a, b, SpadaConfig(), dataflow="element",
                             device="cpu")
    assert isinstance(res.element, EscSlabbedResult)
    plan = build_esc_plan(a, b)
    assert res.useful_flops == 2 * plan.n_products
    assert res.n_work_items == res.element.n_chunks >= len(plan.esc_to_csr)
    np.testing.assert_allclose(res.todense(), _oracle(a, b), rtol=1e-5,
                               atol=1e-6)


# ---- the grouped launch's host side ----------------------------------------

def _locpl_like_classes():
    """Class sizes of the shape a large power-law plan gives: one big L = 1
    class, red classes shrinking as L grows."""
    return [(1, 47005696), (2, 4478464), (4, 1500032), (8, 400000),
            (16, 100096), (32, 30080), (64, 9984), (128, 4096), (256, 2048),
            (512, 1024)]


@pytest.mark.parametrize("classes", [
    _locpl_like_classes(),
    [(2, 4)],                                 # one float4
    [(1, 4), (2, 0), (512, 4), (8, 1028)],    # an empty class is left out
    [(3, 128), (96, 256), (1, 1024)],         # L not a power of two
    [],
], ids=["locpl", "one-float4", "empty-class", "odd-L", "none"])
def test_group_table_covers_every_column_once(classes):
    table, n_blocks = group_table(classes)
    live = [i for i, (_, n) in enumerate(classes) if n]
    assert sorted(table[:, 0].tolist()) == live
    first = table[:, 5].tolist() + [n_blocks]
    assert first[0] == (0 if live else n_blocks) and first == sorted(first)
    owner = np.full(n_blocks, -1)
    for (i, L, n4, slices, group, lo), hi in zip(table.tolist(), first[1:]):
        assert (L, 4 * n4) == classes[i]
        assert hi > lo and (owner[lo:hi] == -1).all()
        owner[lo:hi] = i          # every block belongs to exactly one class
        per = 512 if L == 1 else 256 // slices
        # the class's blocks cover its columns once: the last block starts
        # inside the class and ends at or past its end
        assert (hi - lo - 1) * per < n4 <= (hi - lo) * per
        if L == 1:
            assert (slices, group) == (1, 1)
        else:
            assert slices == red_slices(L, n4) and L % slices == 0
            assert slices & (slices - 1) == 0 and slices <= 32
            rows = L // slices
            assert group == red_group(L, slices) in (1, 2, 4)
            assert rows % group == 0
    assert (owner >= 0).all()
    # the classes keep the order they come in
    assert table[:, 0].tolist() == live


def test_group_table_order_and_limits():
    classes = _locpl_like_classes()
    order = list(range(len(classes)))[::-1]
    table, n_blocks = group_table(classes, order)
    assert table[:, 0].tolist() == order
    assert n_blocks == group_table(classes)[1]
    with pytest.raises(ValueError, match="permutation"):
        group_table(classes, order[:-1])
    with pytest.raises(ValueError, match=f"at most {MAX_GROUP_CLASSES}"):
        group_table([(2, 8)] * (MAX_GROUP_CLASSES + 1))
    with pytest.raises(ValueError, match="multiple of 4"):
        group_table([(2, 6)])
    assert len(group_table([(2, 8)] * MAX_GROUP_CLASSES)[0]) == \
        MAX_GROUP_CLASSES


def test_red_block_shape_rule():
    # a large class keeps whole columns per thread; a small one splits rows
    assert red_slices(2, 1 << 22) == 1 and red_slices(512, 1 << 22) == 1
    assert red_slices(512, 1024) == 32 and red_slices(8, 16) == 4
    assert red_slices(8, 1 << 16) == 1 and red_slices(8, 1 << 15) == 2
    assert red_slices(2, 1) == 1 and red_slices(3, 1) == 1
    for L in (2, 3, 4, 6, 8, 96, 512):
        for n4 in (1, 1000, 1 << 21):
            s = red_slices(L, n4)
            assert L % s == 0 and (L // s >= 2 or s == 1)
            assert (L // s) % red_group(L, s) == 0


def test_grouped_launch_on_cpu_equals_plain_versions():
    rng = np.random.default_rng(0)
    Ls = [1, 2, 8, 512]
    pairs = []
    for L in Ls:
        shape = (3, 1024) if L == 1 else (L, 12)
        pairs.append(tuple(torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)) for _ in "ab"))
    outs = esc_stream_group(pairs, Ls)
    assert [tuple(o.shape) for o in outs] == [(3, 1024), (1, 12), (1, 12),
                                              (1, 12)]
    assert torch.equal(outs[0], pairs[0][0] * pairs[0][1])
    for (x, y), o in zip(pairs[1:], outs[1:]):
        assert torch.equal(o, (x * y).sum(0, keepdim=True))
    assert esc_stream_group([], []) == ()
    with pytest.raises(ValueError, match="operand pairs"):
        esc_stream_group(pairs, Ls[:-1])
    with pytest.raises(ValueError, match="L=4"):
        esc_stream_group(pairs[1:2], [4])
    assert _build.launches["esc_stream_group"] == 0


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

