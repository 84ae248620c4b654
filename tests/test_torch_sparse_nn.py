"""The port's block-sparse MLP (``spada_tpu_torch.models.sparse_nn``)
against the JAX package's on the CPU, from parameters carried across by
``convert.sparse_mlp_from_reference``.

Structures and payloads of ``from_density`` equal the reference's bit for
bit for tm == tk; ``spmm``, ``forward`` and ``loss`` agree to 1e-5 of
max|ref| (f32 products summed in another order); three SGD steps give the
reference's losses and payloads to rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spada_tpu.io.workloads import random_csr
from spada_tpu.models import sparse_nn as ref_nn
from spada_tpu_torch.convert import from_reference as P
from spada_tpu_torch.convert import sparse_mlp_from_reference
from spada_tpu_torch.models import sparse_nn


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1e-30))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("seed", range(8))
def test_from_density_equals_reference_bitwise(seed):
    ref = ref_nn.SparseMLP.from_density((512, 512, 256), density=0.25,
                                        tm=128, tk=128, seed=seed)
    got = sparse_nn.SparseMLP.from_density((512, 512, 256), density=0.25,
                                           tm=128, tk=128, seed=seed,
                                           device="cpu")
    assert len(got.specs) == len(ref.specs)
    for i, (gs, rs) in enumerate(zip(got.specs, ref.specs)):
        assert (gs.n_tile_rows, gs.n_k_tiles, gs.tm, gs.tk) == (
            rs.n_tile_rows, rs.n_k_tiles, rs.tm, rs.tk)
        np.testing.assert_array_equal(gs.tile_row, rs.tile_row)
        np.testing.assert_array_equal(gs.tile_col, rs.tile_col)
        np.testing.assert_array_equal(
            getattr(got, f"tile_col{i}").numpy(), rs.tile_col)
        # the reference hands its payloads to JAX, which keeps f32
        np.testing.assert_array_equal(got.params[i].detach().numpy(),
                                      np.asarray(jnp.asarray(ref.params[i])))
    x = np.random.default_rng(7).standard_normal((got.in_pad, 8))
    with torch.no_grad():
        assert float(got(_t(x)).abs().sum()) > 0, seed


def _small_pair(seed=2):
    ref = ref_nn.SparseMLP.from_density((64, 64, 32), 0.5, tm=8, tk=8,
                                        seed=seed)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal((ref.in_pad, 16)).astype(np.float32)
    y = rng.standard_normal((ref.out_pad, 16)).astype(np.float32)
    return ref, sparse_mlp_from_reference(ref, "cpu"), x, y


def test_spmm_forward_and_loss_match_reference():
    ref, got, x, y = _small_pair()
    params = [jnp.asarray(p) for p in ref.params]
    spec = got.specs[0]
    _close(sparse_nn.spmm(got.params[0], spec, _t(x)).detach(),
           ref_nn.spmm(params[0], ref.specs[0], jnp.asarray(x)))
    with torch.no_grad():
        _close(got(_t(x)), ref.forward(params, jnp.asarray(x)))
        _close(float(got.loss(_t(x), _t(y))),
               float(ref.loss(params, jnp.asarray(x), jnp.asarray(y))))


def test_train_steps_match_reference():
    ref, got, x, y = _small_pair(seed=4)
    step = ref_nn.make_train_step(ref, lr=1e-2)
    port_step = sparse_nn.make_train_step(got, lr=1e-2)
    params = [jnp.asarray(p) for p in ref.params]
    losses = []
    for _ in range(3):
        params, loss = step(params, jnp.asarray(x), jnp.asarray(y))
        port_loss = port_step(_t(x), _t(y))
        np.testing.assert_allclose(float(port_loss), float(loss), rtol=1e-5,
                                   atol=1e-6)
        losses.append(float(port_loss))
    for p, r in zip(got.params, params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   rtol=1e-5, atol=1e-6)
    assert losses[-1] < losses[0]


def test_gradients_match_jax_grad():
    """dW only at the tiles there are; autograd through index_select, bmm
    and index_add gives ``jax.grad``'s tile gradients."""
    ref, got, x, y = _small_pair(seed=6)
    grads = jax.grad(ref.loss)([jnp.asarray(p) for p in ref.params],
                               jnp.asarray(x), jnp.asarray(y))
    got.loss(_t(x), _t(y)).backward()
    for p, g in zip(got.params, grads):
        assert p.grad.shape == p.shape
        _close(p.grad.numpy(), g)


def test_from_csr_weights_matches_reference():
    ws = [random_csr(48, 40, 0.2, seed=1), random_csr(24, 48, 0.3, seed=2)]
    ref = ref_nn.SparseMLP.from_csr_weights(ws, tm=8, tk=8)
    got = sparse_nn.SparseMLP.from_csr_weights([P(w) for w in ws], tm=8,
                                               tk=8, device="cpu")
    for gs, rs in zip(got.specs, ref.specs):
        np.testing.assert_array_equal(gs.tile_row, rs.tile_row)
        np.testing.assert_array_equal(gs.tile_col, rs.tile_col)
    x = np.random.default_rng(3).standard_normal((got.in_pad, 5))
    with torch.no_grad():
        _close(got(_t(x)), ref.forward([jnp.asarray(p) for p in ref.params],
                                       jnp.asarray(x, np.float32)))


def test_connectivity_guard_for_unequal_tile_edges():
    """tm != tk: the reference's guard compares tm-granular tile rows with
    tk-granular k-tiles.  At one kept tile per layer it leaves this network
    dead (its forward is exactly zero); the port rewires onto a k-tile the
    first layer's live row panel covers."""
    dims, dens, tm, tk = (64, 64, 64), 0.05, 16, 8
    ref = ref_nn.SparseMLP.from_density(dims, dens, tm=tm, tk=tk, seed=0)
    got = sparse_nn.SparseMLP.from_density(dims, dens, tm=tm, tk=tk, seed=0,
                                           device="cpu")
    x = np.random.default_rng(0).standard_normal((got.in_pad, 4)).astype(
        np.float32)
    out = ref.forward([jnp.asarray(p) for p in ref.params], jnp.asarray(x))
    assert float(jnp.abs(out).sum()) == 0.0
    with torch.no_grad():
        assert float(got(_t(x)).abs().sum()) > 0
    for prev, spec in zip(got.specs, got.specs[1:]):
        live = {k for r in prev.tile_row
                for k in range(r * tm // tk, ((r + 1) * tm - 1) // tk + 1)}
        assert set(spec.tile_col.tolist()) & live


def test_entry_matches_graft_entry():
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    ref = fn(*args)
    got_fn, got_args = sparse_nn.entry("cpu")
    assert got_args[0].device.type == "cpu"
    np.testing.assert_array_equal(got_args[0].numpy(), np.asarray(args[1]))
    with torch.no_grad():
        _close(got_fn(*got_args), ref)


def test_cuda_entry_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sparse_nn.entry()
