"""Model forwards of the PyTorch port against the JAX package on the CPU.

Each JAX model is carried into the port with ``from_numpy_tree``, so both
packages compute with the same weights; inputs are numpy arrays from a seed.
Tolerance atol 2e-5, rtol 1e-5: float32 on both sides, different summation
order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.models.lstm import gate_update, init_stacked_lstm, stacked_lstm_apply
from svd_lstm_tpu.models.reduced import reduced_lstm_apply
from svd_lstm_tpu.models.singular import singular_lstm_apply
from svd_lstm_tpu.ops.layouts import reduced_forward_dense_recurrent
from svd_lstm_tpu_torch.models.lstm import gate_update as gate_update_t
from svd_lstm_tpu_torch.ops.layouts import (
    reduced_forward_dense_recurrent as reduced_forward_dense_recurrent_t,
)

ATOL, RTOL = 2e-5, 1e-5
T = 32


@pytest.fixture(scope="module")
def jax_models():
    dense = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=16, units=(24, 40))
    out = {"dense": dense}
    for merged in (True, False):
        tag = "merged" if merged else "split"
        single = make_singular_model(dense, merged_kernel=merged)
        out[f"singular-{tag}"] = single
        out[f"reduced-{tag}"] = make_reduced_model(single, rank=10)
    return out


_JAX_APPLY = {
    "dense": stacked_lstm_apply,
    "singular": singular_lstm_apply,
    "reduced": reduced_lstm_apply,
}
_PORT_APPLY = {
    "dense": P.stacked_lstm_apply,
    "singular": P.singular_lstm_apply,
    "reduced": P.reduced_lstm_apply,
}
FAMILIES = ["dense", "singular-merged", "singular-split", "reduced-merged", "reduced-split"]


def _x(batch, seed=0):
    return np.random.default_rng(seed).normal(size=(batch, T, 16)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax(jax_models, family, batch):
    params = jax_models[family]
    model = P.from_numpy_tree(params, device="cpu")
    kind = family.split("-")[0]
    x = _x(batch)
    want = _JAX_APPLY[kind](params, jnp.asarray(x))
    got = _PORT_APPLY[kind](model, torch.tensor(x))
    _close(got, want)


@pytest.mark.parametrize("family", FAMILIES)
def test_last_step_matches_jax(jax_models, family):
    params = jax_models[family]
    kind = family.split("-")[0]
    x = _x(2, seed=1)
    want = _JAX_APPLY[kind](params, jnp.asarray(x), return_sequences=False)
    got = P.from_numpy_tree(params, device="cpu")(torch.tensor(x), return_sequences=False)
    assert tuple(got.shape) == (2, 1)
    _close(got, want)


@pytest.mark.parametrize("family", ["reduced-merged", "reduced-split"])
def test_dense_recurrent_layout_matches_jax(jax_models, family):
    params = jax_models[family]
    x = _x(2, seed=2)
    want = reduced_forward_dense_recurrent(params, jnp.asarray(x))
    got = reduced_forward_dense_recurrent_t(P.from_numpy_tree(params, device="cpu"), torch.tensor(x))
    _close(got, want)


def test_gate_update_matches_jax():
    rng = np.random.default_rng(4)
    z = rng.normal(scale=2.0, size=(5, 4 * 24)).astype(np.float32)
    c = rng.normal(size=(5, 24)).astype(np.float32)
    h_j, c_j = gate_update(jnp.asarray(z), jnp.asarray(c))
    h_t, c_t = gate_update_t(torch.tensor(z), torch.tensor(c))
    _close(h_t, h_j)
    _close(c_t, c_j)


@pytest.mark.parametrize("family", FAMILIES)
def test_module_properties_match_jax(jax_models, family):
    params = jax_models[family]
    model = P.from_numpy_tree(params, device="cpu")
    for lj, lt in zip(params.layers, model.layers):
        assert (lt.units, lt.input_dim) == (lj.units, lj.input_dim)
        if hasattr(lj, "split"):
            assert lt.split == lj.split
        if family.startswith("reduced"):
            assert lt.weight_count() == lj.weight_count()
            ranks_j = [B.shape[1] for B in (lj.uB if lj.split else (lj.uB,))]
            assert list(lt.ranks[1]) == ranks_j
