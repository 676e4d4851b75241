"""SVD surgery of the PyTorch port against the JAX package on the CPU.

Both packages take the SVD and the two-step truncation in float64 numpy
from the same float32 weights, so the factors agree to float32 rounding;
the forwards built on them agree to atol 2e-5, rtol 1e-5.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu.factor import svd as jsvd
from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
from svd_lstm_tpu.models.reduced import reduced_lstm_apply
from svd_lstm_tpu.ops.layouts import reconstruct_dense_model as jax_reconstruct
from svd_lstm_tpu_torch.factor import svd as tsvd

ATOL, RTOL = 2e-5, 1e-5


@pytest.fixture(scope="module")
def dense_pair():
    params = init_stacked_lstm(jax.random.PRNGKey(7), input_dim=16, units=(24, 40))
    return params, P.from_numpy_tree(params, device="cpu")


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(8).normal(size=(1, 24, 16)).astype(np.float32)


def _np(t):
    return t.detach().numpy()


def _leaves_close(port_tree, jax_tree, atol=1e-6, rtol=1e-5):
    got = jax.tree_util.tree_leaves(P.to_numpy_tree(port_tree))
    want = jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=rtol)


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
def test_factorize_matches_jax(dense_pair, merged):
    params, model = dense_pair
    _leaves_close(
        P.make_singular_model(model, merged_kernel=merged),
        jsvd.make_singular_model(params, merged_kernel=merged),
    )


@pytest.mark.parametrize("rule", [{"cutoff": 0.05}, {"rank": 10}], ids=["cutoff", "rank"])
@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
def test_truncate_matches_jax(dense_pair, x, merged, rule):
    params, model = dense_pair
    red_j = jsvd.make_reduced_model(jsvd.make_singular_model(params, merged_kernel=merged), **rule)
    red_t = P.make_reduced_model(P.make_singular_model(model, merged_kernel=merged), **rule)
    for lt, lj in zip(red_t.layers, red_j.layers):
        assert lt.split == (not merged)
        assert lt.weight_count() == lj.weight_count()
    _leaves_close(red_t, red_j)
    np.testing.assert_allclose(
        _np(P.reduced_lstm_apply(red_t, torch.tensor(x))),
        np.asarray(reduced_lstm_apply(red_j, jnp.asarray(x))),
        atol=ATOL, rtol=RTOL,
    )


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
def test_singular_to_dense_matches_jax(dense_pair, x, merged):
    params, model = dense_pair
    back_t = P.singular_to_dense(P.make_singular_model(model, merged_kernel=merged))
    back_j = jsvd.singular_to_dense(jsvd.make_singular_model(params, merged_kernel=merged))
    _leaves_close(back_t, back_j, atol=1e-5)
    # and it inverts the factorization
    _leaves_close(back_t, params, atol=1e-5)
    np.testing.assert_allclose(
        _np(P.stacked_lstm_apply(back_t, torch.tensor(x))),
        np.asarray(stacked_lstm_apply(params, jnp.asarray(x))),
        atol=ATOL, rtol=RTOL,
    )


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
def test_reconstruct_dense_model_matches_jax(dense_pair, x, merged):
    params, model = dense_pair
    red_j = jsvd.make_reduced_model(jsvd.make_singular_model(params, merged_kernel=merged), rank=12)
    red_t = P.make_reduced_model(P.make_singular_model(model, merged_kernel=merged), rank=12)
    dense_t = P.reconstruct_dense_model(red_t)
    _leaves_close(dense_t, jax_reconstruct(red_j), atol=1e-5)
    np.testing.assert_allclose(
        _np(P.stacked_lstm_apply(dense_t, torch.tensor(x))),
        _np(P.reduced_lstm_apply(red_t, torch.tensor(x))),
        atol=ATOL, rtol=RTOL,
    )


def _ill_conditioned():
    """Factors whose kept V1 block is singular: the first two columns of
    the right factor are parallel."""
    rng = np.random.default_rng(9)
    left = np.linalg.qr(rng.normal(size=(6, 3)))[0]
    sigma = np.array([3.0, 2.0, 1.0])
    right = rng.normal(size=(3, 8))
    right[:, 1] = 2.0 * right[:, 0]
    return left, sigma, right


def test_ill_conditioned_v1_takes_lstsq_like_jax():
    args = _ill_conditioned()
    with pytest.warns(RuntimeWarning, match="ill-conditioned"):
        B_t, C_t = tsvd._truncate_factors(*args, cutoff=None, rank=3)
    with pytest.warns(RuntimeWarning, match="ill-conditioned"):
        B_j, C_j = jsvd._truncate_factors(*args, cutoff=None, rank=3)
    np.testing.assert_allclose(B_t, B_j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(C_t, C_j, rtol=1e-12, atol=1e-12)
    assert np.all(np.isfinite(C_t))


def test_well_conditioned_v1_does_not_warn():
    rng = np.random.default_rng(10)
    left, sigma, right = np.linalg.svd(rng.normal(size=(6, 8)), full_matrices=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsvd._truncate_factors(left, sigma, right, cutoff=None, rank=4)


@pytest.mark.parametrize("rule", [{"rank": 2}, {"cutoff": 0.5}, {"cutoff": 5.0}],
                         ids=["rank", "cutoff", "cutoff-drops-all"])
def test_selection_by_magnitude_matches_jax(rule):
    """A fine-tuned σ: unordered, with negative entries and ties."""
    rng = np.random.default_rng(11)
    left = rng.normal(size=(5, 5))
    right = rng.normal(size=(5, 9))
    sigma = np.array([0.9, -1.2, 0.3, -0.9, 0.01])
    kw = {"cutoff": None, "rank": None, **rule}
    B_t, C_t = tsvd._truncate_factors(left, sigma, right, **kw)
    B_j, C_j = jsvd._truncate_factors(left, sigma, right, **kw)
    np.testing.assert_array_equal(B_t, B_j)
    np.testing.assert_array_equal(C_t, C_j)


def test_truncation_needs_a_rule(dense_pair):
    _, model = dense_pair
    with pytest.raises(ValueError, match="selection rule"):
        P.make_reduced_model(P.make_singular_model(model), cutoff=None, rank=None)
