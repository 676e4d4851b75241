"""The rank sweep and its rank helpers against the JAX package on the CPU:
``reduce_matrix_rank`` and the two-step helpers within 1e-6, σ of every gate
block within 1e-6, the drop order identical, and ``rank_sweep``'s RMSE
curve within a relative 1e-5 with the order, the weight counts and the
reductions exactly equal (on a 2x8 model and the committed 4x30
checkpoint). Inputs come from numpy seeds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu.bench import sweep as jsweep
from svd_lstm_tpu.config import SweepConfig as JSweepConfig
from svd_lstm_tpu.factor import svd as jsvd
from svd_lstm_tpu.io.checkpoint import load_params as jload
from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
from svd_lstm_tpu_torch.bench import sweep as tsweep
from svd_lstm_tpu_torch.config import SweepConfig
from svd_lstm_tpu_torch.factor import svd as tsvd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE_30 = os.path.join(REPO, "model_saves", "pretrained_30units_v4_n1.5.npz")
HELPER_TOL = 1e-6
RMSE_RTOL = 1e-5


def _ident(a):
    return a


def _affine(a):  # a scaler's inverse_transform, exercised with a non-identity map
    return 2.0 * a + 0.5


def _port(jparams):
    return P.from_numpy_tree(jparams, device="cpu")


@pytest.fixture(scope="module")
def small():
    """A 2x8 JAX model, its port, X (1, 64, 4) and the unreduced model's
    own output as the target (RMSE 0 at the baseline)."""
    jp = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(8, 8))
    X = np.random.default_rng(1).normal(size=(1, 64, 4)).astype(np.float32)
    y = np.asarray(stacked_lstm_apply(jp, jnp.asarray(X)))[0, :, 0]
    noisy = y + np.random.default_rng(2).normal(scale=0.1, size=y.shape).astype(np.float32)
    return jp, _port(jp), X, y, noisy


@pytest.mark.parametrize("shape,rank", [((6, 9), 2), ((12, 5), 4), ((7, 7), 7), ((16, 30), 15)])
def test_rank_helpers_match_jax(shape, rank):
    a = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    np.testing.assert_allclose(tsvd.reduce_matrix_rank(a, rank), jsvd.reduce_matrix_rank(a, rank),
                               atol=HELPER_TOL)
    for got, want in zip(tsvd.two_step_factors(a, rank), jsvd.two_step_factors(a, rank)):
        np.testing.assert_allclose(got, want, atol=HELPER_TOL)
    for got, want in zip(tsvd.reduce_two_step(a, rank), jsvd.reduce_two_step(a, rank)):
        np.testing.assert_allclose(got, want, atol=HELPER_TOL)


def test_singular_values_of_a_widening_stack_match_jax():
    """8 -> 12 units: the σ axis is sized to the widest layer, the
    narrower layer's trailing slots 0, as in JAX."""
    jp = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=5, units=(8, 12))
    got = tsvd.get_model_singular_values(_port(jp))
    want = jsvd.get_model_singular_values(jp)
    assert got.shape == want.shape == (2, 2, 4, 12)
    np.testing.assert_allclose(got, want, atol=HELPER_TOL)
    assert (got[0, :, :, 8:] == 0).all()


@pytest.mark.parametrize("index,rank", [((0, 0, 1), 2), ((1, 1, 3), 5), ((0, 1, 0), 1)])
def test_set_model_matrix_rank_matches_jax_and_shares_the_rest(small, index, rank):
    jp, tp, *_ = small
    got = tsvd.set_model_matrix_rank(tp, index, rank)
    want = jsvd.set_model_matrix_rank(jp, index, rank)
    for gl, wl in zip(got.layers, want.layers):
        for name in ("W", "U", "b"):
            np.testing.assert_allclose(getattr(gl, name).detach().numpy(), np.asarray(getattr(wl, name)),
                                       atol=HELPER_TOL)
    li, wj, _ = index
    reduced = got.layers[li].W if wj == 0 else got.layers[li].U
    new = {id(reduced)}
    for p_new, p_old in zip(got.parameters(), tp.parameters()):
        assert (p_new is p_old) != (id(p_new) in new)  # only the reduced block is new
    assert reduced.dtype == torch.float32


@pytest.mark.parametrize("heuristic", ["absolute", "relative"])
@pytest.mark.parametrize("protect", [True, False])
def test_sorted_sigma_indices_match_jax(small, heuristic, protect):
    jp, tp, *_ = small
    for j, t in ((jp, tp), (jload(DENSE_30), P.load_params(DENSE_30, device="cpu"))):
        got = tsweep.sorted_sigma_indices(t, protect, heuristic)
        want = jsweep.sorted_sigma_indices(j, protect, heuristic)
        np.testing.assert_array_equal(got, want)
        if protect:
            assert not ((got[:, 0] == 0) & (got[:, 1] == 0)).any()


def _assert_same_sweep(got, want):
    np.testing.assert_array_equal(got.order, want.order)
    assert got.reductions_done == want.reductions_done
    np.testing.assert_array_equal(got.weights_eliminated, want.weights_eliminated)
    assert got.rmse.shape == want.rmse.shape
    np.testing.assert_allclose(got.rmse, want.rmse, rtol=RMSE_RTOL, atol=1e-9)
    np.testing.assert_allclose(got.rmse_ratio, want.rmse_ratio, rtol=2 * RMSE_RTOL, atol=1e-9)


@pytest.mark.parametrize("every,threshold,target", [(1, None, "noisy"), (3, None, "noisy"),
                                                     (4, 1.5, "exact")])
def test_rank_sweep_matches_jax_2x8(small, every, threshold, target):
    jp, tp, X, y, noisy = small
    y_true = noisy if target == "noisy" else y
    kw = dict(max_reductions=40, keep_predictions=True)
    got = tsweep.rank_sweep(tp, X, y_true, _affine, SweepConfig(evaluate_every=every, threshold=threshold), **kw)
    want = jsweep.rank_sweep(jp, X, y_true, _affine, JSweepConfig(evaluate_every=every, threshold=threshold),
                             **kw)
    _assert_same_sweep(got, want)
    assert len(got.predictions) == len(got.rmse)
    if threshold is not None:  # a baseline RMSE ~0: the ratio trips at once
        assert got.reductions_done < 40


def test_rank_sweep_matches_jax_4x30_checkpoint():
    """The committed 4x30 checkpoint, T = 256, 24 reductions, an
    evaluation every 8 (the published sweep's model)."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(1, 256, 16)).astype(np.float32)
    y = rng.normal(size=(256,)).astype(np.float32)
    cfg = dict(evaluate_every=8)
    got = tsweep.rank_sweep(P.load_params(DENSE_30, device="cpu"), X, y, _ident, SweepConfig(**cfg),
                            max_reductions=24)
    want = jsweep.rank_sweep(jload(DENSE_30), X, y, _ident, JSweepConfig(**cfg), max_reductions=24)
    _assert_same_sweep(got, want)
    assert len(got.rmse) == 4 and got.reductions_done == 24


def test_rank_sweep_counts_and_final_eval():
    """The baseline and the final state are always evaluated;
    reductions_done counts applied reductions only (tests/test_sweep_viz.py)."""
    tp = _port(init_stacked_lstm(jax.random.PRNGKey(8), input_dim=4, units=(6,)))
    rng = np.random.default_rng(0)
    X = rng.normal(size=(1, 30, 4)).astype(np.float32)
    y = rng.normal(size=(30,)).astype(np.float32)
    res = tsweep.rank_sweep(tp, X, y, _ident, max_reductions=5)
    assert res.reductions_done == 5
    assert len(res.rmse) == 6  # the baseline + one an applied reduction
    assert res.weights_eliminated[0] == 0 and res.weights_eliminated[-1] > 0
    res0 = tsweep.rank_sweep(tp, X, y, _ident, max_reductions=0)
    assert res0.reductions_done == 0
    assert len(res0.rmse) == 1 and res0.rmse_ratio[0] == 1.0


def test_each_evaluation_sees_the_reduction_just_made(small):
    """Replaying the sweep's reductions, a freshly built model (new modules,
    new tensors, the same weights) at each evaluation point gives the RMSE
    the sweep recorded: no cache served an earlier model's weights."""
    _, tp, X, _, noisy = small
    every = 3
    res = tsweep.rank_sweep(tp, X, noisy, _ident, SweepConfig(evaluate_every=every), max_reductions=13,
                            keep_predictions=True)
    x = torch.tensor(X[0])
    ranks = {(li, wj, g): (min(l.input_dim, l.units) if wj == 0 else l.units)
             for li, l in enumerate(tp.layers) for wj in (0, 1) for g in range(4)}
    model, want, applied = tp, [], 0

    def fresh_rmse():
        copy = P.from_numpy_tree(P.to_numpy_tree(model), device="cpu")
        return P.rmse(noisy, P.predict(copy, x)[:, 0].numpy())

    want.append(fresh_rmse())
    for li, wj, g, _ in res.order:
        key = (int(li), int(wj), int(g))
        if ranks[key] - 1 < 1:
            continue
        ranks[key] -= 1
        model = tsvd.set_model_matrix_rank(model, key, ranks[key])
        applied += 1
        if applied % every == 0:
            want.append(fresh_rmse())
    if applied % every:
        want.append(fresh_rmse())
    assert res.rmse.tolist() == want
    assert len(set(want)) > 1  # the reductions moved the RMSE


def test_conv_models_raise():
    """Once the conv hybrids' refusal; the dense hybrid sweeps now, in the
    JAX package's order, its front end kept; other families still raise."""
    from svd_lstm_tpu.models.conv import init_conv_lstm

    jm = init_conv_lstm(jax.random.PRNGKey(0), in_channels=3, filters=4, kernel_size=2, units=(5,))
    m = P.from_numpy_tree(jm, device="cpu")
    np.testing.assert_array_equal(tsweep.sorted_sigma_indices(m), jsweep.sorted_sigma_indices(jm))
    reduced = tsvd.set_model_matrix_rank(m, (0, 1, 2), 2)
    assert isinstance(reduced, P.ConvLSTM) and reduced.conv is m.conv
    np.testing.assert_allclose(reduced.layers[0].U.detach().numpy(),
                               np.asarray(jsvd.set_model_matrix_rank(jm, (0, 1, 2), 2).layers[0].U),
                               atol=1e-6)
    with pytest.raises(TypeError, match="dense"):
        tsweep.sorted_sigma_indices(P.make_conv_singular_model(m))
