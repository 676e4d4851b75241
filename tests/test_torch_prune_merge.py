"""The port's structural surgery (``models/merge.py``,
``factor/prune_units.py``, ``factor/prune_magnitude.py``) and the gated QAT
recovery against the JAX package on the CPU.

The surgery runs in numpy on the host in both packages with the same
operations, so weights, importance scores, chosen units and σ masks are
compared exactly; forwards atol 1e-6 (float32, another summation order);
the pruning fine-tune's loss history rtol 1e-5 and its σ atol 2e-6 (the
bands of tests/test_torch_train.py); the gate's validation MSEs rtol 1e-4
and the recovered weights atol 1e-4 (tests/test_torch_reduced_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu import config as jcfg
from svd_lstm_tpu.factor import prune_magnitude as jpm
from svd_lstm_tpu.factor import prune_units as jpu
from svd_lstm_tpu.factor import svd as jsvd
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.models import conv as jconv
from svd_lstm_tpu.models import lstm as jlstm
from svd_lstm_tpu.models import merge as jmerge
from svd_lstm_tpu.models.reduced import reduced_lstm_apply as jax_reduced_apply
from svd_lstm_tpu.train import finetune as jft
from svd_lstm_tpu.train.loop import fit as jax_fit
from svd_lstm_tpu.utils import quantize as jq
from svd_lstm_tpu_torch import config as pcfg

FWD = dict(atol=1e-6, rtol=0)
HIST = dict(rtol=1e-5, atol=0)
PARAMS = dict(atol=2e-6, rtol=0)
GATE = dict(rtol=1e-4, atol=0)
D, T = 4, 20


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _equal_trees(port_model, jax_tree):
    got, want = _leaves(P.to_numpy_tree(port_model)), _leaves(jax_tree)
    assert [a.shape for a in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).normal(size=(2, T, D)).astype(np.float32)


@pytest.fixture(scope="module")
def stack():
    """A seeded 3-layer stack of uneven widths, as numpy arrays."""
    return jax.tree.map(np.asarray, jlstm.init_stacked_lstm(jax.random.PRNGKey(4), input_dim=D,
                                                           units=(9, 7, 6)))


@pytest.fixture(scope="module")
def tiny_run():
    """The gate tests' run (tests/test_torch_reduced_train.py)."""
    rng = np.random.default_rng(3)
    xr = rng.normal(size=(400, D)).astype(np.float32)
    kernel = np.exp(-np.arange(10) / 4.0)
    y = np.convolve(xr[:, 0], kernel / kernel.sum(), mode="same").astype(np.float32)
    return xr[None], y


def _cfg(module, epochs=2, **kw):
    return module.TrainConfig(num_windows=32, window_len=12, batch_size=8, seed=0, epochs=epochs, **kw)


# ---------------------------------------------------------------------------
# the parallel -> sequential merge
# ---------------------------------------------------------------------------

def _two_cells(same_x):
    a = jlstm.init_lstm_layer(jax.random.PRNGKey(1), D, 6)
    b = jlstm.init_lstm_layer(jax.random.PRNGKey(2), D if same_x else 3, 5)
    return jax.tree.map(np.asarray, a), jax.tree.map(np.asarray, b)


def _port_layer(cell):
    return P.LSTMLayer(*(torch.tensor(np.asarray(t)) for t in (cell.W, cell.U, cell.b)))


@pytest.mark.parametrize("same_x", [True, False], ids=["same_x", "concat_x"])
def test_merge_matches_jax(same_x):
    a, b = _two_cells(same_x)
    want = jmerge.merge_parallel_cell_weights(a, b, same_x=same_x)
    got = P.merge_parallel_cell_weights(_port_layer(a), _port_layer(b), same_x=same_x)
    for name in ("W", "U", "b"):
        np.testing.assert_array_equal(getattr(got, name).detach().numpy(), np.asarray(getattr(want, name)))
    assert got.units == 11 and got.input_dim == (D if same_x else D + 3)


def test_merge_refuses_unequal_inputs_with_same_x():
    a, b = _two_cells(False)
    with pytest.raises(ValueError, match="same_x requires identical input dims"):
        jmerge.merge_parallel_cell_weights(a, b, same_x=True)
    with pytest.raises(ValueError, match="same_x requires identical input dims"):
        P.merge_parallel_cell_weights(_port_layer(a), _port_layer(b), same_x=True)


@pytest.mark.parametrize("same_x", [True, False], ids=["same_x", "concat_x"])
def test_merged_layer_is_the_two_cells_side_by_side(same_x, x):
    a, b = _two_cells(same_x)
    la, lb = _port_layer(a), _port_layer(b)
    merged = P.merge_parallel_cell_weights(la, lb, same_x=same_x)
    xa = torch.tensor(x)
    xb = xa if same_x else torch.tensor(np.random.default_rng(1).normal(size=(2, T, 3)).astype(np.float32))
    with torch.no_grad():
        h = P.lstm_layer_apply(merged, xa if same_x else torch.cat([xa, xb], dim=-1))
        want = torch.cat([P.lstm_layer_apply(la, xa), P.lstm_layer_apply(lb, xb)], dim=-1)
    np.testing.assert_allclose(h.numpy(), want.numpy(), **FWD)


# ---------------------------------------------------------------------------
# unit pruning
# ---------------------------------------------------------------------------

def test_unit_importance_and_pruning_match_jax(stack):
    model = P.from_numpy_tree(stack, device="cpu")
    for a, b in zip(P.unit_importance(model), jpu.unit_importance(stack)):
        np.testing.assert_array_equal(a, b)
    keep = [np.array([0, 4, 8, 2]), np.array([6, 1]), np.array([5, 0, 3])]
    _equal_trees(P.prune_units(model, keep), jpu.prune_units(stack, keep))
    pruned = P.prune_to_width(model, (5, 4, 3))
    _equal_trees(pruned, jpu.prune_to_width(stack, (5, 4, 3)))
    assert [l.units for l in pruned.layers] == [5, 4, 3] and pruned.head.w.shape == (3, 1)


def test_prune_to_width_breaks_ties_as_jax():
    """Every unit scores the same: both packages keep the same units."""
    n = 8
    tied = jlstm.StackedLSTMParams(
        layers=(jlstm.LSTMLayerParams(W=np.ones((D, 4 * n), np.float32), U=np.ones((n, 4 * n), np.float32),
                                      b=np.zeros(4 * n, np.float32)),),
        head=jlstm.DenseParams(w=np.ones((n, 1), np.float32), b=np.zeros(1, np.float32)))
    model = P.from_numpy_tree(tied, device="cpu")
    scores = P.unit_importance(model)[0]
    assert np.all(scores == scores[0])
    _equal_trees(P.prune_to_width(model, (5,)), jpu.prune_to_width(tied, (5,)))


def test_pruned_model_equals_the_silenced_full_model(stack, x):
    """The pruned stack computes what the full one computes with the
    dropped units silenced: their g-gate columns of W, U and b zeroed (so
    their c and h stay 0), and their rows of the next layer's W and the
    head zeroed."""
    model = P.from_numpy_tree(stack, device="cpu")
    widths = (5, 4, 3)
    scores = P.unit_importance(model)
    keep = [np.sort(np.argsort(s)[::-1][:w]) for s, w in zip(scores, widths)]
    silenced = P.from_numpy_tree(stack, device="cpu")
    with torch.no_grad():
        for li, layer in enumerate(silenced.layers):
            n = layer.units
            drop = np.setdiff1d(np.arange(n), keep[li])
            for M in (layer.W, layer.U):
                M[:, 2 * n + drop] = 0.0
            layer.b[2 * n + drop] = 0.0
            nxt = silenced.layers[li + 1].W if li + 1 < len(silenced.layers) else silenced.head.w
            nxt[drop] = 0.0
        xt = torch.tensor(x)
        np.testing.assert_allclose(P.stacked_lstm_apply(P.prune_to_width(model, widths), xt).numpy(),
                                   P.stacked_lstm_apply(silenced, xt).numpy(), **FWD)


def test_pruned_npz_crosses_both_packages(stack, x, tmp_path):
    """A pruned model written by either package loads in the other, leaf
    for leaf, and predicts what the writer's model predicts."""
    pruned = P.prune_to_width(P.from_numpy_tree(stack, device="cpu"), (5, 4, 3))
    P.save_params(str(tmp_path / "port.npz"), pruned)
    loaded_j = jckpt.load_params(str(tmp_path / "port.npz"))
    _equal_trees(pruned, loaded_j)
    with torch.no_grad():
        np.testing.assert_allclose(np.asarray(jlstm.stacked_lstm_apply(loaded_j, jnp.asarray(x))),
                                   P.stacked_lstm_apply(pruned, torch.tensor(x)).numpy(), **FWD)
    pruned_j = jpu.prune_to_width(stack, (4, 4, 2))
    jckpt.save_params(str(tmp_path / "jax.npz"), pruned_j)
    _equal_trees(P.load_params(str(tmp_path / "jax.npz"), device="cpu"), pruned_j)


# ---------------------------------------------------------------------------
# σ magnitude pruning
# ---------------------------------------------------------------------------

def test_schedule_and_mask_match_jax():
    for kw in ({}, dict(initial_sparsity=0.1, final_sparsity=0.8, begin_step=10, end_step=90, power=2)):
        sp, sj = P.PolynomialDecaySchedule(**kw), jpm.PolynomialDecaySchedule(**kw)
        for step in (0, 5, 10, 11, 50, 89, 90, 1000, 6000):
            assert sp(step) == sj(step), (kw, step)
    rng = np.random.default_rng(2)
    for v in (rng.normal(size=17).astype(np.float32), np.round(rng.normal(size=(4, 9)), 1).astype(np.float32),
              np.zeros(6, np.float32)):
        for s in (0.0, 0.05, 0.3, 0.5, 0.99, 1.0):
            np.testing.assert_array_equal(P.magnitude_mask(v, s), jpm.magnitude_mask(v, s))


@pytest.mark.parametrize("family", ["merged", "split", "conv"])
def test_prune_sigmas_matches_jax(stack, family):
    if family == "conv":
        cj = jax.tree.map(np.asarray, jconv.init_conv_lstm(jax.random.PRNGKey(5), in_channels=D, filters=5,
                                                          kernel_size=3, units=(6, 6)))
        sj = jsvd.make_conv_singular_model(cj, merged_kernel=False)
    else:
        sj = jsvd.make_singular_model(stack, merged_kernel=family == "merged")
    sj = jax.tree.map(np.asarray, sj)
    model = P.from_numpy_tree(sj, device="cpu")
    for s in (0.0, 0.25, 0.5):
        got, want = P.prune_sigmas(model, s), jpm.prune_sigmas(sj, s)
        _equal_trees(got, want)
        assert P.sigma_sparsity(got) == jpm.sigma_sparsity(want)
    assert P.sigma_sparsity(model) == 0.0  # the input model is unchanged


@pytest.mark.parametrize("which", ["hoyer_penalty", "trace_norm_penalty"])
def test_penalty_gradients_at_pruned_sigmas_match_jax(which):
    """A σ that pruning set to exactly 0 (either sign of zero) takes the
    penalty's gradient as in the JAX package, whose |x| has derivative +1
    at 0 (torch.abs has 0)."""
    from svd_lstm_tpu.factor import regularizers as jreg
    from svd_lstm_tpu_torch.factor import regularizers as preg

    v = np.array([0.7, 0.0, -0.3, -0.0, 0.05, 0.0], np.float32)
    want = jax.grad(lambda s: getattr(jreg, which)(s, 0.01))(jnp.asarray(v))
    t = torch.tensor(v, requires_grad=True)
    getattr(preg, which)(t, 0.01).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    assert (t.grad.numpy()[v == 0] > 0).all()


def test_finetune_with_pruning_matches_jax(tiny_run):
    """Two epochs, the mask tightening after each, with the default Hoyer
    penalty (0.01): the history and the final σ (and which are zero) as the
    JAX package's. The σ's zeroed after epoch 0 take the penalty's gradient
    at |0|, +coef/Σσ² in both packages."""
    X, y = tiny_run
    dense = jlstm.init_stacked_lstm(jax.random.PRNGKey(1), input_dim=D, units=(8, 8))
    sj = jax.tree.map(np.asarray, jsvd.make_singular_model(dense, merged_kernel=False))
    sched = dict(final_sparsity=0.5, end_step=8)
    want = jpm.finetune_with_pruning(sj, X, y, jpm.PolynomialDecaySchedule(**sched),
                                     factor_cfg=jcfg.FactorConfig(), train_cfg=_cfg(jcfg))
    got = P.finetune_with_pruning(P.from_numpy_tree(sj, device="cpu"), X, y,
                                  P.PolynomialDecaySchedule(**sched),
                                  factor_cfg=pcfg.FactorConfig(), train_cfg=_cfg(pcfg))
    assert len(got.history) == len(want.history) == 2 and got.rollbacks == want.rollbacks == 0
    np.testing.assert_allclose(got.history, want.history, **HIST)
    for lg, lw in zip(got.params.layers, want.params.layers):
        for f in ("ws", "us"):
            a, b = getattr(lg, f).detach().numpy(), np.asarray(getattr(lw, f))
            np.testing.assert_array_equal(a == 0, b == 0, err_msg=f)
            np.testing.assert_allclose(a, b, **PARAMS, err_msg=f)
    assert P.sigma_sparsity(got.params) == jpm.sigma_sparsity(want.params) > 0.4


# ---------------------------------------------------------------------------
# the gated QAT recovery
# ---------------------------------------------------------------------------

def test_gated_qat_recovery_matches_jax(tiny_run):
    """``recover_reduced_gated`` training and gating through the int8 grid
    (``qat_apply(reduced_lstm_apply)`` for both forwards) on the same r = 4
    truncation: the ``info`` dicts key for key and the accepted model."""
    X, y = tiny_run
    dense = jax_fit(jlstm.init_stacked_lstm(jax.random.PRNGKey(1), D, (8, 8)), X, y, _cfg(jcfg, epochs=2)).params
    rj = jsvd.make_reduced_model(jsvd.make_singular_model(dense, merged_kernel=True), cutoff=None, rank=4)
    kw = dict(lr_ladder=(3e-3, 1e-3), max_epochs=2)
    qj = jq.qat_apply(jax_reduced_apply)
    out_j, info_j = jft.recover_reduced_gated(rj, X, y, train_cfg=_cfg(jcfg, epochs=1), apply_fn=qj,
                                              gate_apply_fn=qj, **kw)
    qp = P.qat_apply(P.reduced_lstm_apply)
    out, info = P.recover_reduced_gated(P.from_numpy_tree(rj, device="cpu"), X, y,
                                        train_cfg=_cfg(pcfg, epochs=1), apply_fn=qp, gate_apply_fn=qp, **kw)
    assert sorted(info) == sorted(info_j)
    for k in ("recipe", "lr_ladder", "clip", "max_epochs", "gate", "accepted_epochs"):
        assert info[k] == info_j[k], k
    assert info["gate"].endswith("(qat_reduced_lstm_apply)")
    assert [(t["lr"], t["accepted"]) for t in info["trace"]] == [(t["lr"], t["accepted"])
                                                               for t in info_j["trace"]]
    for a, b in zip(info["trace"], info_j["trace"]):
        np.testing.assert_allclose(a["val_mse"], b["val_mse"], **GATE)
    for k in ("raw_val_mse", "best_val_mse"):
        np.testing.assert_allclose(info[k], info_j[k], err_msg=k, **GATE)
    assert info["best_val_mse"] <= info["raw_val_mse"]
    for a, b in zip(_leaves(P.to_numpy_tree(out)), _leaves(out_j)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
