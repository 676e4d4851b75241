"""The port's training slice (``fit``, the Hoyer σ fine-tune) against the JAX
package on the CPU.

Both packages get the same inputs: the JAX package's initial weights
(``init_stacked_lstm`` → numpy → port) and the same windows, through
``fit(windows=...)``. On the CPU the port's ``recurrence_kernel=True`` path
runs the train kernels' plain versions, and the JAX one its Pallas kernels
in interpret mode. The JAX ``jit_epoch`` switch has no counterpart in the
port (it runs eagerly); both of its settings give the same epoch order.

Tolerances: loss histories rtol 1e-5 and final parameters atol 2e-6 after
8 Adam steps at lr 1e-3, because float32 gradients that differ in their
last bits move Adam's normalised update by far less than its step; values
of the numpy data pipeline are compared exactly.
"""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu import config as jcfg
from svd_lstm_tpu.data import batcher as jbatch
from svd_lstm_tpu.data.dropbear import preprocess_raw as jax_preprocess_raw
from svd_lstm_tpu.data.synthetic import synthetic_dropbear_raw as jax_synthetic
from svd_lstm_tpu.factor import regularizers as jreg
from svd_lstm_tpu.factor.svd import make_singular_model as jax_make_singular
from svd_lstm_tpu.io.checkpoint import load_params as jax_load_params
from svd_lstm_tpu.models.lstm import gate_update_bwd as jax_gate_update_bwd
from svd_lstm_tpu.models.lstm import init_stacked_lstm as jax_init
from svd_lstm_tpu.train.finetune import finetune as jax_finetune
from svd_lstm_tpu.train.loop import fit as jax_fit
from svd_lstm_tpu_torch import config as pcfg
from svd_lstm_tpu_torch.data import batcher as pbatch
from svd_lstm_tpu_torch.data.dropbear import preprocess_raw
from svd_lstm_tpu_torch.data.synthetic import synthetic_dropbear_raw
from svd_lstm_tpu_torch.factor import regularizers as preg
from svd_lstm_tpu_torch.models.lstm import gate_update_bwd
from svd_lstm_tpu_torch.train.finetune import trainable_mask

HIST = dict(rtol=1e-5, atol=0)
PARAMS = dict(atol=2e-6, rtol=0)
WIN_T, WIN_N, BATCH = 12, 32, 8


@pytest.fixture(scope="module")
def data():
    cfg = pcfg.DataConfig(split_time=4.0)
    return preprocess_raw(synthetic_dropbear_raw(duration=6.0), cfg)


@pytest.fixture(scope="module")
def windows(data):
    return pbatch.split_train_random(data.X_train, data.y_train, WIN_N, WIN_T, seed=0)


def _train_cfg(module, **kw):
    base = dict(num_windows=WIN_N, window_len=WIN_T, batch_size=BATCH, epochs=2)
    base.update(kw)
    return module.TrainConfig(**base)


def _leaves_close(port_model, jax_params, tol=PARAMS):
    got = P.to_numpy_tree(port_model)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jax_params)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


# ---------------------------------------------------------------------------
# configuration and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["DataConfig", "ModelConfig", "TrainConfig", "FactorConfig"])
def test_config_defaults_match_jax(name):
    assert dataclasses.asdict(getattr(pcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)())


def test_unported_knobs_raise(data, windows):
    """An unknown matmul_precision is refused. The knobs this test once
    refused are ported (parity with the JAX package:
    tests/test_torch_dropout_remat.py), so each now runs and matches the
    plain scan: ``remat_chunk`` recomputes the same values, a dropout
    fine-tune trains with finite losses and differs from the plain one, and
    both on the conv hybrid. The three regimes and auto_flags:
    tests/test_torch_train_precision.py, test_torch_autotune_train.py."""
    model = P.from_numpy_tree(jax_init(jax.random.PRNGKey(0), input_dim=16, units=(4,)), device="cpu")
    with pytest.raises(ValueError, match="matmul_precision"):
        P.fit(model, data.X_train, data.y_train, _train_cfg(pcfg, matmul_precision="float16"),
              windows=windows)
    plain = P.fit(model, data.X_train, data.y_train, _train_cfg(pcfg), windows=windows)
    remat = P.fit(model, data.X_train, data.y_train, _train_cfg(pcfg, remat_chunk=4), windows=windows)
    np.testing.assert_allclose(remat.history, plain.history, **HIST)
    _leaves_close(remat.params, P.to_numpy_tree(plain.params))
    smodel = P.make_singular_model(model)
    plain = P.finetune(smodel, data.X_train, data.y_train, pcfg.FactorConfig(), _train_cfg(pcfg),
                       windows=windows)
    dropped = P.finetune(smodel, data.X_train, data.y_train, pcfg.FactorConfig(dropout=0.1),
                         _train_cfg(pcfg), windows=windows)
    assert np.isfinite(dropped.history).all() and not np.allclose(dropped.history, plain.history, **HIST)
    # the conv hybrids' dropout and remat
    hybrid = P.make_conv_singular_model(P.init_conv_lstm(
        torch.Generator().manual_seed(0), in_channels=16, filters=4, kernel_size=2, units=(4,),
        device="cpu"))
    base = P.finetune(hybrid, data.X_train, data.y_train, pcfg.FactorConfig(), _train_cfg(pcfg),
                      windows=windows)
    dropped = P.finetune(hybrid, data.X_train, data.y_train, pcfg.FactorConfig(recurrent_dropout=0.1),
                         _train_cfg(pcfg), windows=windows)
    assert np.isfinite(dropped.history).all() and not np.allclose(dropped.history, base.history, **HIST)
    remat = P.finetune(hybrid, data.X_train, data.y_train, pcfg.FactorConfig(),
                       _train_cfg(pcfg, remat_chunk=4), windows=windows)
    np.testing.assert_allclose(remat.history, base.history, **HIST)
    _leaves_close(remat.params, P.to_numpy_tree(base.params))
    # ported since: compact_gates=True (K8) and the reduced recovery
    P.fit(model, data.X_train, data.y_train,
          _train_cfg(pcfg, epochs=1, recurrence_kernel=True, compact_gates=True), windows=windows)
    P.fit(P.make_reduced_model(smodel, rank=2), data.X_train, data.y_train,
          _train_cfg(pcfg, epochs=1), windows=windows)


def test_preprocess_matches_jax(data):
    want = jax_preprocess_raw(jax_synthetic(duration=6.0), jcfg.DataConfig(split_time=4.0))
    for field in ("X", "y", "t", "X_train", "y_train", "t_train", "X_test", "y_test", "t_test"):
        np.testing.assert_array_equal(getattr(data, field), getattr(want, field), err_msg=field)
    for s in ("pin_scaler", "acc_scaler"):
        np.testing.assert_array_equal(getattr(data, s).scale_, getattr(want, s).scale_)
        np.testing.assert_array_equal(getattr(data, s).mean_, getattr(want, s).mean_)


def test_batching_matches_jax(data, windows):
    X_j, y_j = jbatch.split_train_random(data.X_train, data.y_train, WIN_N, WIN_T, seed=0)
    np.testing.assert_array_equal(windows[0], X_j)
    np.testing.assert_array_equal(windows[1], y_j)
    for seed in (0, 3):
        got = list(pbatch.window_epoch_iterator(*windows, BATCH, seed=seed))
        want = list(jbatch.window_epoch_iterator(X_j, y_j, BATCH, seed=seed))
        assert len(got) == len(want) == WIN_N // BATCH
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


# ---------------------------------------------------------------------------
# regularizers, cell gradient, initialisation, Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7,), (5, 9), (4, 6, 3)], ids=["vector", "merged", "split"])
@pytest.mark.parametrize("which", ["hoyer", "trace_norm", "orthogonal"])
def test_regularizers_match_jax(which, shape):
    if which != "orthogonal" and len(shape) == 3:
        shape = (4, 3)
    if which == "orthogonal" and len(shape) == 1:
        shape = (1, 5)  # a single row: no off-diagonal pairs, penalty 0
    a = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    coef = 0.03
    fj = {"hoyer": lambda m: jreg.hoyer_penalty(m, coef),
          "trace_norm": lambda m: jreg.trace_norm_penalty(m, coef),
          "orthogonal": lambda m: jreg.orthogonal_penalty(m, coef)}[which]
    fp = {"hoyer": lambda m: preg.hoyer_penalty(m, coef),
          "trace_norm": lambda m: preg.trace_norm_penalty(m, coef),
          "orthogonal": lambda m: preg.orthogonal_penalty(m, coef)}[which]
    val_j, grad_j = jax.value_and_grad(fj)(jnp.asarray(a))
    t = torch.tensor(a, requires_grad=True)
    val = fp(t)
    val.backward()
    np.testing.assert_allclose(val.item(), float(val_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(grad_j), rtol=1e-5, atol=1e-7)


def test_gate_update_bwd_matches_jax():
    rng = np.random.default_rng(1)
    z, cp, ct, dh, dc = (rng.normal(size=s).astype(np.float32)
                         for s in ((3, 20), (3, 5), (3, 5), (3, 5), (3, 5)))
    dz, dcp = gate_update_bwd(*(torch.tensor(v) for v in (z, cp, ct, dh, dc)))
    dz_j, dcp_j = jax_gate_update_bwd(*(jnp.asarray(v) for v in (z, cp, ct, dh, dc)))
    np.testing.assert_allclose(dz.numpy(), np.asarray(dz_j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(dcp.numpy(), np.asarray(dcp_j), rtol=1e-6, atol=1e-7)


def test_init_stacked_lstm_distributions():
    """Glorot-uniform W and head, one orthogonal block per gate in U,
    forget bias 1, the same model for the same seed; the shapes are the
    JAX package's."""
    units, d = (6, 9), 5
    m = P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=d, units=units, device="cpu")
    again = P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=d, units=units, device="cpu")
    ref = jax_init(jax.random.PRNGKey(0), input_dim=d, units=units)
    for a, b, r in zip(m.parameters(), again.parameters(), jax.tree.leaves(ref)):
        assert a.dtype == torch.float32 and tuple(a.shape) == np.asarray(r).shape
        assert torch.equal(a, b)
    din = d
    for l, n in zip(m.layers, units):
        limit = np.sqrt(6.0 / (din + 4 * n))
        assert float(l.W.detach().abs().max()) <= limit
        for g in range(4):
            blk = l.U[:, g * n : (g + 1) * n].double()
            torch.testing.assert_close(blk.t() @ blk, torch.eye(n, dtype=torch.float64), atol=1e-5, rtol=0)
        want_b = torch.zeros(4 * n)
        want_b[n : 2 * n] = 1.0
        assert torch.equal(l.b.detach(), want_b)
        din = n
    assert float(m.head.w.detach().abs().max()) <= np.sqrt(6.0 / (units[-1] + 1))
    assert torch.equal(m.head.b.detach(), torch.zeros(1))


def test_adam_step_matches_optax():
    rng = np.random.default_rng(2)
    p0, g1, g2 = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3))
    opt = optax.adam(1e-3)
    pj = jnp.asarray(p0)
    state = opt.init(pj)
    t = torch.tensor(p0, requires_grad=True)
    topt = torch.optim.Adam([t], lr=1e-3)
    for g in (g1, g2):
        upd, state = opt.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        t.grad = torch.tensor(g)
        topt.step()
    # the two order the bias corrections differently: a few ulp
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(pj), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# fit and finetune against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", [False, True], ids=["scan", "kernel"])
def test_fit_matches_jax(data, windows, kernel):
    params = jax_init(jax.random.PRNGKey(0), input_dim=16, units=(8, 8))
    want = jax_fit(params, data.X_train, data.y_train, _train_cfg(jcfg, recurrence_kernel=kernel),
                   windows=windows, jit_epoch=False)
    got = P.fit(P.from_numpy_tree(params, device="cpu"), data.X_train, data.y_train,
                _train_cfg(pcfg, recurrence_kernel=kernel), windows=windows)
    assert len(got.history) == len(want.history) == 2
    np.testing.assert_allclose(got.history, want.history, **HIST)
    _leaves_close(got.params, want.params)
    assert got.rollbacks == want.rollbacks == 0


def test_fit_one_aligned_layer_matches_jax(data, windows):
    """A one-layer 256-unit stack is neither narrow nor uniform: both
    packages train its recurrence through K6 (JAX: interpret mode). The
    histories agree as the narrow ones do. The parameters are held to 1e-4
    (a tenth of lr): Adam divides each gradient element by its own scale, so
    where an element's gradient is near zero, float32 noise in it moves that
    element's update by up to lr, and 262 144 weights hold a few such
    elements (8 here, by 2.5e-5)."""
    params = jax_init(jax.random.PRNGKey(0), input_dim=16, units=(256,))
    want = jax_fit(params, data.X_train, data.y_train, _train_cfg(jcfg, recurrence_kernel=True),
                   windows=windows, jit_epoch=False)
    got = P.fit(P.from_numpy_tree(params, device="cpu"), data.X_train, data.y_train,
                _train_cfg(pcfg, recurrence_kernel=True), windows=windows)
    np.testing.assert_allclose(got.history, want.history, **HIST)
    _leaves_close(got.params, want.params, dict(atol=1e-4, rtol=0))


def test_fit_matches_jax_epoch_mode(data, windows):
    """The JAX package's two epoch modes give the same history (and so the
    same order the port follows)."""
    params = jax_init(jax.random.PRNGKey(0), input_dim=16, units=(8,))
    a = jax_fit(params, data.X_train, data.y_train, _train_cfg(jcfg), windows=windows, jit_epoch=True)
    b = jax_fit(params, data.X_train, data.y_train, _train_cfg(jcfg), windows=windows, jit_epoch=False)
    got = P.fit(P.from_numpy_tree(params, device="cpu"), data.X_train, data.y_train, _train_cfg(pcfg), windows=windows)
    np.testing.assert_allclose(a.history, b.history, **HIST)
    np.testing.assert_allclose(got.history, a.history, **HIST)


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
def test_finetune_matches_jax(data, windows, merged):
    dense = jax_init(jax.random.PRNGKey(1), input_dim=16, units=(8, 8))
    sj = jax_make_singular(dense, merged_kernel=merged)
    fcfg = dict(hoyer=0.01)
    want = jax_finetune(sj, data.X_train, data.y_train, jcfg.FactorConfig(**fcfg),
                        _train_cfg(jcfg, recurrence_kernel=True), windows=windows)
    smodel = P.from_numpy_tree(sj, device="cpu")
    got = P.finetune(smodel, data.X_train, data.y_train, pcfg.FactorConfig(**fcfg),
                     _train_cfg(pcfg, recurrence_kernel=True), windows=windows)
    np.testing.assert_allclose(got.history, want.history, **HIST)
    _leaves_close(got.params, want.params)
    for old, new in zip(smodel.layers, got.params.layers):
        for f in ("wl", "wr", "ul", "ur", "b"):
            assert torch.equal(getattr(old, f), getattr(new, f)), f  # frozen: bit-identical
        for f in ("ws", "us"):
            assert not torch.allclose(getattr(old, f), getattr(new, f)), f  # σ moved


def test_finetune_train_uv_matches_jax(data, windows):
    """orthogonal > 0 trains the factors too (and the regularizer's split
    row normalisation reaches their gradients). Freshly factorized square
    factors are exactly orthogonal: their Gram off-diagonals sit at the kink
    of |·|, where the gradient's sign is rounding noise in either package.
    So the factors are perturbed first (the same numbers for both)."""
    dense = jax_init(jax.random.PRNGKey(2), input_dim=16, units=(8,))
    sj = jax_make_singular(dense, merged_kernel=False)
    rng = np.random.default_rng(5)
    sj = jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), sj)
    fcfg = dict(hoyer=0.01, orthogonal=0.01, trace_norm=1e-3)
    want = jax_finetune(sj, data.X_train, data.y_train, jcfg.FactorConfig(**fcfg),
                        _train_cfg(jcfg), windows=windows)
    got = P.finetune(P.from_numpy_tree(sj, device="cpu"), data.X_train, data.y_train, pcfg.FactorConfig(**fcfg),
                     _train_cfg(pcfg), windows=windows)
    np.testing.assert_allclose(got.history, want.history, **HIST)
    _leaves_close(got.params, want.params)
    mask = trainable_mask(got.params, train_uv=False)
    assert {k for k, v in mask.items() if v} == {"layers.0.ws", "layers.0.us", "head.w", "head.b"}


# ---------------------------------------------------------------------------
# fault tolerance, validation, checkpoints
# ---------------------------------------------------------------------------

def test_nan_rollback_restores_params():
    X, y = np.zeros((1, 40, 2), np.float32), np.zeros(40, np.float32)
    model = P.from_numpy_tree(jax_init(jax.random.PRNGKey(0), input_dim=2, units=(8,)), device="cpu")
    res = P.fit(model, X, y, _train_cfg(pcfg, window_len=10, batch_size=4, num_windows=8),
                loss_extra=lambda m: torch.tensor(float("nan")))
    assert res.rollbacks == 2 and res.history == []
    for a, b in zip(model.parameters(), res.params.parameters()):
        assert torch.equal(a, b)


def test_nan_rollback_restores_optimizer_state():
    """One poisoned window (NaN target) that epoch 0's batch-truncation
    permutation drops and epoch 1's includes: epoch 0 trains cleanly, epoch
    1 NaNs out and must restore the params and Adam's moments of epoch 0."""
    n_win, T, d, bs, seed = 9, 10, 2, 4, 0
    dropped0 = int(np.random.default_rng(seed + 0).permutation(n_win)[-1])
    dropped1 = int(np.random.default_rng(seed + 1).permutation(n_win)[-1])
    assert dropped0 != dropped1
    rng = np.random.default_rng(7)
    X_mini = rng.normal(size=(n_win, T, d)).astype(np.float32)
    y_mini = rng.normal(size=(n_win,)).astype(np.float32)
    y_mini[dropped0] = np.nan
    model = P.from_numpy_tree(jax_init(jax.random.PRNGKey(0), input_dim=d, units=(8,)), device="cpu")
    dummy_X, dummy_y = np.zeros((1, 2 * T, d), np.float32), np.zeros(2 * T, np.float32)
    kw = dict(batch_size=bs, seed=seed, window_len=T)
    ref = P.fit(model, dummy_X, dummy_y, _train_cfg(pcfg, epochs=1, **kw), windows=(X_mini, y_mini))
    res = P.fit(model, dummy_X, dummy_y, _train_cfg(pcfg, epochs=2, **kw), windows=(X_mini, y_mini))
    assert res.rollbacks == 1 and len(res.history) == 1
    assert res.history[0] == ref.history[0]
    for a, b in zip(ref.params.parameters(), res.params.parameters()):
        assert torch.equal(a, b)
    moments = [(s["exp_avg"], s["exp_avg_sq"]) for s in ref.opt_state["state"].values()]
    assert any(float(m.abs().max()) > 0 for pair in moments for m in pair)
    for k, s in ref.opt_state["state"].items():
        r = res.opt_state["state"][k]
        for name in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(s[name], r[name]), name


def test_validation_and_checkpoint_match_jax(data, windows, tmp_path):
    params = jax_init(jax.random.PRNGKey(3), input_dim=16, units=(8,))
    val = (data.X_test, data.y_test)
    want = jax_fit(params, data.X_train, data.y_train, _train_cfg(jcfg), windows=windows,
                   validation=val, jit_epoch=False)
    path = str(tmp_path / "best.npz")
    got = P.fit(P.from_numpy_tree(params, device="cpu"), data.X_train, data.y_train, _train_cfg(pcfg),
                windows=windows, validation=val, checkpoint_path=path)
    assert len(got.val_history) == 2
    np.testing.assert_allclose(got.val_history, want.val_history, rtol=1e-5)
    best = int(np.argmin(got.history))
    assert best == len(got.history) - 1  # the loss fell, so the last epoch was saved
    loaded = jax_load_params(path)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(P.to_numpy_tree(got.params))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_fit_leaves_the_input_model_unchanged(data, windows):
    model = P.from_numpy_tree(jax_init(jax.random.PRNGKey(0), input_dim=16, units=(4,)), device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    res = P.fit(model, data.X_train, data.y_train, _train_cfg(pcfg, epochs=1), windows=windows)
    assert res.params is not model
    for a, b in zip(before, model.parameters()):
        assert torch.equal(a, b)

