"""The ``rank-rmse`` and ``freq`` commands' ``run`` on the CPU against the
JAX package: the rank-RMSE ratios of a carried-over 4x30 checkpoint against
the JAX script's calls (set_model_matrix_rank, predict_full_run) and its
artifact's keys against the committed one's; the toy task's first losses
against a jitted JAX loop on the same initial weights and batches. The
dataset fixture and tolerances are tests/test_torch_examples.py's."""

import dataclasses
import json
import os

import jax
import numpy as np

import svd_lstm_tpu_torch as P
from conftest import REPO_DIR
from svd_lstm_tpu.factor import svd as jsvd
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.models import lstm as jlstm
from svd_lstm_tpu_torch import examples as ex
from svd_lstm_tpu_torch.examples import frequency_prediction, rank_rmse_published
from test_torch_examples import DENSE_30, FWD_TOL, LOSS_TOL, ds  # noqa: F401  (ds: a fixture)


def test_rank_rmse_matches_jax(ds, tmp_path):
    from svd_lstm_tpu.train.loop import predict_full_run as jax_predict_full_run
    from svd_lstm_tpu.train.metrics import rmse as jax_rmse

    # the first 400 steps of the test run: 20 whole-run evaluations a package
    ds = dataclasses.replace(ds, X_test=ds.X_test[:, :400], y_test=ds.y_test[:400],
                             t_test=ds.t_test[:400])
    out = tmp_path / "rr.json"
    art = rank_rmse_published.run(ds, P.TrainConfig(), ckpt=DENSE_30, out=str(out), plot="", device="cpu")
    with open(os.path.join(REPO_DIR, "model_saves", "rank_rmse_30units.json")) as f:
        committed = json.load(f)
    with open(out) as f:
        written = json.load(f)
    assert set(committed) <= set(written) and set(committed["config"]) - {"dataset", "noise", "pipeline"} \
        <= set(written["config"])

    model, y_m = jckpt.load_params(DENSE_30), ex.to_metres(ds, ds.y_test)
    rmses = []
    for k in rank_rmse_published.KS:
        m = model
        for layer in rank_rmse_published.REDUCED_LAYERS:
            for mat in (0, 1):
                for gate in range(4):
                    m = jsvd.set_model_matrix_rank(m, (layer, mat, gate), 30 - k)
        rmses.append(jax_rmse(y_m, ex.to_metres(ds, jax_predict_full_run(m, ds.X_test))))
    np.testing.assert_allclose(written["ratio"], np.asarray(rmses) / rmses[0], atol=FWD_TOL, rtol=0)


def test_freq_losses_match_a_jitted_jax_loop():
    import jax.numpy as jnp
    import optax
    from svd_lstm_tpu.data.synthetic import generate_time_series

    steps = 3
    n_series, n_train = 500, 128 * steps
    jparams = jlstm.init_stacked_lstm(jax.random.PRNGKey(0), 1, (6, 5))
    params = P.from_numpy_tree(jax.tree.map(np.asarray, jparams), device="cpu")
    got = frequency_prediction.run(epochs=1, n_series=n_series, n_train=n_train, params=params,
                                   plots="", device="cpu")

    X, y = generate_time_series(n_series, 76, y_type="frequency", seed=42)
    opt = optax.adam(1e-3)
    state = opt.init(jparams)

    @jax.jit
    def step(p, s, xb, yb):
        def loss(p):
            return jnp.mean((jlstm.stacked_lstm_apply(p, xb, return_sequences=False)[..., 0] - yb) ** 2)

        l, g = jax.value_and_grad(loss)(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, l

    want = []
    for i in range(steps):
        sl = slice(128 * i, 128 * (i + 1))
        jparams, state, l = step(jparams, state, jnp.asarray(X[sl]), jnp.asarray(y[sl]))
        want.append(float(l))
    np.testing.assert_allclose(got["losses"], want, atol=LOSS_TOL, rtol=0)
    assert np.isfinite(got["rmse"])
