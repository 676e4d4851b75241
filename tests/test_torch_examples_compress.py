"""The ``compress``, ``train`` and ``sweep`` commands' ``run`` on the CPU
against the JAX package's library calls in the order its scripts make them
(examples/svd_acceleration.py, train_full_model.py, rank_sweep.py): the
weight counts and σ-below-cutoff counts equal, the RMSEs within the
fine-tune parity of tests/test_torch_train.py, the trained checkpoint
predicting in JAX as in the port. The dataset fixture and tolerances are
tests/test_torch_examples.py's."""

import numpy as np

import svd_lstm_tpu_torch as P
from svd_lstm_tpu import config as jcfg
from svd_lstm_tpu.factor import svd as jsvd
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu_torch import examples as ex
from svd_lstm_tpu_torch.examples import rank_sweep, svd_acceleration, train_full_model
from test_torch_examples import FWD_TOL, RMSE_RTOL, SEQUENTIAL, ds  # noqa: F401  (ds: a fixture)


def test_compress_matches_jax(ds, tmp_path):
    from svd_lstm_tpu.ops.layouts import reduced_forward_dense_recurrent
    from svd_lstm_tpu.train.finetune import finetune as jax_finetune
    from svd_lstm_tpu.train.finetune import harvest_sigmas as jax_harvest
    from svd_lstm_tpu.train.loop import predict_full_run as jax_predict_full_run
    from svd_lstm_tpu.train.metrics import rmse as jax_rmse

    kw = dict(num_windows=64, window_len=50, epochs=1, batch_size=32)
    got = svd_acceleration.run(ds, P.TrainConfig(**kw), P.FactorConfig(), ckpt=SEQUENTIAL,
                               export=str(tmp_path / "export"), plots=str(tmp_path), device="cpu",
                               repeats=1)

    model = jckpt.load_params(SEQUENTIAL)
    smodel = jsvd.make_singular_model(model, merged_kernel=False)
    fcfg = jcfg.FactorConfig()
    smodel = jax_finetune(smodel, ds.X_train, ds.y_train, fcfg, jcfg.TrainConfig(**kw)).params
    below = [int((np.abs(su) < fcfg.cutoff).sum()) for _, su in jax_harvest(smodel)]
    rmodel = jsvd.make_reduced_model(smodel, cutoff=fcfg.cutoff)
    # the JAX script's weight accounting (examples/svd_acceleration.py:177-185)
    full_w = sum(int(np.asarray(x).size) for l in model.layers for x in l) + int(
        np.asarray(model.head.w).size + np.asarray(model.head.b).size)
    red_w = sum(l.weight_count() for l in rmodel.layers) + int(
        np.asarray(rmodel.head.w).size + np.asarray(rmodel.head.b).size)
    fy = jax_predict_full_run(model, ds.X)
    ry = np.asarray(reduced_forward_dense_recurrent(rmodel, ds.X, return_sequences=True))[0, :, 0]
    y_m = ex.to_metres(ds, ds.y)

    assert (got["full_weights"], got["reduced_weights"]) == (full_w, red_w)
    assert got["below"] == below
    np.testing.assert_allclose(got["rmse_full"], jax_rmse(y_m, ex.to_metres(ds, fy)), rtol=RMSE_RTOL)
    np.testing.assert_allclose(got["rmse_reduced"], jax_rmse(y_m, ex.to_metres(ds, ry)), rtol=RMSE_RTOL)
    assert (tmp_path / "svd_acceleration_prediction.png").exists()
    assert (tmp_path / "export" / "model_int8.bin").exists()


def test_train_checkpoint_loads_in_jax(ds, tmp_path):
    from svd_lstm_tpu.train.loop import predict_full_run as jax_predict_full_run

    cfg = P.TrainConfig(num_windows=64, window_len=30, epochs=1, batch_size=32)
    got = train_full_model.run(ds, cfg, units=(8, 6), out=str(tmp_path), plots="", device="cpu")
    assert got["result"].history and np.isfinite(got["result"].history).all()
    want = jax_predict_full_run(jckpt.load_params(got["checkpoint"]), ds.X)
    np.testing.assert_allclose(P.predict_full_run(got["result"].params, ds.X), want, atol=FWD_TOL, rtol=0)


def test_sweep_runs_the_library_sweep(ds, tmp_path):
    res = rank_sweep.run(ds, ckpt=SEQUENTIAL, evaluate_every=8, max_reductions=16,
                         plots=str(tmp_path), device="cpu")
    assert res.reductions_done == 16 and len(res.rmse) == 3 and len(res.predictions) == 3
    assert (tmp_path / "RMSE_plot.png").exists()
