"""The ``distributed`` command (``examples/distributed_training``) on the
CPU: two gloo ranks through its four stages at a tiny size, against the
same chain in one process and the JAX package's prediction on the
resulting weights.

Tolerances, tests/test_torch_examples.py's: 1e-5 for a forward on the same
weights, 1e-4 for losses and predictions after Adam steps (the dp run
against the single-process one); the pipeline within the script's own
1e-4 of the direct prediction.
"""

import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
import torch_parallel_cases as tc
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.models.reduced import reduced_lstm_apply as j_reduced_apply
from svd_lstm_tpu.train.loop import predict_full_run as j_predict_full_run
from svd_lstm_tpu_torch import __main__ as cli
from svd_lstm_tpu_torch.examples import distributed_training

FWD_TOL = 1e-5
LOSS_TOL = 1e-4

DIST_CFG = dict(num_windows=64, window_len=16, epochs=1, batch_size=16)


def test_distributed_is_a_workflow_command():
    assert cli._WORKFLOW["distributed"] == "distributed_training"
    assert "distributed" not in cli._NOT_PORTED and "distributed" in cli.__doc__
    assert distributed_training.batch_for(3) == 63 and distributed_training.batch_for(2) == 64
    with pytest.raises(ValueError, match="multiple of --tp"):
        distributed_training.run((8,), P.TrainConfig(), None, 16, ranks=3, tp=2, device="cpu")


def test_distributed_matches_the_single_process_chain(tmp_path):
    """Two gloo ranks through the four stages; the dense fit, the σ fine-tune and the
    recovery against the same chain in one process, the reduced model's
    prediction against the JAX package's on its weights, and the pipeline
    within the script's 1e-4 of the direct prediction."""
    ds = tc.example_dataset()
    cfg = P.TrainConfig(**DIST_CFG)
    got = distributed_training.run((8, 8), cfg, ds, 200, ranks=2, device="cpu")
    assert got["stages"] == 2 and got["T"] == 200 and got["pp_err"] < distributed_training.PP_TOL

    dense = P.init_stacked_lstm(torch.Generator().manual_seed(0), 16, (8, 8), device="cpu")
    res = P.fit(dense, ds.X_train, ds.y_train, cfg)
    fres = P.finetune(P.make_singular_model(res.params, merged_kernel=False), ds.X_train, ds.y_train,
                      factor_cfg=P.FactorConfig(hoyer=0.01), train_cfg=cfg)
    rres = P.finetune_reduced(P.make_reduced_model(fres.params, cutoff=0.05), ds.X_train, ds.y_train,
                              train_cfg=cfg)
    for key, one in (("history", res), ("finetune_history", fres), ("recovery_history", rres)):
        np.testing.assert_allclose(got[key], one.history, rtol=LOSS_TOL, atol=0, err_msg=key)
    np.testing.assert_allclose(got["prediction"], P.predict_full_run(rres.params, ds.X_test),
                               atol=LOSS_TOL, rtol=0)
    path = str(tmp_path / "m.npz")
    P.save_params(path, got["model"].cpu())
    want = j_predict_full_run(jckpt.load_params(path), ds.X_test, apply_fn=j_reduced_apply)
    np.testing.assert_allclose(got["prediction"], want, atol=FWD_TOL, rtol=0)
