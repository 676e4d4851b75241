"""The port's data-parallel training loops (``svd_lstm_tpu_torch/parallel/fit.py``:
``fit_dp``, ``finetune_dp`` and the recovery's ``finetune_reduced_dp``, with
the conv hybrids) against the JAX package's on the CPU.

The port runs SPMD: two gloo ranks, spawned once for the whole file
(``parallel.mesh.launch``), run every case of ``tests/torch_parallel_cases.py``
and return their results; both ranks must return the same. The JAX side
runs the same functions on a dp = 2 mesh cut from the 8 virtual CPU devices
that ``tests/conftest.py`` sets up. Inputs are seeded port models (carried
to the JAX package through the ``.npz`` format) and the data of
``tests/test_parallel_fit.py``.

Tolerances: ``tests/test_parallel_fit.py``'s dp bounds, loss histories
rtol 1e-4 and parameters atol 2e-4 (after 6 Adam steps), against the JAX
package's dp run and against the port's own single-process run. The NaN
rollback restores the initial parameters exactly.
"""

import os

import numpy as np
import pytest

import svd_lstm_tpu_torch as P
import torch_parallel_cases as tc
from svd_lstm_tpu.config import FactorConfig as JFactorConfig
from svd_lstm_tpu.config import TrainConfig as JTrainConfig
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.parallel import fit as jfit
from svd_lstm_tpu.parallel.mesh import make_mesh as j_make_mesh
from svd_lstm_tpu_torch import parallel as par

HIST = dict(rtol=1e-4, atol=0)
PARAMS = dict(atol=2e-4, rtol=0)
CFG = dict(num_windows=32, window_len=8, batch_size=16, epochs=3, seed=11)
KERNEL_CFG = dict(num_windows=64, window_len=6, batch_size=64, epochs=2, seed=3)
DP2 = (2, 1)
_data = tc.fit_data


@pytest.fixture(scope="module")
def models():
    """Seeded port models (the surgery's parity with the JAX package is
    tests/test_torch_factor.py's); :func:`_jax` carries each to the JAX
    package through the ``.npz`` format."""
    init, g = P.init_stacked_lstm, tc.seeded
    hybrid = P.init_conv_lstm(g(2), in_channels=6, filters=8, kernel_size=5, units=(8, 8), device="cpu")
    narrow_hybrid = P.init_conv_lstm(g(7), in_channels=6, filters=8, kernel_size=5, units=(8,), device="cpu")
    return {
        "dense": init(g(0), 6, (10, 8), device="cpu"),
        "dense_kernel": init(g(3), 6, (12, 12), device="cpu"),
        "nan": init(g(2), 6, (8,), device="cpu"),
        "singular": P.make_singular_model(init(g(1), 6, (8, 8), device="cpu"), merged_kernel=False),
        "dropout": P.make_singular_model(init(g(4), 6, (8,), device="cpu"), merged_kernel=False),
        "conv_singular": P.make_conv_singular_model(hybrid),
        "reduced": P.make_reduced_model(P.make_singular_model(init(g(6), 6, (8, 8), device="cpu")), rank=6),
        "conv_reduced": P.make_conv_reduced_model(P.make_conv_singular_model(narrow_hybrid), rank=6),
    }


def _jax(model, tmp_path):
    path = str(tmp_path / "m.npz")
    P.save_params(path, model)
    return jckpt.load_params(path)


def _nan_windows():
    rng = np.random.default_rng(0)
    Xw = rng.normal(size=(32, 8, 6)).astype(np.float32)
    yw = rng.normal(size=(32,)).astype(np.float32)
    return Xw, yw, np.full_like(yw, np.nan)


@pytest.fixture(scope="module")
def ranks(models, tmp_path_factory):
    """Every port case on two gloo ranks, one launch; rank 0's results, after
    checking that rank 1 returned the same."""
    X, y = _data()
    m = models
    cfg = P.TrainConfig(**CFG)
    kcfg = P.TrainConfig(**KERNEL_CFG, recurrence_kernel=True)
    fcfg = P.FactorConfig(hoyer=0.01)
    Xw, yw, yw_bad = _nan_windows()
    one = P.TrainConfig(**{**CFG, "epochs": 1})
    ckpt = str(tmp_path_factory.mktemp("dp") / "best_{rank}.npz")
    cases = [
        ("fit", DP2, "fit", (m["dense"], X, y, cfg)),
        ("fit_kernel", DP2, "fit", (m["dense_kernel"], X, y, kcfg)),
        ("indivisible", DP2, "raises", (m["nan"], X, y, P.TrainConfig(**{**CFG, "batch_size": 15}))),
        ("nan_good", DP2, "fit", (m["nan"], X, y, one, {"windows": (Xw, yw)})),
        ("nan_bad", DP2, "fit", (m["nan"], X, y, one, {"windows": (Xw, yw_bad)})),
        ("checkpoint", DP2, "checkpoint", (m["nan"], X, y, cfg, ckpt)),
        ("finetune", DP2, "finetune", (m["singular"], X, y, fcfg, cfg)),
        ("finetune_conv", DP2, "finetune", (m["conv_singular"], X, y, fcfg, cfg)),
        ("dropout_plain", DP2, "finetune", (m["dropout"], X, y, fcfg, cfg)),
        ("dropout", DP2, "finetune", (m["dropout"], X, y,
                                      P.FactorConfig(hoyer=0.01, dropout=0.4, recurrent_dropout=0.3),
                                      cfg)),
    ]
    for kernel in (False, True):
        tcfg = P.TrainConfig(**CFG, recurrence_kernel=kernel)
        cases += [(f"{name}_{kernel}", DP2, "finetune_reduced", (m[name], X, y, tcfg))
                  for name in ("reduced", "conv_reduced")]
    r0, r1 = par.launch(tc.run_cases, 2, "gloo", "cpu", cases)
    for key in r0:
        if isinstance(r0[key], dict):
            np.testing.assert_array_equal(r0[key]["history"], r1[key]["history"], err_msg=key)
            for a, b in zip(r0[key]["params"], r1[key]["params"]):
                np.testing.assert_array_equal(a, b, err_msg=key)
    r0["checkpoint_paths"] = [ckpt.format(rank=r) for r in (0, 1)]
    return r0


def _close(got: dict, history, params, hist=HIST):
    np.testing.assert_allclose(got["history"], history, **hist)
    assert len(got["params"]) == len(params)
    for a, b in zip(got["params"], params):
        np.testing.assert_allclose(a, np.asarray(b), **PARAMS)


def _leaves(model):
    return [p.detach().numpy() for p in model.parameters()]


def _jax_leaves(jparams):
    """The JAX tree's leaves in the port's parameter order."""
    return _leaves(P.from_numpy_tree(jparams, device="cpu"))


@pytest.fixture(scope="module")
def jmesh():
    return j_make_mesh(dp=2, tp=1)


def test_fit_dp_matches_jax_and_single_process(ranks, models, jmesh, tmp_path):
    X, y = _data()
    want = jfit.fit_dp(_jax(models["dense"], tmp_path), X, y, jmesh, cfg=JTrainConfig(**CFG))
    _close(ranks["fit"], want.history, _jax_leaves(want.params))
    one = P.fit(models["dense"], X, y, P.TrainConfig(**CFG))
    _close(ranks["fit"], one.history, _leaves(one.params))


def test_fit_dp_kernel_route_matches_single_process(ranks, models):
    """recurrence_kernel=True: each rank trains through the train kernels'
    route (their plain versions on CPU tensors), as fit does."""
    X, y = _data()
    one = P.fit(models["dense_kernel"], X, y, P.TrainConfig(**KERNEL_CFG, recurrence_kernel=True))
    _close(ranks["fit_kernel"], one.history, _leaves(one.params))


def test_fit_dp_rejects_indivisible_batch(ranks):
    assert "not divisible by 2" in ranks["indivisible"]


def test_fit_dp_nan_rollback(ranks, models):
    """A NaN epoch rolls back parameters and optimizer state on every rank
    (the loss is reduced before the decision): the initial parameters
    exactly; the clean run is finite."""
    bad = ranks["nan_bad"]
    assert bad["rollbacks"] == 1 and bad["history"] == []
    for a, b in zip(bad["params"], _leaves(models["nan"])):
        np.testing.assert_allclose(a, b, atol=0, rtol=0)
    good = ranks["nan_good"]
    assert good["rollbacks"] == 0 and np.isfinite(good["history"]).all()


def test_fit_dp_validation_and_checkpoint(ranks, models):
    """Validation every epoch on every rank; rank 0 alone writes the
    best-by-loss checkpoint, which loads as the model's family."""
    r = ranks["checkpoint"]
    assert len(r["val_history"]) == len(r["history"]) == CFG["epochs"]
    assert np.isfinite(r["val_history"]).all()
    path0, path1 = ranks["checkpoint_paths"]
    assert os.path.exists(path0) and not os.path.exists(path1)
    best = P.load_params(path0, device="cpu")
    assert [p.shape for p in best.parameters()] == [p.shape for p in models["nan"].parameters()]


@pytest.mark.parametrize("name", ["singular", "conv_singular"])
def test_finetune_dp_matches_jax_and_single_process(ranks, models, jmesh, name, tmp_path):
    X, y = _data()
    key = "finetune" if name == "singular" else "finetune_conv"
    want = jfit.finetune_dp(_jax(models[name], tmp_path), X, y, jmesh,
                            factor_cfg=JFactorConfig(hoyer=0.01), train_cfg=JTrainConfig(**CFG))
    _close(ranks[key], want.history, _jax_leaves(want.params))
    one = P.finetune(models[name], X, y, factor_cfg=P.FactorConfig(hoyer=0.01),
                     train_cfg=P.TrainConfig(**CFG))
    _close(ranks[key], one.history, _leaves(one.params))
    if name == "conv_singular":  # the conv front end stays frozen under σ-only tuning
        for got, start in zip(ranks[key]["params"], models[name].conv.parameters()):
            np.testing.assert_array_equal(got, start.detach().numpy())


def test_finetune_dp_dropout_runs(ranks):
    """FactorConfig's dropout reaches the dp fine-tune: finite, and not the
    dropout-free trajectory."""
    assert np.isfinite(ranks["dropout"]["history"]).all()
    assert not np.allclose(ranks["dropout"]["history"], ranks["dropout_plain"]["history"])


@pytest.mark.parametrize("kernel", [False, True], ids=["scan", "kernel"])
@pytest.mark.parametrize("name", ["reduced", "conv_reduced"])
def test_finetune_reduced_dp(ranks, models, name, kernel, jmesh, tmp_path):
    """The dp recovery fine-tune of the reduced stack and its conv hybrid, on
    the scan and on the kernels' route: against the port's single-process
    run, and the scan against the JAX package's dp run."""
    X, y = _data()
    got = ranks[f"{name}_{kernel}"]
    one = P.finetune_reduced(models[name], X, y, train_cfg=P.TrainConfig(**CFG, recurrence_kernel=kernel))
    _close(got, one.history, _leaves(one.params))
    if not kernel:
        want = jfit.finetune_reduced_dp(_jax(models[name], tmp_path), X, y, jmesh,
                                        train_cfg=JTrainConfig(**CFG))
        _close(got, want.history, _jax_leaves(want.params))
