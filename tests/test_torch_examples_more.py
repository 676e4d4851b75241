"""The port's last workflow modules on the CPU, at tiny sizes, against the JAX
package's library calls on the same weights: ``entry()``,
``examples/wide_rank_accuracy``, ``examples/conv_compression`` and
``examples/realtime_stream`` (the ``distributed`` command:
tests/test_torch_distributed.py).

Tolerances, tests/test_torch_examples.py's: 1e-5 for a forward on the same
weights, rtol 1e-5 for an RMSE computed from one, 1e-4 for the native
runtime; the wide table's RMSEs are rounded to 1e-4 mm, as in the JAX
script's JSON.
"""

import inspect
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
import torch_parallel_cases as tc
from conftest import REPO_DIR
from svd_lstm_tpu.factor.svd import make_reduced_model as j_reduced
from svd_lstm_tpu.factor.svd import make_singular_model as j_singular
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.models.conv import conv_lstm_apply, conv_reduced_apply, conv_singular_apply
from svd_lstm_tpu.models.lstm import stacked_lstm_apply as j_dense_apply
from svd_lstm_tpu.models.reduced import reduced_lstm_apply as j_reduced_apply
from svd_lstm_tpu.train.loop import predict_full_run as j_predict_full_run
from svd_lstm_tpu_torch import examples as ex
from svd_lstm_tpu_torch.entry import entry
from svd_lstm_tpu_torch.examples import conv_compression, realtime_stream
from svd_lstm_tpu_torch.examples import wide_rank_accuracy

FWD_TOL = 1e-5
RMSE_RTOL = 1e-5
NATIVE_TOL = 1e-4
needs_cxx = pytest.mark.skipif(shutil.which(os.environ.get("CXX", "g++")) is None,
                               reason="no C++ compiler")


@pytest.fixture(scope="module")
def ds():
    return tc.example_dataset()


def _jax(model, tmp_path, name="m.npz"):
    path = str(tmp_path / name)
    P.save_params(path, model.cpu() if isinstance(model, torch.nn.Module) else model)
    return jckpt.load_params(path)


# ---------------------------------------------------------------------------
# entry()
# ---------------------------------------------------------------------------

def test_entry_matches_the_jax_entry(tmp_path):
    """The 4x40 stack and x (8, 200, 16) of ``__graft_entry__.entry``; the
    forward on its weights equals the JAX package's."""
    import __graft_entry__

    forward, (model, x) = entry(device="cpu")
    jforward, (jparams, jx) = __graft_entry__.entry()
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert [l.units for l in model.layers] == [40, 40, 40, 40] == [l.units for l in jparams.layers]
    with torch.no_grad():
        y = forward(model, x)
    assert y.shape == (8, 1) == jforward(jparams, jx).shape
    want = np.asarray(jforward(_jax(model, tmp_path), jnp.asarray(x.numpy())))
    np.testing.assert_allclose(y.numpy(), want, atol=FWD_TOL, rtol=0)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        entry()


# ---------------------------------------------------------------------------
# wide_rank_accuracy
# ---------------------------------------------------------------------------

def test_wide_rank_accuracy_matches_jax(ds, tmp_path):
    """The rank table of a seeded 2x16 stack at ranks 8 and 4 with one gated
    recovery epoch: every truncation's RMSE and weight count as the JAX
    package's merged truncation gives them; the JSON where it was asked
    for, no figure."""
    model = P.init_stacked_lstm(torch.Generator().manual_seed(0), 16, (16, 16), device="cpu")
    out = str(tmp_path / "wide.json")
    rcfg = P.TrainConfig(batch_size=16, num_windows=64, window_len=20)
    art = wide_rank_accuracy.run(model, ds, ranks=(8, 4), rcfg=rcfg, recover_epochs=1, out=out, plot="")
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(art))
    inv = lambda v: ex.to_metres(ds, v)  # noqa: E731
    y_true = inv(ds.y_test)
    jdense = _jax(model, tmp_path)
    full = P.rmse(y_true, inv(j_predict_full_run(jdense, ds.X_test, apply_fn=j_dense_apply)))
    assert art["full_rmse_mm"] == pytest.approx(round(full * 1000, 4), abs=1.5e-4)
    jsing = j_singular(jdense, merged_kernel=True)
    for row, r in zip(art["rows"], (8, 4)):
        jred = j_reduced(jsing, rank=r)
        e = P.rmse(y_true, inv(j_predict_full_run(jred, ds.X_test, apply_fn=j_reduced_apply)))
        assert row["rank"] == r
        assert row["rmse_mm"] == pytest.approx(round(e * 1000, 4), abs=1.5e-4)
        assert row["weights"] == sum(l.weight_count() for l in jred.layers)
        assert np.isfinite(row["rmse_fast_mm"]) and np.isfinite(row["rmse_recovered_mm"])
        assert len(row["recovery"]["trace"]) == 1  # one gated epoch
        assert "reduced_ms" not in row  # timed only on the card
    assert art["full_ms"] is None and art["config"]["recover"]["max_epochs"] == 1


def test_wide_rank_accuracy_reads_the_committed_checkpoint_and_writes_elsewhere(monkeypatch):
    monkeypatch.chdir(REPO_DIR)
    defaults = inspect.signature(wide_rank_accuracy.run).parameters
    seen = {}
    monkeypatch.setattr(wide_rank_accuracy, "run", lambda *a, **kw: seen.update(model=a[0], **kw))
    monkeypatch.setattr(ex, "quick_dataset", lambda **kw: None)
    wide_rank_accuracy.main(["--device", "cpu", "--recover-epochs", "1"])
    assert [l.units for l in seen["model"].layers] == [512, 512, 512]
    committed = [os.path.realpath(os.path.join(REPO_DIR, d)) for d in ("model_saves", "plots")]
    for key in ("out", "plot"):
        path = os.path.realpath(seen[key])
        assert not any(path.startswith(d + os.sep) for d in committed), (key, path)
        assert path.startswith(os.path.realpath(ex.OUT_ROOT) + os.sep)
    for key in ("out", "plot"):
        assert defaults[key].default.startswith(ex.OUT_ROOT + os.sep)
    assert seen["recover_epochs"] == 1 and seen["ranks"] == wide_rank_accuracy.RANKS


# ---------------------------------------------------------------------------
# conv_compression and realtime_stream (the native runtime)
# ---------------------------------------------------------------------------

@needs_cxx
def test_conv_compression_matches_jax(ds, tmp_path):
    """Train, σ-tune, truncate to rank 4 and export the conv hybrid; each
    stage's RMSE as the JAX package's forward gives it on the same weights,
    and the native consumer within 5e-4 of the port (asserted by run)."""
    cfg = P.TrainConfig(num_windows=64, window_len=20, epochs=1, batch_size=16)
    res = conv_compression.run(ds, cfg, 1, rank=4, out=str(tmp_path), device="cpu")
    assert os.path.isdir(tmp_path / "conv_reduced_export") and res["native_err"] < conv_compression.NATIVE_TOL
    true_m = ex.to_metres(ds, ds.y)
    for key, apply in (("dense", conv_lstm_apply), ("singular", conv_singular_apply),
                       ("reduced", conv_reduced_apply)):
        pred = j_predict_full_run(_jax(res[key], tmp_path, f"{key}.npz"), ds.X, apply_fn=apply)
        want = 1000.0 * P.rmse(true_m, ex.to_metres(ds, pred))
        assert res[f"rmse_{key}_mm"] == pytest.approx(want, rel=RMSE_RTOL), key
    assert res["reduced_weights"] == res["reduced"].weight_count() < res["dense_weights"]


@needs_cxx
def test_realtime_stream_matches_jax(tmp_path):
    """A split rank-4 2x8 model frame by frame through make_stream_fn and
    stream_many, then the native runtime: each against the JAX package's
    whole-run forward on the same weights."""
    res = realtime_stream.run(units=(8, 8), rank=4, frames=96, device="cpu")
    x = np.random.default_rng(0).normal(size=(1, 96, 16)).astype(np.float32)
    want = np.asarray(j_reduced_apply(_jax(res["model"], tmp_path), jnp.asarray(x)))[0, :, 0]
    np.testing.assert_allclose(res["oracle"], want, atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(res["stream"], want, atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(res["native"], want, atol=NATIVE_TOL, rtol=0)
    assert res["chunk_err"] < realtime_stream.STREAM_TOL
