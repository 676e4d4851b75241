"""The port's ``export`` and ``stream`` commands (``python -m svd_lstm_tpu_torch``)
on the CPU: ``export`` writes what the JAX package's ``export`` writes, and
``stream --device cpu`` (in a subprocess, and in-process for the other
artifacts) prints ``predict``'s outputs frame by frame: within 1e-5 on the
torch path and 1e-4 through the native runtime (tests/test_cli.py's limits)."""

import filecmp
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from conftest import REPO_DIR, subprocess_env
from svd_lstm_tpu.__main__ import _export as jax_export
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu_torch import __main__ as cli
from svd_lstm_tpu_torch.io.int8_export import dequantized_params
from svd_lstm_tpu_torch.utils.quantize import dequantize_params, quantize_params

TORCH_TOL, NATIVE_TOL = 1e-5, 1e-4
needs_cxx = pytest.mark.skipif(shutil.which(os.environ.get("CXX", "g++")) is None,
                               reason="no C++ compiler")


def _run(*args):
    out = subprocess.run([sys.executable, "-m", "svd_lstm_tpu_torch", *args],
                         env=subprocess_env(), cwd=REPO_DIR, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    dense = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=4, units=(6, 5))
    paths = {"dense": str(root / "dense.npz"), "reduced": str(root / "reduced.npz"),
             "singular": str(root / "singular.npz"), "frames": str(root / "frames.csv")}
    jckpt.save_params(paths["dense"], dense)
    sing = make_singular_model(dense, merged_kernel=False)
    jckpt.save_params(paths["singular"], sing)
    jckpt.save_params(paths["reduced"], make_reduced_model(sing, rank=4))
    frames = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    np.savetxt(paths["frames"], frames, delimiter=",")
    return root, paths, frames


def _predict(model, frames) -> np.ndarray:
    return P.predict(model, torch.tensor(frames), impl="scan")[:, 0].numpy()


def _lines(path) -> np.ndarray:
    return np.loadtxt(path, delimiter=",")


def test_export_then_stream_in_subprocesses(setup):
    """export --int8 --json, then stream the checkpoint on the torch path and
    the .bin through the native runtime, each against predict."""
    root, paths, frames = setup
    out = str(root / "deploy")
    printed = _run("export", paths["dense"], out, "--json", "--int8", "--device", "cpu").stdout
    assert "per-gate CSVs" in printed and "int8 native artifact" in printed
    # the same files as the JAX package's export
    jax_out = str(root / "deploy_jax")
    jax_export([paths["dense"], jax_out, "--json", "--int8"])
    names = sorted(f for f in os.listdir(jax_out) if f != "model_int8.npz")
    assert names == sorted(f for f in os.listdir(out) if f != "model_int8.npz")
    for d in ("lstm_0", "lstm_1", "dense_top"):
        files = sorted(os.listdir(os.path.join(jax_out, d)))
        _, mismatch, errors = filecmp.cmpfiles(os.path.join(jax_out, d), os.path.join(out, d),
                                               files, shallow=False)
        assert not mismatch and not errors
    for f in ("model_int8.bin", "model_weights.json", "layout.txt"):
        assert filecmp.cmp(os.path.join(jax_out, f), os.path.join(out, f), shallow=False)

    model = P.load_params(paths["dense"], device="cpu")
    pred = str(root / "pred.csv")
    run = _run("stream", paths["dense"], "--input", paths["frames"], "--output", pred,
               "--device", "cpu", "--stats")
    assert "engine=torch-cpu" in run.stderr and "p99" in run.stderr
    np.testing.assert_allclose(_lines(pred), _predict(model, frames), atol=TORCH_TOL)
    if shutil.which(os.environ.get("CXX", "g++")):
        pred8 = str(root / "pred8.csv")
        run = _run("stream", os.path.join(out, "model_int8.bin"), "--input", paths["frames"],
                   "--output", pred8, "--stats")
        assert "engine=native" in run.stderr
        np.testing.assert_allclose(_lines(pred8), _predict(dequantized_params(model), frames),
                                   atol=NATIVE_TOL)


def _stream(args, tmp_path) -> np.ndarray:
    pred = str(tmp_path / "pred.csv")
    cli._stream([*args, "--output", pred])
    return _lines(pred)


def test_stream_reads_every_torch_artifact(setup, tmp_path):
    """A CSV export directory and the quantized model_int8.npz, on the torch path."""
    root, paths, frames = setup
    model = P.load_params(paths["dense"], device="cpu")
    out = str(tmp_path / "deploy")
    cli._export([paths["dense"], out, "--int8", "--device", "cpu"])
    got = _stream([out, "--input", paths["frames"], "--device", "cpu"], tmp_path)
    np.testing.assert_allclose(got, _predict(model, frames), atol=TORCH_TOL)
    got = _stream([os.path.join(out, "model_int8.npz"), "--input", paths["frames"],
                   "--device", "cpu"], tmp_path)
    want = _predict(dequantize_params(quantize_params(model)), frames)
    np.testing.assert_allclose(got, want, atol=TORCH_TOL)


@needs_cxx
@pytest.mark.parametrize("force", [False, True])
def test_stream_runs_reduced_artifacts_natively(setup, tmp_path, force):
    """A reduced checkpoint exports two-step CSVs, which only the native
    runtime reads; stream routes them there, as it does --native checkpoints."""
    root, paths, frames = setup
    model = P.load_params(paths["reduced"], device="cpu")
    out = str(tmp_path / "deploy")
    cli._export([paths["reduced"], out, "--int8", "--device", "cpu"])
    extra = ["--force-two-step"] if force else []
    for artifact, want in ((out, model), (paths["reduced"], model),
                           (os.path.join(out, "model_int8.bin"), dequantized_params(model))):
        native = ["--native"] if artifact.endswith(".npz") else []
        got = _stream([artifact, "--input", paths["frames"], *native, *extra], tmp_path)
        np.testing.assert_allclose(got, _predict(want, frames), atol=NATIVE_TOL)


def test_commands_refuse_what_they_cannot_do(setup, tmp_path, monkeypatch, capsys):
    root, paths, _ = setup
    with pytest.raises(SystemExit, match="singular"):
        cli._export([paths["singular"], str(tmp_path / "s"), "--device", "cpu"])
    with pytest.raises(SystemExit, match="--json"):
        cli._export([paths["reduced"], str(tmp_path / "r"), "--json", "--device", "cpu"])
    short = tmp_path / "short.csv"
    short.write_text("1.0,2.0\n")
    with pytest.raises(SystemExit, match="expects 4"):
        cli._stream([paths["dense"], "--input", str(short), "--output", str(tmp_path / "o.csv"),
                     "--device", "cpu"])
    # an unported command names the ROADMAP item that holds it; no command lists them all
    for argv, said in ((["svd_lstm_tpu_torch", "bench"], "item 1"),
                       (["svd_lstm_tpu_torch"], "commands: export, stream, trace, tune, train")):
        monkeypatch.setattr(sys, "argv", argv)
        with pytest.raises(SystemExit) as e:
            cli.main()
        assert e.value.code == 2
        assert said in capsys.readouterr().out
