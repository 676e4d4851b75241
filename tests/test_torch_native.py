"""The port's binding of the native C++ runtime (``svd_lstm_tpu_torch/io/native.py``)
on the CPU: ``NativeModel`` over the port's CSV and int8 exports matches the
port's ``predict`` within 1e-4 (the limit of tests/test_native.py), and it
refuses corrupt or truncated artifacts."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu_torch.io import native as pn
from svd_lstm_tpu_torch.io.csv_weights import save_model_weights_as_csv
from svd_lstm_tpu_torch.io.int8_export import dequantized_params, save_model_int8_bin
from svd_lstm_tpu_torch.io.native import NativeModel, save_reduced_weights_as_csv

TOL = 1e-4

pytestmark = pytest.mark.skipif(shutil.which(os.environ.get("CXX", "g++")) is None,
                                reason="no C++ compiler")


@pytest.fixture(scope="module")
def models():
    dense = P.from_numpy_tree(
        init_stacked_lstm(jax.random.PRNGKey(7), input_dim=6, units=(10, 8)), device="cpu")
    return {
        "dense": dense,
        "split": P.make_reduced_model(P.make_singular_model(dense, merged_kernel=False), rank=4),
        "merged": P.make_reduced_model(P.make_singular_model(dense, merged_kernel=True), rank=6),
    }


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).normal(size=(40, 6)).astype(np.float32)


def _predict(model, x) -> np.ndarray:
    return P.predict(model, torch.tensor(x), impl="scan")[:, 0].numpy()


def test_build_goes_to_the_ports_own_directory():
    path = pn.build_native()
    assert path == str(pn.LIB_PATH) and os.path.dirname(path).endswith(os.path.join("build", "native"))
    assert os.path.getmtime(path) >= os.path.getmtime(pn.SOURCE)
    assert pn.build_native() == path  # up to date: no rebuild


def test_a_failed_build_raises_and_leaves_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(pn, "LIB_PATH", tmp_path / "native" / "libsvdlstm.so")
    monkeypatch.setenv("CXX", "no-such-compiler-svdlstm")
    with pytest.raises(RuntimeError, match="native build failed"):
        pn.build_native()
    assert os.listdir(tmp_path / "native") == []


@pytest.mark.parametrize("kind", ["dense", "split", "merged"])
@pytest.mark.parametrize("force", [False, True])
def test_csv_export_matches_predict(tmp_path, models, x, kind, force):
    model = models[kind]
    if kind == "dense":
        save_model_weights_as_csv(model, str(tmp_path))
    else:
        save_reduced_weights_as_csv(model, str(tmp_path))
    nm = NativeModel.from_export_dir(str(tmp_path), force_two_step=force)
    np.testing.assert_allclose(nm.run(x), _predict(model, x), atol=TOL)
    if force and kind != "dense":
        assert nm.layer_info(0)["w_reduced"] and nm.layer_info(0)["u_reduced"]


@pytest.mark.parametrize("kind", ["dense", "split", "merged"])
@pytest.mark.parametrize("force", [False, True])
def test_int8_artifact_matches_the_dequantized_predict(tmp_path, models, x, kind, force):
    """The runtime reproduces the artifact's float32 model, not the original:
    the quantization error belongs to the artifact."""
    model = models[kind]
    path = str(tmp_path / "model_int8.bin")
    save_model_int8_bin(model, path)
    nm = NativeModel.from_int8(path, force_two_step=force)
    y = nm.run(x)
    np.testing.assert_allclose(y, _predict(dequantized_params(model), x), atol=TOL)
    if kind == "dense":  # int8 round-off only (a reduced C's grid is coarser)
        assert np.abs(y - _predict(model, x)).max() < 0.05


def test_mixed_kinds_match_predict(tmp_path, models, x):
    """Dense outer layer, reduced inner one ('dr'), and a model whose layers
    mix split and merged reduced forms."""
    dense, split = models["dense"], models["split"]
    save_model_weights_as_csv(dense, str(tmp_path / "dense"))
    save_reduced_weights_as_csv(split, str(tmp_path / "red"))
    os.rename(tmp_path / "dense" / "dense_top", tmp_path / "dense_top")
    nm = NativeModel(str(tmp_path), ["dense/lstm_0", "red/lstm_1"], "dr")
    mixed = P.StackedLSTM([dense.layers[0], P.reconstruct_dense_model(split).layers[1]], dense.head)
    np.testing.assert_allclose(nm.run(x), _predict(mixed, x), atol=TOL)

    both = P.ReducedLSTM([models["split"].layers[0], models["merged"].layers[1]], dense.head)
    save_reduced_weights_as_csv(both, str(tmp_path / "both"))
    assert (tmp_path / "both" / "lstm_0" / "wBi.csv").exists()
    assert (tmp_path / "both" / "lstm_1" / "wB.csv").exists()
    nm = NativeModel.from_export_dir(str(tmp_path / "both"))
    np.testing.assert_allclose(nm.run(x), _predict(both, x), atol=TOL)


def test_state_reset_and_frame_guard(tmp_path, models, x):
    save_model_weights_as_csv(models["dense"], str(tmp_path))
    nm = NativeModel.from_export_dir(str(tmp_path))
    assert nm.input_dim == 6
    a = nm.run(x[:10])
    steps = np.array([nm.step(f) for f in x[:10]])
    assert not np.allclose(a, steps)  # the state carried on
    nm.reset()
    np.testing.assert_allclose(np.array([nm.step(f) for f in x[:10]]), a, atol=1e-6)
    with pytest.raises(ValueError, match="expects 6"):
        nm.step(np.ones(5, np.float32))
    with pytest.raises(ValueError, match="expects 6"):
        nm.run(np.ones((3, 7), np.float32))
    with pytest.raises(IndexError):
        nm.layer_info(2)


def test_rejects_corrupt_and_mismatched_exports(tmp_path, models, rng):
    base = tmp_path / "ok"
    save_model_weights_as_csv(models["dense"], str(base))
    NativeModel(str(base), ["lstm_0", "lstm_1"], "dd")
    for dirs, kinds in ((["lstm_0", "lstm_1"], "ddd"), (["lstm_0"], "dd")):
        with pytest.raises(RuntimeError):
            NativeModel(str(base), dirs, kinds)

    ragged = tmp_path / "ragged"
    shutil.copytree(base, ragged)
    wi = ragged / "lstm_0" / "Wi.csv"
    lines = wi.read_text().strip().splitlines()
    lines[1] = ",".join(lines[1].split(",")[:-2])
    wi.write_text("\n".join(lines) + "\n")
    with pytest.raises(RuntimeError):
        NativeModel(str(ragged), ["lstm_0", "lstm_1"], "dd")

    wide_head = tmp_path / "widehead"
    shutil.copytree(base, wide_head)
    np.savetxt(wide_head / "dense_top" / "weights.csv", rng.normal(size=(8, 2)), delimiter=",")
    with pytest.raises(RuntimeError):
        NativeModel(str(wide_head), ["lstm_0", "lstm_1"], "dd")

    empty = tmp_path / "empty"
    os.makedirs(empty / "lstm_0")
    with pytest.raises(RuntimeError):
        NativeModel.from_export_dir(str(empty))
    with pytest.raises(RuntimeError):
        NativeModel.from_export_dir(str(tmp_path / "nowhere"))


def test_rejects_truncated_and_corrupt_int8_artifacts(tmp_path, models):
    path = tmp_path / "model_int8.bin"
    save_model_int8_bin(models["split"], str(path))
    blob = path.read_bytes()
    for name, data in (("trunc.bin", blob[: len(blob) // 2]), ("badmagic.bin", b"NOTMAGIC" + blob[8:]),
                       ("tail.bin", blob[:-3])):
        (tmp_path / name).write_bytes(data)
        with pytest.raises(RuntimeError):
            NativeModel.from_int8(str(tmp_path / name))
