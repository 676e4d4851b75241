"""The port's CSV and JSON exports (``svd_lstm_tpu_torch/io/csv_weights.py``
and the two-step CSVs of ``io/native.py``) against the JAX package's, on the
CPU: the same model gives byte-identical trees from either package, and each
package reads the other's directories."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.io import csv_weights as jc
from svd_lstm_tpu.io import native as jn
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu_torch.io import csv_weights as pc
from svd_lstm_tpu_torch.io import native as pn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDE_R24 = os.path.join(REPO, "model_saves", "wide_r24_progressive.npz")


@pytest.fixture(scope="module")
def dense():
    return init_stacked_lstm(jax.random.PRNGKey(7), input_dim=6, units=(10, 8))


def _same_tree(a: str, b: str) -> None:
    """Two directories hold the same files with the same bytes."""
    def walk(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files)

    files = walk(a)
    assert files == walk(b) and files
    match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def _port(tree):
    return P.from_numpy_tree(tree, device="cpu")


def test_dense_csv_tree_is_byte_identical(tmp_path, dense):
    jc.save_model_weights_as_csv(dense, str(tmp_path / "jax"))
    pc.save_model_weights_as_csv(_port(dense), str(tmp_path / "port"))
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


@pytest.mark.parametrize("merged", [False, True])
def test_two_step_csv_tree_is_byte_identical(tmp_path, dense, merged):
    red = make_reduced_model(make_singular_model(dense, merged_kernel=merged), rank=5)
    jn.save_reduced_weights_as_csv(red, str(tmp_path / "jax"))
    pn.save_reduced_weights_as_csv(_port(red), str(tmp_path / "port"))
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_two_step_csv_of_the_committed_3x512_model_is_byte_identical(tmp_path):
    jn.save_reduced_weights_as_csv(jckpt.load_params(WIDE_R24), str(tmp_path / "jax"))
    pn.save_reduced_weights_as_csv(P.load_params(WIDE_R24, device="cpu"), str(tmp_path / "port"))
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def _jax_arrays(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _port_arrays(model):
    return [a for a in jax.tree.leaves(P.to_numpy_tree(model))]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_directory(tmp_path, dense, writer):
    path = str(tmp_path / writer)
    if writer == "jax":
        jc.save_model_weights_as_csv(dense, path)
    else:
        pc.save_model_weights_as_csv(_port(dense), path)
    want = _jax_arrays(dense)
    for got in (_port_arrays(pc.load_model_from_csv(path, device="cpu")),
                _jax_arrays(jc.load_model_from_csv(path))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_transposed_fixture_convention_loads_alike(tmp_path, dense):
    """A bare directory (no layout marker) holds (units, in_dim) blocks, as
    the shipped reference fixtures do; both packages read it the same way."""
    path = str(tmp_path / "fixture")
    jc.save_model_weights_as_csv(dense, path)
    os.remove(os.path.join(path, "layout.txt"))
    for d in ("lstm_0", "lstm_1"):
        for f in os.listdir(os.path.join(path, d)):
            if f[0] in "WU":
                p = os.path.join(path, d, f)
                np.savetxt(p, np.loadtxt(p, delimiter=",", ndmin=2).T, delimiter=",")
    got = _port_arrays(pc.load_model_from_csv(path, device="cpu"))
    for g, w in zip(got, _jax_arrays(jc.load_model_from_csv(path))):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got, _jax_arrays(dense)):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    layer = pc.load_layer_from_csv(os.path.join(path, "lstm_1"), device="cpu")
    jlayer = jc.load_layer_from_csv(os.path.join(path, "lstm_1"))
    np.testing.assert_array_equal(layer.U.detach().numpy(), np.asarray(jlayer.U))


def test_csv_model_predicts_as_the_jax_one(tmp_path, dense):
    path = str(tmp_path / "csv")
    jc.save_model_weights_as_csv(dense, path)
    x = np.random.default_rng(3).normal(size=(24, 6)).astype(np.float32)
    from svd_lstm_tpu.models.lstm import stacked_lstm_apply

    got = P.predict(pc.load_model_from_csv(path, device="cpu"), torch.tensor(x))
    want = stacked_lstm_apply(jc.load_model_from_csv(path), jnp.asarray(x)[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_json_and_json_to_csv_are_byte_identical(tmp_path, dense):
    jc.save_model_weights_as_json(dense, str(tmp_path / "jax.json"))
    pc.save_model_weights_as_json(_port(dense), str(tmp_path / "port.json"))
    assert (tmp_path / "jax.json").read_bytes() == (tmp_path / "port.json").read_bytes()
    jc.json_to_csv(str(tmp_path / "jax.json"), str(tmp_path / "jcsv"))
    pc.json_to_csv(str(tmp_path / "port.json"), str(tmp_path / "pcsv"))
    _same_tree(str(tmp_path / "jcsv"), str(tmp_path / "pcsv"))


def test_series_writers_are_byte_identical(tmp_path):
    rng = np.random.default_rng(4)
    t, y, X = rng.normal(size=50), rng.normal(size=50), rng.normal(size=(1, 50, 4))
    jc.predictions_to_csv(str(tmp_path / "jp.csv"), y)
    pc.predictions_to_csv(str(tmp_path / "pp.csv"), torch.tensor(y))
    assert (tmp_path / "jp.csv").read_bytes() == (tmp_path / "pp.csv").read_bytes()
    jc.preprocessed_to_csv(str(tmp_path / "jpre"), t, y, X)
    pc.preprocessed_to_csv(str(tmp_path / "ppre"), torch.tensor(t), torch.tensor(y), torch.tensor(X))
    _same_tree(str(tmp_path / "jpre"), str(tmp_path / "ppre"))


def test_layer_dirs_sort_numerically(tmp_path):
    for name in ("lstm_10", "lstm_2", "lstm_1", "lstm_x", "other"):
        os.makedirs(tmp_path / name)
    assert pc.list_layer_dirs(str(tmp_path)) == jc.list_layer_dirs(str(tmp_path)) == [
        "lstm_1", "lstm_2", "lstm_10", "lstm_x"]


def test_conv_front_end_and_wrong_families_raise(tmp_path, dense):
    path = str(tmp_path / "csv")
    jc.save_model_weights_as_csv(dense, path)
    os.makedirs(os.path.join(path, "conv"))
    with pytest.raises(NotImplementedError, match="item 7"):
        pc.load_model_from_csv(path, device="cpu")
    for fn in (lambda: pc.save_conv_front_csv(None, path), lambda: pc.load_conv_front_csv(path)):
        with pytest.raises(NotImplementedError, match="item 7"):
            fn()
    red = _port(make_reduced_model(make_singular_model(dense), rank=4))
    with pytest.raises(TypeError, match="dense"):
        pc.save_model_weights_as_csv(red, str(tmp_path / "x"))
    with pytest.raises(TypeError, match="reduced"):
        pn.save_reduced_weights_as_csv(_port(dense), str(tmp_path / "y"))
