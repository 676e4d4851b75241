"""The port's int8 binary artifact (``svd_lstm_tpu_torch/io/int8_export.py``)
against the JAX package's, on the CPU: the same model gives a byte-identical
``.bin`` from either package, and the dequantized oracle is the same float32
model."""

import os

import jax
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.io import int8_export as ji
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu_torch.io import int8_export as pi
from svd_lstm_tpu_torch.io.checkpoint import map_tree, to_tensor_tree
from svd_lstm_tpu_torch.utils import quantize as pq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDE_R24 = os.path.join(REPO, "model_saves", "wide_r24_progressive.npz")
KINDS = ["dense", "reduced-split", "reduced-merged", "reduced-split-full-rank"]


@pytest.fixture(scope="module")
def models():
    dense = init_stacked_lstm(jax.random.PRNGKey(12), input_dim=6, units=(10, 8))
    return {
        "dense": dense,
        "reduced-split": make_reduced_model(make_singular_model(dense, merged_kernel=False), rank=5),
        "reduced-merged": make_reduced_model(make_singular_model(dense, merged_kernel=True), rank=5),
        # rank 8 of n = 8: the recurrent side's C has no columns
        "reduced-split-full-rank": make_reduced_model(
            make_singular_model(dense, merged_kernel=False), rank=8),
    }


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("compensate", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_bin_is_byte_identical_to_jax(tmp_path, models, kind, compensate):
    jpath, ppath = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jsize = ji.save_model_int8_bin(models[kind], jpath, compensate=compensate)
    psize = pi.save_model_int8_bin(P.from_numpy_tree(models[kind], device="cpu"), ppath,
                                   compensate=compensate)
    assert psize == jsize == os.path.getsize(ppath)
    assert _bytes(ppath) == _bytes(jpath)


def test_bin_of_the_committed_3x512_model_is_byte_identical(tmp_path):
    """wide_r24_progressive (3x512 merged r = 24): export only."""
    jpath, ppath = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    ji.save_model_int8_bin(jckpt.load_params(WIDE_R24), jpath)
    pi.save_model_int8_bin(P.load_params(WIDE_R24, device="cpu"), ppath)
    assert _bytes(ppath) == _bytes(jpath)


@pytest.mark.parametrize("kind", KINDS)
def test_dequantized_params_matches_jax(models, kind):
    model = P.from_numpy_tree(models[kind], device="cpu")
    got = pi.dequantized_params(model)
    assert type(got) is type(model)
    want = jax.tree.leaves(ji.dequantized_params(models[kind]))
    leaves = []
    map_tree(leaves.append, to_tensor_tree(got))
    assert len(leaves) == len(want)
    for g, w in zip(leaves, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["reduced-split", "reduced-merged"])
def test_quantize_params_encodes_the_exporters_model(models, kind):
    """The .npz (quantize_params) and .bin encode the same float32 layers:
    the same compensated C on both sides."""
    model = P.from_numpy_tree(models[kind], device="cpu")
    npz = to_tensor_tree(pq.dequantize_params(pq.quantize_params(model)))
    art = to_tensor_tree(pi.dequantized_params(model))
    for ln, la in zip(npz.layers, art.layers):
        a, b = [], []
        map_tree(a.append, ln)
        map_tree(b.append, la)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(), atol=1e-7, rtol=0)


def test_export_refuses_what_the_format_cannot_hold(tmp_path, models):
    dense = P.from_numpy_tree(models["dense"], device="cpu")
    wide = P.StackedLSTM(list(dense.layers), P.DenseHead(torch.zeros(8, 2), torch.zeros(2)))
    path = tmp_path / "wide.bin"
    with pytest.raises(ValueError, match="single-output"):
        pi.save_model_int8_bin(wide, str(path))
    assert not path.exists()  # validated before the file opened
    with pytest.raises(TypeError, match="unsupported"):
        pi.save_model_int8_bin(P.make_singular_model(dense), str(path))
