"""Checkpoint interchange between the PyTorch port and the JAX package.

Every committed checkpoint loads in the port and holds exactly the arrays
the file stores; a checkpoint the port writes loads in the JAX package; and
the numpy-tree conversion round-trips.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu.models.reduced import reduced_lstm_apply
from svd_lstm_tpu.models.singular import singular_lstm_apply

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = sorted(glob.glob(os.path.join(REPO, "model_saves", "*.npz")))


def _file_leaves(path):
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(str(z["__spec__"]))
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        return spec["__node__"], [z[f"leaf_{i}"] for i in range(n)]


def _same_leaves(got_tree, want_leaves):
    got = jax.tree_util.tree_leaves(got_tree)
    assert len(got) == len(want_leaves)
    for g, w in zip(got, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def jax_models():
    dense = init_stacked_lstm(jax.random.PRNGKey(13), input_dim=16, units=(24, 40))
    out = {"dense": dense}
    for merged in (True, False):
        tag = "merged" if merged else "split"
        out[f"singular-{tag}"] = make_singular_model(dense, merged_kernel=merged)
        out[f"reduced-{tag}"] = make_reduced_model(out[f"singular-{tag}"], rank=10)
    return out


FAMILIES = ["dense", "singular-merged", "singular-split", "reduced-merged", "reduced-split"]


def test_every_committed_checkpoint_is_covered():
    assert len(CHECKPOINTS) >= 10
    kinds = {_file_leaves(p)[0] for p in CHECKPOINTS}
    assert kinds == {"StackedLSTMParams", "ReducedModelParams"}


@pytest.mark.parametrize("path", CHECKPOINTS, ids=os.path.basename)
def test_committed_checkpoint_loads_with_its_arrays(path):
    kind, leaves = _file_leaves(path)
    model = P.load_params(path, device="cpu")
    expected = {"StackedLSTMParams": P.StackedLSTM, "ReducedModelParams": P.ReducedLSTM}[kind]
    assert type(model) is expected
    assert all(p.is_contiguous() and p.dtype == torch.float32 for p in model.parameters())
    _same_leaves(P.to_numpy_tree(model), leaves)
    _same_leaves(P.to_numpy_tree(model), jax.tree_util.tree_leaves(jckpt.load_params(path)))


@pytest.mark.parametrize("family", FAMILIES)
def test_port_checkpoint_loads_in_jax(jax_models, family, tmp_path):
    params = jax_models[family]
    path = str(tmp_path / "model.npz")
    P.save_params(path, P.from_numpy_tree(params, device="cpu"))
    back = jckpt.load_params(path)
    assert type(back) is type(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    _same_leaves(back, jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("family", FAMILIES)
def test_jax_checkpoint_loads_in_port_and_runs_alike(jax_models, family, tmp_path):
    params = jax_models[family]
    path = str(tmp_path / "model")  # suffix-less: np.savez appends .npz
    jckpt.save_params(path, params)
    model = P.load_params(path, device="cpu")
    _same_leaves(P.to_numpy_tree(model), jax.tree_util.tree_leaves(params))
    x = np.random.default_rng(14).normal(size=(1, 12, 16)).astype(np.float32)
    if family.startswith("singular"):
        want, got = singular_lstm_apply(params, jnp.asarray(x)), P.singular_lstm_apply(model, torch.tensor(x))
    elif family.startswith("reduced"):
        want, got = reduced_lstm_apply(params, jnp.asarray(x)), P.reduced_lstm_apply(model, torch.tensor(x))
    else:
        return
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("family", FAMILIES)
def test_numpy_tree_round_trip(jax_models, family):
    params = jax_models[family]
    tree = P.to_numpy_tree(P.from_numpy_tree(params, device="cpu"))
    assert type(tree).__name__ == type(params).__name__
    assert type(tree) is P.io.checkpoint.NODE_TYPES[type(params).__name__]
    _same_leaves(tree, jax.tree_util.tree_leaves(params))
    again = P.to_numpy_tree(P.from_numpy_tree(tree, device="cpu"))
    _same_leaves(again, jax.tree_util.tree_leaves(tree))


def test_from_numpy_tree_places_tensors_on_the_device(jax_models):
    model = P.from_numpy_tree(jax_models["reduced-split"], device="meta")
    assert {p.device.type for p in model.parameters()} == {"meta"}


@pytest.mark.parametrize("node", ["ConvLSTMParams", "QuantizedTensor"])
def test_unsupported_node_types_raise_by_name(tmp_path, node):
    spec = {"__node__": node, "fields": {"w": {"__leaf__": 0}}}
    path = str(tmp_path / "other.npz")
    np.savez_compressed(path, __spec__=json.dumps(spec), leaf_0=np.zeros(3, np.float32))
    with pytest.raises(TypeError, match=node):
        P.load_params(path, device="cpu")


def test_jax_conv_checkpoint_raises_by_name(tmp_path):
    """Once the conv hybrids' refusal; a JAX conv checkpoint loads now, and
    the port's save of it is the JAX package's file leaf for leaf."""
    from svd_lstm_tpu.models.conv import init_conv_lstm

    path = str(tmp_path / "conv.npz")
    params = init_conv_lstm(jax.random.PRNGKey(0), units=(8,))
    jckpt.save_params(path, params)
    model = P.load_params(path, device="cpu")
    assert isinstance(model, P.ConvLSTM)
    back = str(tmp_path / "back.npz")
    P.save_params(back, model)
    again = jckpt.load_params(back)
    assert type(again).__name__ == "ConvLSTMParams"
    _same_leaves(again, jax.tree_util.tree_leaves(params))
