"""The port's int8 quantizer (``svd_lstm_tpu_torch/utils/quantize.py``) against
the JAX package's, on the CPU.

The same models (drawn by the JAX package from a seed, handed to the port as
numpy trees) and the same numpy inputs go through both. ``q`` is bit-equal,
``scale`` equal to float32 rounding (rtol 1e-7); forwards agree within the
port's ATOL, RTOL = 2e-5, 1e-5. The reduced family's QAT view re-solves C by
a float32 least squares on two LAPACK builds, so it is held at the JAX
test's own tolerance for that view (1e-4: tests/test_quantize.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st_h

import svd_lstm_tpu_torch as P
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.models.lstm import init_stacked_lstm, stacked_lstm_apply
from svd_lstm_tpu.models.reduced import reduced_lstm_apply
from svd_lstm_tpu.models.singular import singular_lstm_apply
from svd_lstm_tpu.utils import quantize as jq
from svd_lstm_tpu_torch.io.checkpoint import map_arrays, map_tree, to_tensor_tree
from svd_lstm_tpu_torch.utils import quantize as pq

ATOL, RTOL = 2e-5, 1e-5
QAT_TOL = 1e-4  # tests/test_quantize.py:275, f32 lstsq vs its float64 oracle
FAMILIES = ["dense", "singular-merged", "singular-split", "reduced-merged", "reduced-split"]
JAX_APPLY = {"dense": stacked_lstm_apply, "singular": singular_lstm_apply,
             "reduced": reduced_lstm_apply}


@pytest.fixture(scope="module")
def models():
    dense = init_stacked_lstm(jax.random.PRNGKey(5), input_dim=6, units=(10, 10))
    out = {"dense": dense}
    for merged in (True, False):
        tag = "merged" if merged else "split"
        out[f"singular-{tag}"] = make_singular_model(dense, merged_kernel=merged)
        out[f"reduced-{tag}"] = make_reduced_model(out[f"singular-{tag}"], rank=6)
    return out


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).normal(size=(1, 32, 6)).astype(np.float32)


def _port(jax_model):
    return P.from_numpy_tree(jax_model, device="cpu")


def _arrays(tree) -> list:
    """Every array of a port tree (q and scale of a quantized leaf), as numpy."""
    out = []
    map_arrays(lambda t: out.append(t.detach().numpy()), tree)
    return out


def _tree_leaves(model) -> list:
    """A model's parameters in its tree's (and the JAX package's) order."""
    out = []
    map_tree(out.append, to_tensor_tree(model))
    return out


def _same_quantized(port_tree, jax_tree):
    jl = [np.asarray(a) for a in jax.tree.leaves(jax_tree)]
    pl = _arrays(port_tree)
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        assert p.dtype == j.dtype and p.shape == j.shape
        if p.dtype == np.int8:
            np.testing.assert_array_equal(p, j)
        else:
            np.testing.assert_allclose(p, j, rtol=1e-7, atol=0)


@pytest.mark.parametrize("shape,axis", [((37, 64), 0), ((5, 1), 0), ((4, 9, 7), 1), ((8, 4), 1)])
def test_quantize_tensor_matches_jax(shape, axis):
    w = (np.random.default_rng(1).normal(size=shape) * 3).astype(np.float32)
    w[..., 0] = 0.0  # a zero column (or row) takes scale 1 and encodes exactly
    jt, pt = jq.quantize_tensor(jnp.asarray(w), axis), pq.quantize_tensor(torch.tensor(w), axis)
    assert pt.q.dtype == torch.int8 and pt.shape == w.shape
    assert pt.nbytes == pt.q.numel() + 4 * pt.scale.numel()
    np.testing.assert_array_equal(pt.q.numpy(), np.asarray(jt.q))
    np.testing.assert_allclose(pt.scale.numpy(), np.asarray(jt.scale), rtol=1e-7, atol=0)
    np.testing.assert_array_equal(pq.dequantize_tensor(pt).numpy(),
                                  np.asarray(jq.dequantize_tensor(jt)))


@pytest.mark.parametrize("family", FAMILIES)
def test_quantize_params_matches_jax(models, family):
    jmodel = models[family]
    q = pq.quantize_params(_port(jmodel))
    jqt = jq.quantize_params(jmodel)
    assert type(q).__name__ == type(jqt).__name__
    _same_quantized(q, jqt)
    assert pq.param_bytes(q) == jq.param_bytes(jqt)
    assert pq.param_bytes(_port(jmodel)) == jq.param_bytes(jmodel)
    # a quantized tree counts one byte a q entry, four a scale and a float32 leaf
    counted = []
    map_tree(lambda t: counted.append(t.nbytes if isinstance(t, pq.QuantizedTensor)
                                      else 4 * t.numel()), q)
    assert pq.param_bytes(q) == sum(counted) < 0.5 * pq.param_bytes(_port(jmodel))


@pytest.mark.parametrize("family", FAMILIES)
def test_quantized_forward_matches_jax(models, family, x):
    jmodel = models[family]
    q = pq.quantize_params(_port(jmodel))
    got = pq.quantized_apply(P.predict)(q, torch.tensor(x[0]), impl="scan")
    want = jax.jit(jq.quantized_apply(JAX_APPLY[family.split("-")[0]]))(
        jq.quantize_params(jmodel), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[0], atol=ATOL, rtol=RTOL)
    back = pq.dequantize_params(q)
    assert type(back) is type(_port(jmodel))
    jback = jq.dequantize_params(jq.quantize_params(jmodel))
    for p, j in zip(_arrays(to_tensor_tree(back)), jax.tree.leaves(jback)):
        np.testing.assert_allclose(p, np.asarray(j), rtol=1e-7, atol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_quantize_params_is_idempotent(models, family):
    q = pq.quantize_params(_port(models[family]))
    qq = pq.quantize_params(q)
    for a, b in zip(_arrays(q), _arrays(qq)):
        np.testing.assert_array_equal(a, b)
    assert not isinstance(qq.layers[0].b, pq.QuantizedTensor)


@pytest.mark.parametrize("merged", [True, False])
def test_quantize_never_touches_sigma(models, merged):
    model = _port(models["singular-merged" if merged else "singular-split"])
    for view in (pq.quantize_params(model), pq.fake_quantize_params(model)):
        for lp, lq in zip(model.layers, view.layers):
            assert torch.equal(lp.ws, lq.ws) and torch.equal(lp.us, lq.us)
            assert not torch.equal(lp.wl, getattr(lq.wl, "q", lq.wl).float())


@pytest.mark.parametrize("family", ["dense", "singular-merged", "singular-split"])
def test_fake_quantize_matches_jax(models, family):
    jmodel = models[family]
    fq = pq.fake_quantize_params(_port(jmodel))
    jfq = jq.fake_quantize_params(jmodel)
    pl, jl = _arrays(fq), jax.tree.leaves(jfq)
    assert len(pl) == len(jl)
    for p, j in zip(pl, jl):
        np.testing.assert_allclose(p, np.asarray(j), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("family", ["reduced-merged", "reduced-split"])
def test_fake_quantize_reduced_matches_jax_and_the_artifact(models, family):
    """The view's layers are the artifact's encoding (the port's own
    quantize_params, bit-equal to the JAX package's) and JAX's view, up to
    the float32 re-solve of C."""
    jmodel = models[family]
    model = _port(jmodel)
    fq = pq.fake_quantize_params(model)
    art = to_tensor_tree(pq.dequantize_params(pq.quantize_params(model)))
    jfq = jq.fake_quantize_params(jmodel)
    for lf, la, lj in zip(fq.layers, art.layers, jfq.layers):
        for f, a, j in zip(_arrays(lf), _arrays(la), jax.tree.leaves(lj)):
            np.testing.assert_allclose(f, a, rtol=QAT_TOL, atol=QAT_TOL)
            np.testing.assert_allclose(f, np.asarray(j), rtol=QAT_TOL, atol=QAT_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_ste_gradient_matches_jax(models, family, x):
    """qat_apply's gradients reach the float32 master weights as the
    straight-through identity: jax.grad's, and the gradient of the forward
    evaluated at the encoded point."""
    jmodel = models[family]
    kind = family.split("-")[0]
    model = _port(jmodel)
    x = x[:, :8]
    apply_fn = {"dense": P.stacked_lstm_apply, "singular": P.singular_lstm_apply,
                "reduced": P.reduced_lstm_apply}[kind]
    loss = (pq.qat_apply(apply_fn)(model, torch.tensor(x)) ** 2).sum()
    grads = torch.autograd.grad(loss, _tree_leaves(model))
    jgrads = jax.jit(jax.grad(
        lambda p: jnp.sum(jq.qat_apply(JAX_APPLY[kind])(p, jnp.asarray(x)) ** 2)))(jmodel)
    for g, j in zip(grads, jax.tree.leaves(jgrads)):
        tol = QAT_TOL if kind == "reduced" else ATOL
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-3, atol=tol)
    # identity: the gradient at the encoded point, taken on a model holding it
    enc = P.from_numpy_tree(P.to_numpy_tree(pq.fake_quantize_params(model)), device="cpu")
    egrads = torch.autograd.grad((apply_fn(enc, torch.tensor(x)) ** 2).sum(), _tree_leaves(enc))
    for g, e in zip(grads, egrads):
        np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-5, atol=1e-6)


def test_fake_quantize_refuses_a_quantized_tree(models):
    with pytest.raises(ValueError, match="master"):
        pq.fake_quantize_params(pq.quantize_params(_port(models["dense"])))


def test_qat_fit_reduces_the_artifact_loss(models):
    """fit with apply_fn=qat_apply(...) trains the float32 master weights and
    lowers the quantized view's loss (the JAX test's property, through the
    port's own training loop)."""
    model = _port(models["reduced-split"])
    rng = np.random.default_rng(2)
    xb = rng.normal(size=(8, 12, 6)).astype(np.float32)
    yb = rng.normal(size=(8,)).astype(np.float32)
    qat = pq.qat_apply(P.reduced_lstm_apply)
    cfg = P.TrainConfig(epochs=20, batch_size=8, learning_rate=1e-2)
    result = P.fit(model, None, None, cfg, apply_fn=qat, windows=(xb, yb))
    assert isinstance(result.params, P.ReducedLSTM)
    assert all(p.dtype == torch.float32 for p in result.params.parameters())

    def loss(m):
        with torch.no_grad():
            return float(((qat(m, torch.tensor(xb), return_sequences=False)[..., 0]
                           - torch.tensor(yb)) ** 2).mean())

    assert loss(result.params) < loss(model)
    assert result.history[-1] < result.history[0]


@pytest.mark.parametrize("family", ["dense", "reduced-split", "reduced-merged"])
def test_quantized_checkpoints_cross_the_packages(tmp_path, models, family):
    """A quantized .npz written by either package loads in the other with q
    bit-equal (and in the port onto the asked device)."""
    jmodel = models[family]
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_params(jpath, jq.quantize_params(jmodel))
    P.save_params(ppath, pq.quantize_params(_port(jmodel)))
    from_jax = P.load_params(jpath, device="cpu")
    assert isinstance(from_jax.layers[0].b, torch.Tensor)
    _same_quantized(from_jax, jckpt.load_params(jpath))
    _same_quantized(P.load_params(ppath, device="cpu"), jckpt.load_params(ppath))
    _same_quantized(from_jax, jckpt.load_params(ppath))


def test_quantized_checkpoint_loads_onto_the_card_by_default(tmp_path, models):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = str(tmp_path / "q.npz")
    jckpt.save_params(path, jq.quantize_params(models["dense"]))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        P.load_params(path)


def test_int8_checkpoint_of_the_committed_model_loads(tmp_path):
    """The 3x512 recovered checkpoint quantized by the JAX package loads in
    the port bit-equal (load only: no scan at this width)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "model_saves", "wide_r24_progressive.npz")
    jpath = str(tmp_path / "model_int8.npz")
    jckpt.save_params(jpath, jq.quantize_params(jckpt.load_params(path)))
    q = P.load_params(jpath, device="cpu")
    _same_quantized(q, jckpt.load_params(jpath))
    assert pq.param_bytes(q) < 0.35 * pq.param_bytes(P.load_params(path, device="cpu"))


def test_conv_hybrids_raise_by_item():
    from svd_lstm_tpu.models.conv import init_conv_lstm

    conv = init_conv_lstm(jax.random.PRNGKey(0), units=(4,))
    for fn in (pq.quantize_params, pq.fake_quantize_params, pq.param_bytes):
        with pytest.raises(NotImplementedError, match="item 7"):
            fn(conv)


@settings(max_examples=25, deadline=None)
@given(rows=st_h.integers(1, 20), cols=st_h.integers(1, 20), seed=st_h.integers(0, 2**31 - 1))
def test_int8_quantization_error_bound(rows, cols, seed):
    """|w - q·s| <= s/2 + 4·eps32·max|w|: half a grid step, plus the float32
    rounding of w / s and of q·s (ROADMAP fault 2)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(rows, cols)) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    t = pq.quantize_tensor(torch.tensor(w))
    err = np.abs(pq.dequantize_tensor(t).numpy().astype(np.float64) - w)
    scale = t.scale.numpy().astype(np.float64)
    bound = scale / 2 + 4 * np.finfo(np.float32).eps * np.abs(w).max(axis=0, keepdims=True)
    assert (err <= bound).all()
