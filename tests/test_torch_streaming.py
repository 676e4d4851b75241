"""The port's frame-at-a-time streaming (``svd_lstm_tpu_torch/models/streaming.py``)
against the JAX package's, on the CPU, for every family: ``stream_step``,
``stream_many`` and ``make_stream_fn`` agree with JAX within 1e-5 (the bound
of tests/test_streaming.py), and the state carries across chunks within
1e-6. The CUDA-graph step of ``make_stream_fn`` runs only on the card: phase
8c of ``chip_smoke.py`` holds it to the eager step within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.models import streaming as js
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu_torch.models import streaming as ps

TOL = 1e-5
FAMILIES = ["dense", "singular-merged", "singular-split", "reduced-merged", "reduced-split"]


@pytest.fixture(scope="module")
def models():
    dense = init_stacked_lstm(jax.random.PRNGKey(3), input_dim=6, units=(10, 10))
    out = {"dense": dense}
    for merged in (True, False):
        tag = "merged" if merged else "split"
        out[f"singular-{tag}"] = make_singular_model(dense, merged_kernel=merged)
        out[f"reduced-{tag}"] = make_reduced_model(out[f"singular-{tag}"], rank=4)
    return out


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(4).normal(size=(2, 24, 6)).astype(np.float32)


def _port(jmodel):
    return P.from_numpy_tree(jmodel, device="cpu")


def _jax_steps(jmodel, frames):
    step = jax.jit(js.stream_step)
    state, ys = js.init_stream(jmodel, batch=frames.shape[0]), []
    for t in range(frames.shape[1]):
        y, state = step(jmodel, state, jnp.asarray(frames[:, t]))
        ys.append(np.asarray(y))
    return np.stack(ys, axis=1)


@pytest.fixture(scope="module")
def jax_runs(models, frames):
    return {f: _jax_steps(models[f], frames) for f in FAMILIES}


@pytest.mark.parametrize("family", FAMILIES)
def test_stream_step_matches_jax(models, frames, jax_runs, family):
    model = _port(models[family])
    state = ps.init_stream(model, batch=2)
    assert all(h.shape == (2, 10) and h.device.type == "cpu" for h, _ in state)
    ys = []
    with torch.no_grad():
        for t in range(frames.shape[1]):
            y, state = ps.stream_step(model, state, torch.tensor(frames[:, t]))
            ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), jax_runs[family], atol=TOL, rtol=0)
    # and the whole-run forward of the same model
    want = P.predict(model, torch.tensor(frames), impl="scan")
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), want.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_stream_many_matches_jax_and_carries_state(models, frames, jax_runs, family):
    model = _port(models[family])
    with torch.no_grad():
        full, _ = ps.stream_many(model, ps.init_stream(model, batch=2), torch.tensor(frames))
        a, st = ps.stream_many(model, ps.init_stream(model, batch=2), torch.tensor(frames[:, :10]))
        b, _ = ps.stream_many(model, st, torch.tensor(frames[:, 10:]))
    np.testing.assert_allclose(full.numpy(), jax_runs[family], atol=TOL, rtol=0)
    jfull, _ = jax.jit(js.stream_many)(models[family], js.init_stream(models[family], batch=2),
                                        jnp.asarray(frames))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=TOL, rtol=0)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), full.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("family", FAMILIES)
def test_make_stream_fn_matches_jax(models, frames, family):
    model = _port(models[family])
    fn, state = ps.make_stream_fn(model, batch=2)
    jfn, jstate = js.make_stream_fn(models[family], batch=2)
    for t in range(12):
        y, state = fn(state, torch.tensor(frames[:, t]))
        jy, jstate = jfn(jstate, jnp.asarray(frames[:, t]))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    for (h, c), (jh, jc) in zip(state, jstate):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=TOL, rtol=0)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=TOL, rtol=0)


def test_a_step_never_writes_the_state_it_is_given(models, frames):
    model = _port(models["reduced-split"])
    fn, state0 = ps.make_stream_fn(model, batch=2)
    with torch.no_grad():
        _, s1 = ps.stream_step(model, state0, torch.tensor(frames[:, 0]))
    _, s1f = fn(state0, torch.tensor(frames[:, 0]))
    for (h, c) in state0:
        assert not h.any() and not c.any()
    for (h, c), (hf, cf) in zip(s1, s1f):
        assert torch.equal(h, hf) and torch.equal(c, cf)


def test_conv_hybrids_raise_by_item():
    """Once the conv hybrids' refusal; they stream now: the JAX package's
    state layout (the frame buffer first) and its step's outputs."""
    from svd_lstm_tpu.models.conv import init_conv_lstm

    conv = init_conv_lstm(jax.random.PRNGKey(0), units=(4,))
    model = P.from_numpy_tree(conv, device="cpu")
    frames = np.random.default_rng(0).normal(size=(1, 6, 1)).astype(np.float32)
    state, jstate = ps.init_stream(model), js.init_stream(conv)
    assert [tuple(t.shape) for t in jax.tree.leaves(state)] == [t.shape for t in jax.tree.leaves(jstate)]
    fn, s = ps.make_stream_fn(model)
    for t in range(frames.shape[1]):
        with torch.no_grad():
            y, state = ps.stream_step(model, state, torch.tensor(frames[:, t]))
        yf, s = fn(s, torch.tensor(frames[:, t]))
        jy, jstate = js.stream_step(conv, jstate, jnp.asarray(frames[:, t]))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
        assert torch.equal(y, yf)
