"""The port's sharded train steps and batched inference
(``svd_lstm_tpu_torch/parallel/train.py``) against the JAX package's on the
CPU.

The port runs SPMD on gloo ranks spawned once a world size for the file:
two ranks for the dp × tp meshes 2 × 1 and 1 × 2 and for dp = 2, four for
2 × 2 (``tests/torch_parallel_cases.py``); every rank must return the same.
The JAX side runs the same functions on meshes of the same shapes cut from
the 8 virtual CPU devices of ``tests/conftest.py``. Inputs are seeded port
models, carried to the JAX package through the ``.npz`` format.

Tolerances, the JAX package's own (tests/test_parallel.py,
tests/test_parallel_fit.py): a step's loss rtol 1e-4 against the unsharded
loss and against the JAX step at the same mesh, the parameters after it
atol 1e-5; the dp fine-tune step's losses rtol 1e-5 and parameters atol
1e-5 over three steps; batched exact inference atol 1e-5 against the JAX
forward, and the fast batch bit-equal to the unsharded fast forward and
within tests/test_torch_batched.py's band (relative Frobenius error 2e-2
with a 128-wide layer) of the exact one.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import svd_lstm_tpu_torch as P
import torch_parallel_cases as tc
from svd_lstm_tpu.config import FactorConfig as JFactorConfig
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.models.lstm import stacked_lstm_apply as j_dense_apply
from svd_lstm_tpu.models.reduced import reduced_lstm_apply as j_reduced_apply
from svd_lstm_tpu.parallel import train as jtrain
from svd_lstm_tpu.parallel.mesh import make_mesh as j_make_mesh
from svd_lstm_tpu_torch import parallel as par
from svd_lstm_tpu_torch.ops.cuda_batched import batched_forward_fast

MESHES = [(2, 1), (1, 2), (2, 2)]
LR = 1e-3


def _batch():
    """tests/test_parallel.py's batch: x (16, 30, 8), y (16,)."""
    rng = np.random.default_rng(0)
    return (rng.normal(size=(16, 30, 8)).astype(np.float32),
            rng.normal(size=(16,)).astype(np.float32))


@pytest.fixture(scope="module")
def models():
    init, g = P.init_stacked_lstm, tc.seeded
    return {
        "step": init(g(1), 8, (8, 8), device="cpu"),
        "singular": P.make_singular_model(init(g(2), 8, (8, 8), device="cpu"), merged_kernel=False),
        "batched": init(g(4), 8, (8,), device="cpu"),
        "batched_reduced": P.make_reduced_model(P.make_singular_model(init(g(5), 8, (8, 8), device="cpu")),
                                                rank=8),
        "fast": init(g(5), 8, (128, 8), device="cpu"),
    }


def _jax(model, tmp_path, name="m.npz"):
    path = str(tmp_path / name)
    P.save_params(path, model)
    return jckpt.load_params(path)


def _leaves(model):
    return [p.detach().numpy() for p in model.parameters()]


def _jax_leaves(jparams):
    return _leaves(P.from_numpy_tree(jparams, device="cpu"))


def _same_on_every_rank(results: list) -> dict:
    for r in results[1:]:
        for key, got in r.items():
            want = results[0][key]
            if isinstance(got, dict):
                for a, b in zip(got["params"], want["params"]):
                    np.testing.assert_array_equal(a, b, err_msg=key)
                got, want = got.get("losses", got.get("history")), want.get("losses", want.get("history"))
            np.testing.assert_array_equal(got, want, err_msg=key)
    return results[0]


@pytest.fixture(scope="module")
def ranks(models):
    x, y = _batch()
    m = models
    fcfg = P.FactorConfig(hoyer=0.01)
    two = [(f"sharded_{dp}x{tp}", (dp, tp), "sharded_step", (m["step"], x, y, LR, 1))
           for dp, tp in MESHES[:2]]
    two += [
        ("dp_step", (2, 1), "dp_step", (m["step"], x, y, LR, 1)),
        ("dp_finetune", (2, 1), "dp_finetune_step", (m["singular"], x, y, fcfg, LR, 3)),
        ("batched", (2, 1), "batched", (m["batched"], x)),
        ("batched_reduced", (2, 1), "batched", (m["batched_reduced"], x)),
        ("batched_fast", (2, 1), "batched_fast", (m["fast"], x)),
        ("indivisible", (2, 1), "batched", (m["batched"], x[:15])),
    ]
    out = _same_on_every_rank(par.launch(tc.run_cases, 2, "gloo", "cpu", two))
    four = [("sharded_2x2", (2, 2), "sharded_step", (m["step"], x, y, LR, 1))]
    out.update(_same_on_every_rank(par.launch(tc.run_cases, 4, "gloo", "cpu", four)))
    return out


def test_indivisible_batch_raises(ranks):
    assert "not divisible by 2" in ranks["indivisible"]


@pytest.mark.parametrize("dp,tp", MESHES, ids=[f"{dp}x{tp}" for dp, tp in MESHES])
def test_sharded_step_matches_jax_and_unsharded(ranks, models, dp, tp, tmp_path):
    """One dp × tp Adam step: its loss against the unsharded forward's and
    the JAX step's at the same mesh, the parameters after it (gathered back
    to the Keras layout) against the JAX step's."""
    x, y = _batch()
    got = ranks[f"sharded_{dp}x{tp}"]
    with torch.no_grad():
        pred = P.stacked_lstm_apply(models["step"], torch.tensor(x), return_sequences=False)[..., 0]
    ref = float(torch.mean(torch.square(pred - torch.tensor(y))))
    assert got["losses"][0] == pytest.approx(ref, rel=1e-4)
    mesh = j_make_mesh(dp=dp, tp=tp)
    opt = optax.adam(LR)
    sharded = jtrain.shard_params_for_mesh(_jax(models["step"], tmp_path), mesh)
    params, _, loss = jtrain.make_sharded_train_step(mesh, opt)(sharded, opt.init(sharded),
                                                                  jnp.asarray(x), jnp.asarray(y))
    assert got["losses"][0] == pytest.approx(float(loss), rel=1e-4)
    for a, b in zip(got["params"], _jax_leaves(jtrain.unshard_params_from_mesh(params, tp))):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_tp_local_slices_are_the_gate_columns(models):
    """shard_layer_tp's slice: columns [s·n/tp, (s+1)·n/tp) of each gate
    block, as the JAX package's."""
    from svd_lstm_tpu.models.lstm import LSTMLayerParams

    layer = models["step"].layers[0]
    jlayer = LSTMLayerParams(*(t.detach().numpy() for t in (layer.W, layer.U, layer.b)))
    for s in (0, 1):
        got = par.shard_layer_tp(layer, 2, s)
        want = jtrain.shard_layer_tp(jlayer, 2, s)
        for a, b in zip((got.W, got.U, got.b), want):
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_dp_step_matches_the_sharded_step(ranks):
    """The generic dp step on the dense model and the dedicated dp × tp step
    at tp = 1: the same math through two paths."""
    got, want = ranks["dp_step"], ranks["sharded_2x1"]
    assert got["losses"][0] == pytest.approx(want["losses"][0], rel=1e-5)
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_dp_finetune_step_matches_jax(ranks, models, tmp_path):
    """Three dp singular fine-tune steps (σ-only Adam, Hoyer in the loss)
    against the JAX package's at dp = 2; σ moved, the factors did not."""
    x, y = _batch()
    got = ranks["dp_finetune"]
    step, state = jtrain.make_dp_finetune_step(j_make_mesh(dp=2, tp=1),
                                               _jax(models["singular"], tmp_path),
                                               JFactorConfig(hoyer=0.01), LR)
    p = _jax(models["singular"], tmp_path)
    for i in range(3):
        p, state, loss = step(p, state, jnp.asarray(x), jnp.asarray(y))
        assert got["losses"][i] == pytest.approx(float(loss), rel=1e-5), f"step {i}"
    for a, b in zip(got["params"], _jax_leaves(p)):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    start = models["singular"].layers[0]
    names = [n for n, _ in models["singular"].named_parameters()]
    assert not np.allclose(got["params"][names.index("layers.0.ws")], start.ws.detach().numpy())
    np.testing.assert_array_equal(got["params"][names.index("layers.0.wl")], start.wl.detach().numpy())


@pytest.mark.parametrize("name,apply", [("batched", j_dense_apply), ("batched_reduced", j_reduced_apply)])
def test_batched_inference_matches_jax(ranks, models, tmp_path, name, apply):
    x, _ = _batch()
    want = np.asarray(apply(_jax(models[name], tmp_path), jnp.asarray(x), return_sequences=True))
    np.testing.assert_allclose(ranks[name], want, atol=1e-5, rtol=0)


def test_batched_fast_inference(ranks, models, tmp_path):
    """Each rank's rows through the fast batched forward (K5's route): the
    unsharded fast forward's values, within the fast band of the exact
    JAX forward."""
    x, _ = _batch()
    got = ranks["batched_fast"]
    np.testing.assert_array_equal(got, batched_forward_fast(models["fast"], torch.tensor(x)).numpy())
    exact = np.asarray(j_dense_apply(_jax(models["fast"], tmp_path), jnp.asarray(x), return_sequences=True))
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) <= 2e-2
