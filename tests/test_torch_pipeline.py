"""The port's pipeline-parallel whole-run inference
(``svd_lstm_tpu_torch/parallel/pipeline.py``) against the JAX package's on
the CPU.

Two gloo ranks, spawned once for the file, run S = 2 stages of the
wavefront over small chunks (``tests/torch_parallel_cases.py``); the JAX
side runs ``make_pipeline_inference`` with the same stages and chunk
length on a mesh of the 8 virtual CPU devices (tests/test_pipeline.py's).
Both ranks must return the same. Batch-1 runs carry each layer's state
from chunk to chunk through the batch-1 kernels' wrappers with
``return_c`` (their plain versions on CPU tensors), larger batches through
the plain scan. Inputs are seeded port models, carried to the JAX package
through the ``.npz`` format.

Tolerance: atol 1e-5 against the JAX pipeline and against the port's own
unsharded forward (tests/test_pipeline.py's bound for the reduced family).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
import torch_parallel_cases as tc
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.parallel.mesh import make_mesh as j_make_mesh
from svd_lstm_tpu.parallel.pipeline import make_pipeline_inference as j_pipeline
from svd_lstm_tpu_torch import parallel as par

ATOL = 1e-5


def _reduced(seed, d, units, merged, rank=None, cutoff=None):
    dense = P.init_stacked_lstm(tc.seeded(seed), d, units, device="cpu")
    return P.make_reduced_model(P.make_singular_model(dense, merged_kernel=merged), cutoff=cutoff,
                                rank=rank)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# name: (model, x, n_stages, ct, return_sequences)
CASES = {
    "dense_pad": (lambda: P.init_stacked_lstm(tc.seeded(1), 5, (8, 8, 8, 8), device="cpu"),
                  (2, 37, 5), 2, 10, True),
    "dense_batch1": (lambda: P.init_stacked_lstm(tc.seeded(2), 8, (8, 8), device="cpu"),
                     (1, 64, 8), 2, 16, True),
    "dense_last": (lambda: P.init_stacked_lstm(tc.seeded(3), 5, (8, 8), device="cpu"),
                   (3, 21, 5), 2, 8, False),
    "dense_batch1_last": (lambda: P.init_stacked_lstm(tc.seeded(4), 8, (8,) * 4, device="cpu"),
                          (1, 30, 8), 2, 6, False),
    "merged": (lambda: _reduced(10, 5, (8, 8, 8, 8), True, rank=5), (2, 37, 5), 2, 10, True),
    "merged_batch1": (lambda: _reduced(12, 8, (8, 8), True, rank=5), (1, 40, 8), 2, 12, True),
    "split_batch1": (lambda: _reduced(11, 8, (8, 8), False, cutoff=0.5), (1, 64, 8), 2, 16, True),
}


@pytest.fixture(scope="module")
def inputs():
    return {name: (make(), _x(i, shape), S, ct, seq)
            for i, (name, (make, shape, S, ct, seq)) in enumerate(CASES.items())}


@pytest.fixture(scope="module")
def ranks(inputs):
    cases = [(name, (2, 1), "pipeline", (m, x, S, ct, seq)) for name, (m, x, S, ct, seq) in inputs.items()]
    cases += [("three_layers", (2, 1), "pipeline",
               (P.init_stacked_lstm(tc.seeded(5), 5, (8, 8, 8), device="cpu"), _x(0, (1, 9, 5)), 2, 4)),
              ("nonuniform", (2, 1), "pipeline",
               (P.init_stacked_lstm(tc.seeded(5), 5, (8, 16), device="cpu"), _x(0, (1, 9, 5)), 2, 4)),
              ("too_many_stages", (2, 1), "pipeline",
               (inputs["dense_batch1"][0], _x(0, (1, 9, 8)), 4, 4))]
    r0, r1 = par.launch(tc.run_cases, 2, "gloo", "cpu", cases)
    for key, got in r0.items():
        np.testing.assert_array_equal(got, r1[key], err_msg=key)
    return r0


def test_split_fixture_has_uneven_ranks(inputs):
    """The cutoff truncation gives different ranks per gate and per layer,
    which the JAX package pads to one stacked shape and the port does not."""
    ranks = {r for l in inputs["split_batch1"][0].layers for side in l.ranks for r in side}
    assert len(ranks) > 1


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax_and_unsharded(ranks, inputs, name, tmp_path):
    model, x, S, ct, seq = inputs[name]
    got = ranks[name]
    with torch.no_grad():
        want = model(torch.tensor(x), return_sequences=seq).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    path = str(tmp_path / "m.npz")
    P.save_params(path, model)
    run = j_pipeline(j_make_mesh(dp=4, tp=2), n_stages=S, ct=ct, return_sequences=seq)
    np.testing.assert_allclose(got, np.asarray(run(jckpt.load_params(path), jnp.asarray(x))),
                               atol=ATOL, rtol=0)


def test_pipeline_rejects_indivisible_and_nonuniform_stacks(ranks):
    assert "3 layers do not split into 2 stages" in ranks["three_layers"]
    assert "uniform units" in ranks["nonuniform"]
    assert "n_stages 4 exceeds 2 devices" in ranks["too_many_stages"]
