"""The plain reference against the port at tiny sizes on the CPU, the
reference's own weights against the port's, and the import check by whole
top-level module name."""

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.core import cell as cells
from benchmark.core import checks, guard, models
from benchmark.core.weights import seeded_dense
from benchmark.reference import lstm as reference
from benchmark.reference import weights as refw

CPU = torch.device("cpu")
TINY = {"input_dim": 16, "units": [8, 6], "head_dim": 1,
        "forms": {"dense": {"init": "seeded"},
                  "reduced": {"merged": False, "rank": 5},
                  "merged": {"merged": True, "rank": 7}}}


def port_predict(model, x):
    from svd_lstm_tpu_torch import api

    return api.predict(model, x, impl="auto", precision="exact")


@pytest.mark.parametrize("form", ["dense", "reduced", "merged"])
def test_reference_predict_matches_the_port(form):
    x = torch.randn(40, 16, generator=torch.Generator().manual_seed(3))
    model = models.program_model(TINY, form, 11, CPU)
    layers, head = models.reference_weights(TINY, form, 11, CPU)
    ref = reference.predict(layers, head, x[None].double())[0]
    got = port_predict(model, x)
    assert got.shape == ref.shape == (40, 1)
    assert checks.out_err([got.numpy()], ref[None]) < 1e-5
    if form != "dense":  # the truncation is real: the dense weights give another answer
        dense = reference.predict(*models.reference_weights(TINY, "dense", 11, CPU), x[None].double())
        assert checks.out_err([dense[0].numpy()], ref[None]) > 1e-3


@pytest.mark.parametrize("name,form", [("wide_3x512", "dense"), ("wide_3x512", "reduced")])
def test_reference_reads_the_committed_checkpoints_as_the_port_does(name, form):
    from svd_lstm_tpu_torch.ops.layouts import reconstruct_dense_model

    config = cells.load_json(cells.HERE / "configs" / f"{name}.json")
    model = models.program_model(config, form, 0, CPU)
    if form == "reduced":
        model = reconstruct_dense_model(model)
    layers, head = refw.read_checkpoint(cells.checkpoint(config["forms"][form]))
    assert len(layers) == len(model.layers) == 3
    for (W, U, b), l in zip(layers, model.layers):
        for ref, got in ((W, l.W), (U, l.U), (b, l.b)):
            np.testing.assert_allclose(got.detach().double().numpy(), ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(model.head.w.detach().double().numpy(), head[0])


def test_truncate_keeps_the_top_singular_values():
    rng = np.random.default_rng(0)
    W = rng.standard_normal((12, 4 * 10))
    split = refw.truncate(W, 3, merged=False)
    for g in range(4):
        assert np.linalg.matrix_rank(split[:, g * 10:(g + 1) * 10], tol=1e-9) == 3
    merged = refw.truncate(W, 5, merged=True)
    s = np.linalg.svd(W, compute_uv=False)
    np.testing.assert_allclose(np.linalg.svd(merged, compute_uv=False)[:5], s[:5])
    assert np.linalg.norm(W - merged, 2) == pytest.approx(s[5])


def test_seeded_weights_follow_the_seed():
    a, b, c = (seeded_dense(TINY, s, CPU) for s in (5, 5, 6))
    assert torch.equal(a[0][1][1], b[0][1][1]) and not torch.equal(a[0][1][1], c[0][1][1])
    W, U, bias = a[0][0]
    assert W.shape == (16, 32) and U.shape == (8, 32) and W.dtype == torch.float32
    assert torch.equal(bias, torch.cat([torch.zeros(8), torch.ones(8), torch.zeros(16)]))
    assert W.abs().max() <= (6 / (16 + 32)) ** 0.5


def test_tf32_round():
    one = 1.0
    x = torch.tensor([one + 2 ** -12, one + 2 ** -11, one + 2 ** -10, -(one + 2 ** -11), 3.0e-30])
    got = reference.tf32_round(x)
    # 10 mantissa bits: 2^-12 rounds down, a half ulp (2^-11) away from zero
    assert got.tolist() == pytest.approx([1.0, 1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 ** -10), 3.0e-30],
                                         rel=1e-3)
    assert got[0].item() == 1.0 and got[1].item() == 1 + 2 ** -10


def test_train_steps_match_the_port_fit():
    from svd_lstm_tpu_torch.config import TrainConfig
    from svd_lstm_tpu_torch.train import loop

    gen = torch.Generator().manual_seed(4)
    xs, ys = torch.randn(3, 6, 12, 16, generator=gen), torch.randn(3, 6, generator=gen)
    model = models.program_model(TINY, "dense", 2, CPU)
    cfg = TrainConfig(num_windows=6, window_len=12, batch_size=6, epochs=1, learning_rate=1e-2,
                      recurrence_kernel=True, matmul_precision="float32")
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt, losses, grads = None, [], None
    for x, y in zip(xs, ys):
        res = loop.fit(model, None, None, cfg, windows=(x, y), init_opt_state=opt)
        model, opt = res.params, res.opt_state
        losses.append(res.history[0])
        if grads is None:
            grads = {k: opt["state"][i]["exp_avg"] / 0.1 for i, (k, _) in enumerate(model.named_parameters())}
    program = {"losses": losses, "first_grads": grads, "start": start,
               "params": {k: p.detach() for k, p in model.named_parameters()}}
    layers, head = models.reference_weights(TINY, "dense", 2, CPU)
    ref = reference.train_steps(layers, head, list(zip(xs, ys)), 1e-2)
    assert set(ref["params"]) == set(program["params"])
    got = checks.train_numbers(program, ref)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-5 and got["change_gap"] < 1e-4


def _sources(sub: str = ""):
    return sorted((cells.HERE / sub).rglob("*.py"))


def test_no_source_imports_jax_or_the_jax_package():
    assert _sources() and _sources("reference")
    for path in _sources():
        tops = guard.imported_tops(path)
        assert not tops & guard.FORBIDDEN, (path, tops & guard.FORBIDDEN)
    for path in _sources("reference"):
        tops = guard.imported_tops(path)
        assert guard.PROGRAM not in tops and "benchmark" not in tops, path


def test_names_are_compared_whole():
    assert guard.top("svd_lstm_tpu_torch.ops.cuda_lstm") == "svd_lstm_tpu_torch"
    loaded = ["svd_lstm_tpu_torch", "svd_lstm_tpu_torch.api", "jaxtyping", "flaxen", "numpy"]
    assert guard.loaded_forbidden(loaded) == []
    assert guard.loaded_forbidden(loaded + ["svd_lstm_tpu.models", "jaxlib.xla_client", "flax"]) == [
        "flax", "jaxlib", "svd_lstm_tpu"]
    src = Path(__file__)
    assert {"numpy", "pytest", "torch", "benchmark", "pathlib"} <= guard.imported_tops(src)
