"""The parallel entry points on the card at world size 1 (one rank in this
process, NCCL), against the single-device paths they shard, and the final-c
output of K3 and K2 that the pipeline's stages carry between chunks.

Every test needs a CUDA card and skips without one. On a machine with a
card (``tests/conftest.py`` imports JAX, which the card's machine lacks):

    python -m pytest tests/test_torch_parallel_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu_torch import parallel as par
from svd_lstm_tpu_torch.ops import cuda_batched as cb
from svd_lstm_tpu_torch.ops import cuda_lstm as ck
from svd_lstm_tpu_torch.parallel.mesh import process_group

pytestmark = pytest.mark.cuda
TOL = 5e-4  # the batch-1 kernels against their plain versions over long runs (chip_smoke.py)


@pytest.fixture()
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    with process_group("nccl"):
        yield par.make_mesh(device="cuda")


def _seeded(units, d=16, seed=0):
    return P.init_stacked_lstm(torch.Generator().manual_seed(seed), d, units, device="cuda")


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, 2000, 16)).astype(np.float32), rng.normal(size=(2000,)).astype(np.float32))


@pytest.mark.parametrize("kernel", [False, True], ids=["scan", "kernel"])
def test_fit_dp_at_one_rank_is_fit(mesh, kernel):
    X, y = _data()
    cfg = P.TrainConfig(num_windows=64, window_len=50, batch_size=32, epochs=2, recurrence_kernel=kernel)
    model = _seeded((40, 40))
    one, dp = P.fit(model, X, y, cfg), par.fit_dp(model, X, y, mesh, cfg=cfg)
    np.testing.assert_allclose(dp.history, one.history, rtol=1e-6, atol=0)


def test_sharded_step_matches_the_dp_step(mesh):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 30, 16)).astype(np.float32)
    y = rng.normal(size=(16,)).astype(np.float32)
    model = _seeded((64, 64))
    local = par.shard_params_for_mesh(model, mesh)
    sharded = par.make_sharded_train_step(mesh, torch.optim.Adam(local.parameters(), lr=1e-3))
    plain = P.init_stacked_lstm(torch.Generator().manual_seed(0), 16, (64, 64), device="cuda")
    dp = par.make_dp_train_step(mesh, torch.optim.Adam(plain.parameters(), lr=1e-3), P.stacked_lstm_apply)
    assert sharded(local, x, y) == pytest.approx(dp(plain, x, y), rel=1e-5)


def test_batched_fast_inference_is_the_fast_forward(mesh):
    model = _seeded((128, 128))
    x = torch.tensor(np.random.default_rng(2).normal(size=(64, 32, 16)), dtype=torch.float32, device="cuda")
    before = cb.batched_lstm_recurrence.launches
    got = par.make_batched_fast_inference(mesh)(model, x)
    assert cb.batched_lstm_recurrence.launches - before == 2
    torch.testing.assert_close(got, cb.batched_forward_fast(model, x), atol=0, rtol=0)


@pytest.mark.parametrize("family", ["dense", "reduced"])
def test_pipeline_at_one_stage_runs_the_batch1_kernels(mesh, family):
    """Chunks of 128 steps through K3 (K2), each from the (h, c) the chunk
    before left: within the batch-1 limit of the whole-run predict."""
    model = _seeded((128, 128))
    if family == "reduced":
        model = P.make_reduced_model(P.make_singular_model(model, merged_kernel=True), rank=16)
    x = torch.tensor(np.random.default_rng(3).normal(size=(1, 1000, 16)), dtype=torch.float32, device="cuda")
    name = "lstm_recurrence" if family == "dense" else "reduced_recurrence"
    ck.reset_launch_counts()
    got = par.make_pipeline_inference(mesh, ct=128)(model, x)
    assert ck.LAUNCHES[name] == 2 * 8  # two layers, ceil(1000 / 128) chunks
    want = P.predict(model, x[0])
    assert float((got[0] - want).abs().max()) <= TOL


@pytest.mark.parametrize("family", ["dense", "merged", "split"])
def test_batch1_kernels_store_the_final_c(family):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(4)
    dense = P.init_stacked_lstm(gen, 16, (96,), device="cuda")
    l = dense.layers[0]
    xp = (torch.randn((300, 16), generator=gen).cuda() @ l.W + l.b).contiguous()
    h0, c0 = torch.randn(96, device="cuda") * 0.1, torch.randn(96, device="cuda")
    if family == "dense":
        args, kernel, plain = (l.U,), ck.lstm_recurrence, ck.lstm_recurrence_plain
    else:
        r = P.make_reduced_model(P.make_singular_model(dense, merged_kernel=family == "merged"), rank=12)
        rl = r.layers[0]
        args = (tuple(rl.uB), tuple(rl.uC)) if rl.split else (rl.uB, rl.uC)
        kernel, plain = ck.reduced_recurrence, ck.reduced_recurrence_plain
    h, c = kernel(xp, *args, h0, c0, return_c=True)
    hp, cp = plain(xp, *args, h0, c0, return_c=True)
    torch.testing.assert_close(h, hp, atol=1e-4, rtol=0)
    torch.testing.assert_close(c, cp, atol=1e-4, rtol=1e-5)
