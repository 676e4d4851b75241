"""The port's post-truncation recovery (``ops/reduced_train.py``,
``finetune_reduced``, ``recover_reduced_gated``,
``truncate_recover_progressive``, ``predict_full_run``, ``harvest_sigmas``)
against the JAX package on the CPU.

Both packages get the same truncated model (the JAX package's, converted)
and the same windows. On the CPU the port's ``recurrence_kernel=True`` path
runs the train kernels' plain versions (K7 below B = 128, K8 from it), the
JAX one its Pallas kernels in interpret mode.

Tolerances: the dense view within 1e-6 (the JAX tests' own) plus each
entry's float32 rounding bound (a dot of length r summed in another order,
over C factors whose entries reach tens); gradients of
the view path against autograd of the two-step scan within 2e-5 (the JAX
package's tests/test_reduced_train.py); loss histories rtol 1e-5 and final
parameters atol 2e-6 (as tests/test_torch_train.py); the gate's validation
MSEs rtol 1e-4, because they are read after whole epochs of training whose
float32 gradients differ in their last bits between the packages, and its
decisions (rate, accepted) exactly. The gate's ``val_mse`` key is the JAX
package's: the MSE of ``validation``, by default the training half (ROADMAP
fault 3.4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu import config as jcfg
from svd_lstm_tpu.factor.svd import make_reduced_model as jax_make_reduced
from svd_lstm_tpu.factor.svd import make_singular_model as jax_make_singular
from svd_lstm_tpu.models.lstm import init_stacked_lstm as jax_init
from svd_lstm_tpu.models.reduced import reduced_lstm_apply as jax_reduced_apply
from svd_lstm_tpu.ops.reduced_train import reduced_dense_view as jax_view
from svd_lstm_tpu.train import finetune as jft
from svd_lstm_tpu.train.loop import fit as jax_fit
from svd_lstm_tpu.train.loop import predict_full_run as jax_predict_full_run
from svd_lstm_tpu_torch import config as pcfg
from svd_lstm_tpu_torch.ops import cuda_train as ct
from svd_lstm_tpu_torch.ops.layouts import reconstruct_dense_model
from svd_lstm_tpu_torch.ops.reduced_train import reduced_dense_view, reduced_lstm_apply_fast_train
from svd_lstm_tpu_torch.train.finetune import ClippedAdam
from svd_lstm_tpu_torch.train.loop import default_apply_fn, resolve_train_apply_fn

VIEW = dict(atol=1e-6, rtol=0)
GRAD = dict(atol=2e-5, rtol=0)
HIST = dict(rtol=1e-5, atol=0)
PARAMS = dict(atol=2e-6, rtol=0)
GATE = dict(rtol=1e-4, atol=0)


def _reduced_jax(merged: bool, units=(12, 12), d=8, rank=8, cutoff=None, seed=3):
    dense = jax_init(jax.random.PRNGKey(seed), input_dim=d, units=units)
    return jax_make_reduced(jax_make_singular(dense, merged_kernel=merged), cutoff=cutoff,
                            rank=None if cutoff is not None else rank)


def _leaves_close(port_model, jax_params, tol=PARAMS):
    for a, b in zip(jax.tree.leaves(P.to_numpy_tree(port_model)), jax.tree.leaves(jax_params)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


@pytest.fixture(scope="module")
def tiny_run():
    """The JAX package's gate tests' run (tests/test_train_extras.py)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 4)).astype(np.float32)
    kernel = np.exp(-np.arange(10) / 4.0)
    y = np.convolve(x[:, 0], kernel / kernel.sum(), mode="same").astype(np.float32)
    return x[None], y


def _gate_cfg(module, epochs=1, **kw):
    return module.TrainConfig(num_windows=64, window_len=20, batch_size=8, seed=0, epochs=epochs, **kw)


@pytest.fixture(scope="module")
def tiny_dense(tiny_run):
    """A briefly trained 2×8 stack: its truncations have real damage to repair."""
    X, y = tiny_run
    return jax_fit(jax_init(jax.random.PRNGKey(1), 4, (8, 8)), X, y, _gate_cfg(jcfg, epochs=3)).params


# ---------------------------------------------------------------------------
# the differentiable dense view
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["merged", "split", "split-uneven"])
def test_dense_view_matches_jax(case):
    """Per-gate ranks differ after a cutoff truncation: each gate's own (B, C)
    widths must stay in place."""
    rj = _reduced_jax(case == "merged", cutoff=0.9 if case == "split-uneven" else None)
    if case == "split-uneven":
        assert len({B.shape[1] for l in rj.layers for B in l.wB + l.uB}) > 1
    model = P.from_numpy_tree(rj, device="cpu")
    view, want = reduced_dense_view(model), jax_view(rj)
    rec = reconstruct_dense_model(model)
    # each entry is a dot of length r summed in another order than XLA's:
    # 1e-6 plus the float32 rounding bound r·2⁻²⁴·(|B|·[I | |C|]), for C's
    # entries reach tens here and their products cancel
    bound = reconstruct_dense_model(P.from_numpy_tree(jax.tree.map(np.abs, rj), device="cpu"))
    r = max(rank for l in model.layers for side in l.ranks for rank in side)
    for lv, lj, lr, lb in zip(view.layers, want.layers, rec.layers, bound.layers):
        for f in ("W", "U", "b"):
            got = getattr(lv, f).detach().numpy()
            tol = VIEW["atol"] + r * 2.0 ** -24 * getattr(lb, f).detach().numpy()
            assert np.all(np.abs(got - np.asarray(getattr(lj, f))) <= tol), f
            assert torch.equal(getattr(lv, f).detach(), getattr(lr, f).detach()), f  # one column order
        assert lv.W.requires_grad and lv.U.requires_grad


@pytest.mark.parametrize("batch", [8, 128], ids=["K7", "K8"])
@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
def test_view_gradients_match_autograd_of_the_scan(merged, batch):
    """Every (B, C) factor, b and the head: the kernel path's gradients (the
    plain versions of K7 / K8 here) against autograd of the two-step scan."""
    model = P.from_numpy_tree(_reduced_jax(merged), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(batch, 6, 8)).astype(np.float32))
    y = torch.tensor(rng.normal(size=(batch,)).astype(np.float32))
    launched = []
    for fn in (reduced_lstm_apply_fast_train, P.reduced_lstm_apply):
        model.zero_grad()
        loss = torch.mean((fn(model, x, return_sequences=False)[..., 0] - y) ** 2)
        loss.backward()
        launched.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in launched[1].items():
        np.testing.assert_allclose(launched[0][name].numpy(), g.numpy(), err_msg=name, **GRAD)


def test_apply_routes_reduced_models():
    """fit's kernel swap takes the reduced view; default_apply_fn knows reduced models."""
    model = P.from_numpy_tree(_reduced_jax(True), device="cpu")
    assert default_apply_fn(model) is P.reduced_lstm_apply
    fn, used = resolve_train_apply_fn(pcfg.TrainConfig(recurrence_kernel=True), P.reduced_lstm_apply)
    assert used and fn is reduced_lstm_apply_fast_train


# ---------------------------------------------------------------------------
# finetune_reduced
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    from svd_lstm_tpu_torch.data.dropbear import preprocess_raw
    from svd_lstm_tpu_torch.data.synthetic import synthetic_dropbear_raw

    return preprocess_raw(synthetic_dropbear_raw(duration=6.0), pcfg.DataConfig(split_time=4.0))


@pytest.mark.parametrize("kernel,batch,windows_n", [(False, 8, 32), (True, 8, 32), (True, 128, 128)],
                         ids=["scan", "K7", "K8"])
def test_finetune_reduced_matches_jax(data, kernel, batch, windows_n):
    from svd_lstm_tpu_torch.data.batcher import split_train_random

    rj = _reduced_jax(False, units=(8, 8), d=16, rank=4, seed=1)
    windows = split_train_random(data.X_train, data.y_train, windows_n, 12, seed=0)
    kw = dict(num_windows=windows_n, window_len=12, batch_size=batch, recurrence_kernel=kernel,
              epochs=1 if batch == 128 else 2)
    want = jft.finetune_reduced(rj, data.X_train, data.y_train, train_cfg=jcfg.TrainConfig(**kw),
                                windows=windows)
    model = P.from_numpy_tree(rj, device="cpu")
    got = P.finetune_reduced(model, data.X_train, data.y_train, train_cfg=pcfg.TrainConfig(**kw),
                             windows=windows)
    np.testing.assert_allclose(got.history, want.history, **HIST)
    _leaves_close(got.params, want.params)
    # the two-step form is kept: the same ranks, every factor trained
    assert [l.ranks for l in got.params.layers] == [l.ranks for l in model.layers]
    for a, b in zip(model.parameters(), got.params.parameters()):
        assert a.shape == b.shape and not torch.equal(a, b)


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def test_clipped_adam_matches_optax():
    """An element-wise clamp of the gradient, then Adam; its state_dict is
    Adam's and carries the moments into a fresh optimizer."""
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    g1, g2 = (rng.normal(scale=2.0, size=(4, 3)).astype(np.float32) for _ in range(2))
    assert np.abs(g1).max() > 0.5
    opt = optax.chain(optax.clip(0.5), optax.adam(1e-2))
    pj = jnp.asarray(p0)
    state = opt.init(pj)
    t = torch.tensor(p0, requires_grad=True)
    topt = ClippedAdam([t], lr=1e-2, clip=0.5)
    for i, g in enumerate((g1, g2)):
        upd, state = opt.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        t.grad = torch.tensor(g)
        topt.step()
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)
        if i == 0:  # move on from the state_dict, as the gate's next one-epoch fit does
            sd = topt.state_dict()
            assert set(sd["state"][0]) == {"step", "exp_avg", "exp_avg_sq"}
            topt = ClippedAdam([t], lr=1e-2, clip=0.5)
            topt.load_state_dict(sd)


def _trace_close(got, want):
    assert [t["lr"] for t in got["trace"]] == [t["lr"] for t in want["trace"]]
    assert [t["accepted"] for t in got["trace"]] == [t["accepted"] for t in want["trace"]]
    for a, b in zip(got["trace"], want["trace"]):
        if b["accepted"]:
            np.testing.assert_allclose(a["val_mse"], b["val_mse"], **GATE)
    for k in ("raw_val_mse", "best_val_mse"):
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GATE)
    for k in ("recipe", "lr_ladder", "clip", "max_epochs", "gate", "accepted_epochs"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("ladder,clip,kernel", [((50.0, 1e-2), 1e9, False), ((3e-3,), 0.5, True)],
                         ids=["diverge-then-backoff", "stable-kernel"])
def test_recover_reduced_gated_matches_jax(tiny_run, tiny_dense, ladder, clip, kernel):
    """The first ladder starts at a rate that diverges: epoch 0 is rejected
    in both packages, the gate rolls back and steps down. The second trains
    at a stable rate through the train kernels (K7's plain version here,
    Pallas in interpret mode there)."""
    X, y = tiny_run
    rj = jax_make_reduced(jax_make_singular(tiny_dense, merged_kernel=True), cutoff=None, rank=2)
    kw = dict(lr_ladder=ladder, clip=clip, max_epochs=3)
    out_j, info_j = jft.recover_reduced_gated(rj, X, y, train_cfg=_gate_cfg(jcfg, recurrence_kernel=kernel),
                                              **kw)
    out, info = P.recover_reduced_gated(P.from_numpy_tree(rj, device="cpu"), X, y,
                                        train_cfg=_gate_cfg(pcfg, recurrence_kernel=kernel), **kw)
    _trace_close(info, info_j)
    if ladder[0] == 50.0:
        assert info["trace"][0]["accepted"] is False
    else:
        assert info["accepted_epochs"] >= 1
    assert info["best_val_mse"] <= info["raw_val_mse"]
    _leaves_close(out, out_j, dict(atol=1e-4, rtol=0))


def test_truncate_recover_progressive_matches_jax(tiny_run, tiny_dense):
    X, y = tiny_run
    kw = dict(ranks=(4, 2), lr_ladder=(3e-3,), max_epochs=2)
    rj, infos_j = jft.truncate_recover_progressive(tiny_dense, X, y, train_cfg=_gate_cfg(jcfg), **kw)
    dense = P.from_numpy_tree(tiny_dense, device="cpu")
    rmod, infos = P.truncate_recover_progressive(dense, X, y, train_cfg=_gate_cfg(pcfg), **kw)
    assert [i["rank"] for i in infos] == [i["rank"] for i in infos_j] == [4, 2]
    for got, want in zip(infos, infos_j):
        _trace_close(got, want)
        assert got["best_val_mse"] <= got["raw_val_mse"]
    assert {r for l in rmod.layers for side in l.ranks for r in side} == {2}
    np.testing.assert_allclose(P.predict_full_run(rmod, X, P.reduced_lstm_apply),
                               jax_predict_full_run(rj, X, jax_reduced_apply), atol=1e-4)
    with pytest.raises(ValueError, match="descending"):
        P.truncate_recover_progressive(dense, X, y, ranks=(2, 4))


# ---------------------------------------------------------------------------
# predict_full_run, harvest_sigmas
# ---------------------------------------------------------------------------

def test_predict_full_run_matches_jax(tiny_run, tiny_dense):
    X, _ = tiny_run
    np.testing.assert_allclose(P.predict_full_run(P.from_numpy_tree(tiny_dense, device="cpu"), X),
                               jax_predict_full_run(tiny_dense, X), atol=1e-5)
    rj = _reduced_jax(False, units=(8, 8), d=4, rank=3)
    got = P.predict_full_run(P.from_numpy_tree(rj, device="cpu"), X, P.reduced_lstm_apply)
    assert got.shape == (X.shape[1],)
    np.testing.assert_allclose(got, jax_predict_full_run(rj, X, jax_reduced_apply), atol=1e-5)


def test_harvest_sigmas_matches_jax(tiny_dense):
    sj = jax_make_singular(tiny_dense, merged_kernel=False)
    got, want = P.harvest_sigmas(P.from_numpy_tree(sj, device="cpu")), jft.harvest_sigmas(sj)
    assert len(got) == len(want)
    for (ws, us), (wsj, usj) in zip(got, want):
        np.testing.assert_array_equal(ws, wsj)
        np.testing.assert_array_equal(us, usj)


def test_recovery_launches_nothing_on_cpu(tiny_run):
    before = [k.launches for k in ct.KERNELS]
    X, y = tiny_run
    P.finetune_reduced(P.from_numpy_tree(_reduced_jax(True, units=(8,), d=4, rank=3), device="cpu"), X, y,
                       train_cfg=_gate_cfg(pcfg, recurrence_kernel=True))
    assert [k.launches for k in ct.KERNELS] == before
