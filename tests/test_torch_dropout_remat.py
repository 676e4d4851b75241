"""The port's dropout and chunked-time remat (``models/lstm.py``,
``models/singular.py``, ``models/conv.py``, ``train/loop.py``,
``train/finetune.dropout_apply_fn``) against the JAX package on the CPU.

The two packages draw masks from different generators, so the parity tests
feed the port the JAX package's own masks through the seam the applies
expose (an explicit ``(dp, rdp)`` pair a layer instead of a generator),
drawn in JAX's key order: ``jax.random.split`` once a layer, then
``k_dp, k_rdp``, then ``bernoulli``. A fine-tune gets JAX's per-batch
masks as its default ``jit_epoch=True`` draws them
(``split(fold_in(dropout_rng, epoch), steps)``) in place of ``fit``'s
per-batch generator (``train.loop.batch_generator``).

Tolerances: forwards atol 1e-6 and gradients rtol 1e-5 (of each
gradient's largest |value|): the same float32 arithmetic in another
summation order; loss histories rtol 1e-5 and final parameters atol 2e-6,
the bands of tests/test_torch_train.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu import config as jcfg
from svd_lstm_tpu.factor import svd as jsvd
from svd_lstm_tpu.models import conv as jconv
from svd_lstm_tpu.models import lstm as jlstm
from svd_lstm_tpu.models import singular as jsing
from svd_lstm_tpu.train import finetune as jft
from svd_lstm_tpu.train.loop import fit as jax_fit
from svd_lstm_tpu_torch import config as pcfg
from svd_lstm_tpu_torch.data import batcher as pbatch
from svd_lstm_tpu_torch.data.dropbear import preprocess_raw
from svd_lstm_tpu_torch.data.synthetic import synthetic_dropbear_raw
from svd_lstm_tpu_torch.train import finetune as pft
from svd_lstm_tpu_torch.train import loop as ploop
from svd_lstm_tpu_torch.train.loop import batch_generator, resolve_train_apply_fn

FWD = dict(atol=1e-6, rtol=0)
GRAD_RTOL = 1e-5
HIST = dict(rtol=1e-5, atol=0)
PARAMS = dict(atol=2e-6, rtol=0)
B, T, D, UNITS = 3, 24, 5, (10, 8)
RATES = [(0.3, 0.0), (0.0, 0.25), (0.3, 0.25)]
WIN_T, WIN_N, BATCH = 12, 32, 8


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).normal(size=(B, T, D)).astype(np.float32)


@pytest.fixture(scope="module")
def dense():
    return jax.tree.map(np.asarray, jlstm.init_stacked_lstm(jax.random.PRNGKey(0), input_dim=D, units=UNITS))


@pytest.fixture(scope="module")
def data():
    return preprocess_raw(synthetic_dropbear_raw(duration=6.0), pcfg.DataConfig(split_time=4.0))


@pytest.fixture(scope="module")
def windows(data):
    return pbatch.split_train_random(data.X_train, data.y_train, WIN_N, WIN_T, seed=0)


def jax_layer_masks(key, layers, batch, rates, count):
    """A stack's masks as the JAX applies draw them from ``key``: one key a
    layer, each split into ``k_dp, k_rdp``; None where a rate is 0."""
    masks = []
    for layer, k in zip(layers, jax.random.split(key, len(layers))):
        k_dp, k_rdp = jax.random.split(k)
        pair = []
        for kk, rate, dim in ((k_dp, rates[0], layer.input_dim), (k_rdp, rates[1], layer.units)):
            pair.append(None if rate <= 0 else torch.tensor(np.asarray(
                jsing.dropout_masks(kk, rate, (batch, dim), count, jnp.float32))))
        masks.append(tuple(pair))
    return masks


def check_grads(model, grads_j):
    for (name, p), g in zip(model.named_parameters(), jax.tree.leaves(grads_j)):
        g = np.asarray(g)
        np.testing.assert_allclose(p.grad.numpy(), g, atol=GRAD_RTOL * float(np.abs(g).max()), rtol=0,
                                   err_msg=name)


def jax_run(apply, tree, x):
    """The JAX forward of ``x``, the loss sum(out²) and its gradients, one
    jitted call."""
    def loss(p):
        out = apply(p, jnp.asarray(x))
        return jnp.sum(out ** 2), out

    (value, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(tree)
    return np.asarray(out), float(value), grads


def port_loss_and_grads(model, fn, xt):
    model.zero_grad(set_to_none=True)
    out = fn(model, xt)
    loss = torch.sum(out ** 2)
    loss.backward()
    return out.detach().numpy(), loss.item()


# ---------------------------------------------------------------------------
# the applies with the JAX package's masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rates,remat", [(RATES[0], 0), (RATES[1], 5), (RATES[2], 5)],
                         ids=["dp-scan", "rdp-remat5", "both-remat5"])
def test_dense_layer_matches_jax(dense, x, rates, remat):
    """One dense layer: masks (4, B, d) and (4, B, n), forward and
    gradients of every weight and of the input."""
    key = jax.random.PRNGKey(3)
    layer = dense.layers[0]
    kw = dict(dropout=rates[0], recurrent_dropout=rates[1], remat_chunk=remat)

    def loss_j(p, xx):
        out = jlstm.lstm_layer_apply(p, xx, rng=key, **kw)
        return jnp.sum(out ** 2), out

    (_, out_j), (gp, gx) = jax.jit(jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True))(
        layer, jnp.asarray(x))
    k_dp, k_rdp = jax.random.split(key)
    dp = None if rates[0] <= 0 else torch.tensor(np.asarray(
        jax.random.bernoulli(k_dp, 1 - rates[0], (4, B, D)).astype(jnp.float32) / (1 - rates[0])))
    rdp = None if rates[1] <= 0 else torch.tensor(np.asarray(
        jax.random.bernoulli(k_rdp, 1 - rates[1], (4, B, UNITS[0])).astype(jnp.float32) / (1 - rates[1])))
    m = P.from_numpy_tree(dense, device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    out = P.lstm_layer_apply(m.layers[0], xt, rng=(dp, rdp), **kw)
    torch.sum(out ** 2).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FWD)
    for name, got, want in (("W", m.layers[0].W.grad, gp.W), ("U", m.layers[0].U.grad, gp.U),
                            ("b", m.layers[0].b.grad, gp.b), ("x", xt.grad, gx)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=GRAD_RTOL * float(np.abs(want).max()), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("merged,rates", [(True, RATES[0]), (True, RATES[2]), (False, RATES[1]),
                                          (False, RATES[2])],
                         ids=["merged-dp", "merged-both", "split-rdp", "split-both"])
def test_singular_stack_matches_jax(dense, x, rates, merged):
    """The factorized stack: one mask merged (``dp[0]``), four a gate split,
    the layers' keys split from one; forward and every gradient."""
    key = jax.random.PRNGKey(5)
    sj = jsvd.make_singular_model(dense, merged_kernel=merged)
    kw = dict(dropout=rates[0], recurrent_dropout=rates[1])
    out_j, want, grads = jax_run(lambda p, xx: jsing.singular_lstm_apply(p, xx, rng=key, **kw), sj, x)
    masks = jax_layer_masks(key, sj.layers, B, rates, 1 if merged else 4)
    m = P.from_numpy_tree(sj, device="cpu")
    out, loss = port_loss_and_grads(m, lambda mm, xt: P.singular_lstm_apply(mm, xt, rng=masks, **kw),
                                    torch.tensor(x))
    np.testing.assert_allclose(out, out_j, **FWD)
    np.testing.assert_allclose(loss, want, rtol=1e-6)
    check_grads(m, grads)


def test_conv_singular_matches_jax(x):
    """The conv hybrid's factorized stack behind its front end (which takes
    no dropout), dropout, recurrent dropout and remat together."""
    key = jax.random.PRNGKey(8)
    cj = jconv.init_conv_lstm(jax.random.PRNGKey(2), in_channels=D, filters=6, kernel_size=3, units=(8, 8))
    sj = jsvd.make_conv_singular_model(jax.tree.map(np.asarray, cj), merged_kernel=False)
    kw = dict(dropout=0.2, recurrent_dropout=0.3, remat_chunk=7)
    out_j, want, grads = jax_run(lambda p, xx: jconv.conv_singular_apply(p, xx, rng=key, **kw), sj, x)
    masks = jax_layer_masks(key, sj.inner.layers, B, (0.2, 0.3), 4)
    m = P.from_numpy_tree(sj, device="cpu")
    out, loss = port_loss_and_grads(m, lambda mm, xt: P.conv_singular_apply(mm, xt, rng=masks, **kw),
                                    torch.tensor(x))
    np.testing.assert_allclose(out, out_j, **FWD)
    np.testing.assert_allclose(loss, want, rtol=1e-6)
    check_grads(m, grads)


def test_dropout_without_a_source_raises(dense, x):
    m = P.from_numpy_tree(dense, device="cpu")
    with pytest.raises(ValueError, match="dropout requires an rng"):
        P.lstm_layer_apply(m.layers[0], torch.tensor(x), dropout=0.1)
    with pytest.raises(ValueError, match="dropout requires an rng"):
        P.singular_lstm_apply(P.make_singular_model(m), torch.tensor(x), recurrent_dropout=0.1)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [6, 7, 24], ids=lambda k: f"K{k}")
@pytest.mark.parametrize("family", ["dense", "split"])
def test_remat_equals_the_scan_and_jax(dense, x, K, family):
    """A chunk that divides T (6), one that leaves a tail (7), and K = T,
    which turns it off: the port's remat forward and gradients equal its
    own plain scan's and JAX's remat."""
    if family == "dense":
        tree, japply, papply = dense, jlstm.stacked_lstm_apply, P.stacked_lstm_apply
    else:
        tree = jsvd.make_singular_model(dense, merged_kernel=False)
        japply, papply = jsing.singular_lstm_apply, P.singular_lstm_apply
    out_j, _, grads = jax_run(lambda p, xx: japply(p, xx, remat_chunk=K), tree, x)
    m_plain = P.from_numpy_tree(tree, device="cpu")
    m_remat = P.from_numpy_tree(tree, device="cpu")
    out_p, _ = port_loss_and_grads(m_plain, papply, torch.tensor(x))
    out_r, _ = port_loss_and_grads(m_remat, lambda mm, xt: papply(mm, xt, remat_chunk=K), torch.tensor(x))
    np.testing.assert_allclose(out_r, out_p, **FWD)
    np.testing.assert_allclose(out_r, out_j, **FWD)
    for (name, a), b in zip(m_remat.named_parameters(), m_plain.parameters()):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                   atol=GRAD_RTOL * float(b.grad.abs().max()), rtol=0, err_msg=name)
    check_grads(m_remat, grads)


def test_remat_keeps_fewer_tensors(dense):
    """Under remat autograd keeps the chunks' inputs and boundaries, not
    every step's intermediates: counted by the saved-tensor hooks."""
    m = P.from_numpy_tree(dense, device="cpu")
    xt = torch.tensor(np.random.default_rng(1).normal(size=(2, 64, D)).astype(np.float32))
    counts = {}
    for K in (0, 8):
        n = [0]
        with torch.autograd.graph.saved_tensors_hooks(lambda t: (n.__setitem__(0, n[0] + 1), t)[1],
                                                      lambda t: t):
            P.stacked_lstm_apply(m, xt, remat_chunk=K)
        counts[K] = n[0]
    assert counts[8] * 4 < counts[0], counts


def test_resolver_binds_warns_and_ignores(dense):
    """The stock applies get remat bound; a custom apply warns (JAX's
    meaning); a wrapper that applied the knob passes silently; the kernel
    branch takes the stock dense apply first and ignores remat."""
    cfg = pcfg.TrainConfig(remat_chunk=4)
    for fn in (P.stacked_lstm_apply, P.singular_lstm_apply, P.conv_lstm_apply, P.conv_singular_apply):
        got, used = resolve_train_apply_fn(cfg, fn)
        assert not used and got.func is fn and got.keywords == {"remat_chunk": 4}

    def custom(model, x, return_sequences=True):
        return P.stacked_lstm_apply(model, x, return_sequences)

    with pytest.warns(UserWarning, match="WITHOUT activation rematerialization"):
        assert resolve_train_apply_fn(cfg, custom) == (custom, False)
    wrapper, seed = pft.dropout_apply_fn(pcfg.FactorConfig(dropout=0.1), 0, remat_chunk=4)
    assert wrapper.remat_chunk_applied == 4 and seed == 0 ^ 0x5EED
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_train_apply_fn(cfg, wrapper) == (wrapper, False)
    fn, used = resolve_train_apply_fn(dataclasses.replace(cfg, recurrence_kernel=True), P.stacked_lstm_apply)
    assert used and "remat_chunk" not in fn.keywords
    # with recurrence_kernel a dropout wrapper keeps its scan
    assert resolve_train_apply_fn(dataclasses.replace(cfg, recurrence_kernel=True), wrapper) == (wrapper, False)
    assert pft.dropout_apply_fn(pcfg.FactorConfig(), 0) == (P.singular_lstm_apply, None)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_cfg(module, **kw):
    base = dict(num_windows=WIN_N, window_len=WIN_T, batch_size=BATCH, epochs=1)
    base.update(kw)
    return module.TrainConfig(**base)


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
def test_dropout_finetune_matches_jax(data, windows, merged, monkeypatch):
    """One epoch of a dropout σ fine-tune (with recurrence_kernel, which a
    dropout wrapper does not take: both stay on the scan), the port fed
    JAX's per-batch masks: the JAX ``fit``'s batch i of epoch e draws from
    ``split(fold_in(PRNGKey(seed ^ 0x5EED), e), steps)[i]``."""
    dj = jlstm.init_stacked_lstm(jax.random.PRNGKey(1), input_dim=16, units=(8, 8))
    sj = jax.tree.map(np.asarray, jsvd.make_singular_model(dj, merged_kernel=merged))
    rates = (0.2, 0.3)
    fcfg = dict(dropout=rates[0], recurrent_dropout=rates[1])
    want = jft.finetune(sj, data.X_train, data.y_train, jcfg.FactorConfig(**fcfg),
                        _train_cfg(jcfg, recurrence_kernel=True), windows=windows)
    steps = WIN_N // BATCH
    base_key = jax.random.PRNGKey(0 ^ 0x5EED)

    def jax_masks(epoch, i):
        key = jax.random.split(jax.random.fold_in(base_key, epoch), steps)[i]
        return jax_layer_masks(key, sj.layers, BATCH, rates, 1 if merged else 4)

    def seam(seed, epoch, batch, device):
        assert seed == 0 ^ 0x5EED
        return jax_masks(epoch, batch)

    monkeypatch.setattr(ploop, "batch_generator", seam)
    got = P.finetune(P.from_numpy_tree(sj, device="cpu"), data.X_train, data.y_train,
                     pcfg.FactorConfig(**fcfg), _train_cfg(pcfg, recurrence_kernel=True), windows=windows)
    np.testing.assert_allclose(got.history, want.history, **HIST)
    for a, b in zip(jax.tree.leaves(P.to_numpy_tree(got.params)), jax.tree.leaves(want.params)):
        np.testing.assert_allclose(a, np.asarray(b), **PARAMS)


def test_fit_remat_matches_jax(data, windows):
    params = jlstm.init_stacked_lstm(jax.random.PRNGKey(0), input_dim=16, units=(8, 8))
    want = jax_fit(params, data.X_train, data.y_train, _train_cfg(jcfg, epochs=2, remat_chunk=5),
                   windows=windows)
    got = P.fit(P.from_numpy_tree(params, device="cpu"), data.X_train, data.y_train,
                _train_cfg(pcfg, epochs=2, remat_chunk=5), windows=windows)
    np.testing.assert_allclose(got.history, want.history, **HIST)
    for a, b in zip(jax.tree.leaves(P.to_numpy_tree(got.params)), jax.tree.leaves(want.params)):
        np.testing.assert_allclose(a, np.asarray(b), **PARAMS)


def test_masks_are_seeded_and_validation_never_drops(data, windows):
    """A batch's generator depends on (seed, epoch, batch) alone; two
    fine-tunes from one seed are identical, another seed differs; the
    wrapper drops only when given a source, so ``fit``'s validation is the
    exact forward's MSE of the trained model."""
    a = batch_generator(7, 1, 2, "cpu")
    b = batch_generator(7, 1, 2, "cpu")
    assert torch.equal(torch.rand(8, generator=a), torch.rand(8, generator=b))
    for other in ((7, 2, 2), (7, 1, 3), (8, 1, 2)):
        assert not torch.equal(torch.rand(8, generator=batch_generator(*other, "cpu")),
                               torch.rand(8, generator=batch_generator(7, 1, 2, "cpu")))
    smodel = P.make_singular_model(P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=16,
                                                       units=(6,), device="cpu"))
    fcfg = pcfg.FactorConfig(dropout=0.3, recurrent_dropout=0.3)
    runs = [P.finetune(smodel, data.X_train, data.y_train, fcfg, _train_cfg(pcfg, seed=s), windows=windows)
            for s in (0, 0, 1)]
    assert runs[0].history == runs[1].history and runs[0].history != runs[2].history
    apply_fn, seed = pft.dropout_apply_fn(fcfg, 0)
    Xv, yv = data.X_train[:, :64], data.y_train[:64]
    res = P.fit(smodel, data.X_train, data.y_train, _train_cfg(pcfg), apply_fn=apply_fn,
                optimizer=lambda m: pft.make_finetune_optimizer(m, fcfg), validation=(Xv, yv),
                windows=windows, dropout_seed=seed)
    exact = P.predict_full_run(res.params, Xv, apply_fn=P.singular_lstm_apply)
    np.testing.assert_allclose(res.val_history[-1], np.mean((exact - yv) ** 2), rtol=1e-6)
    with torch.no_grad():
        xt = torch.tensor(Xv)
        assert torch.equal(apply_fn(res.params, xt), P.singular_lstm_apply(res.params, xt))
        dropped = apply_fn(res.params, xt, rng=torch.Generator().manual_seed(0))
        assert not torch.equal(dropped, P.singular_lstm_apply(res.params, xt))
