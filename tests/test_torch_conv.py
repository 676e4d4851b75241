"""The port's conv hybrids (``models/conv.py``, ``ops/conv_train.py`` and the
conv branch of every entry point) against the JAX package on the CPU.

One small hybrid, 4 channels, 5 filters, k = 3, units (6, 6), drawn by the
JAX ``init_conv_lstm`` and carried across through ``from_numpy_tree``;
inputs from a numpy seed. On the CPU the port's kernel paths run their
plain versions, the JAX train kernels run in interpret mode.

Tolerances: forwards and exact ``predict`` atol 2e-5, rtol 1e-5 (float32 on
both sides, another summation order, as tests/test_torch_api.py); the fast
modes a relative Frobenius band of 3e-2 against exact (the narrow band of
the JAX package's batched tests); factors and the dense round trip atol
1e-6; gradients atol 2e-5 (tests/test_conv_train_kernel.py); loss
histories rtol 1e-5 (tests/test_torch_train.py) and the gate's validation
MSEs rtol 1e-4 (tests/test_torch_reduced_train.py); the native runtime
atol 1e-4 (tests/test_torch_native.py); streaming atol 1e-5 against
``predict`` and 0 between the eager and the packed step.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu import api as japi
from svd_lstm_tpu import config as jcfg
from svd_lstm_tpu.bench import autotune as jat
from svd_lstm_tpu.bench import sweep as jsweep
from svd_lstm_tpu.factor import svd as jsvd
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.io import csv_weights as jcsv
from svd_lstm_tpu.io import int8_export as jint8
from svd_lstm_tpu.models import conv as jconv
from svd_lstm_tpu.models import streaming as jstream
from svd_lstm_tpu.ops import conv_train as jct
from svd_lstm_tpu.train import finetune as jft
from svd_lstm_tpu.train.loop import fit as jax_fit
from svd_lstm_tpu.utils import quantize as jq
from svd_lstm_tpu_torch import config as pcfg
from svd_lstm_tpu_torch.bench import autotune as at
from svd_lstm_tpu_torch.bench.sweep import rank_sweep
from svd_lstm_tpu_torch.io import csv_weights as pcsv
from svd_lstm_tpu_torch.io.checkpoint import map_tree, to_tensor_tree
from svd_lstm_tpu_torch.io import int8_export as pint8
from svd_lstm_tpu_torch.io import native as pn
from svd_lstm_tpu_torch.ops import conv_train as pct
from svd_lstm_tpu_torch.models.conv import causal_conv1d, inner_stack
from svd_lstm_tpu_torch.train.finetune import regularization_loss, trainable_mask
from svd_lstm_tpu_torch.train.loop import resolve_train_apply_fn
from svd_lstm_tpu_torch.utils.precision import exact_matmul, matmul_scope, train_matmul_scope

CLOSE = dict(atol=2e-5, rtol=1e-5)
FAST_BAND = 3e-2
EXACT = dict(atol=1e-6, rtol=0)
GRAD = dict(atol=2e-5, rtol=0)
HIST = dict(rtol=1e-5, atol=0)
GATE = dict(rtol=1e-4, atol=0)
NATIVE = 1e-4
C_IN, FILTERS, K, UNITS, T = 4, 5, 3, (6, 6), 40

JAX_APPLY = {"dense": jconv.conv_lstm_apply, "singular": jconv.conv_singular_apply,
             "reduced": jconv.conv_reduced_apply}
PORT_APPLY = {"dense": P.conv_lstm_apply, "singular": P.conv_singular_apply,
              "reduced": P.conv_reduced_apply}
FAMILIES = sorted(JAX_APPLY)
has_cxx = pytest.mark.skipif(shutil.which(os.environ.get("CXX", "g++")) is None,
                             reason="no C++ compiler")


@pytest.fixture(scope="module")
def jax_models():
    init = jax.jit(lambda key: jconv.init_conv_lstm(key, in_channels=C_IN, filters=FILTERS,
                                                    kernel_size=K, units=UNITS))
    dense = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3)))
    singular = jsvd.make_conv_singular_model(dense, merged_kernel=False)
    return {"dense": dense, "singular": singular,
            "reduced": jsvd.make_conv_reduced_model(singular, cutoff=None, rank=4),
            "merged": jsvd.make_conv_reduced_model(
                jsvd.make_conv_singular_model(dense, merged_kernel=True), cutoff=None, rank=10)}


@pytest.fixture(scope="module")
def models(jax_models):
    return {k: P.from_numpy_tree(v, device="cpu") for k, v in jax_models.items()}


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(0).normal(size=(T, C_IN)).astype(np.float32)


@pytest.fixture(scope="module")
def run():
    """A (1, 200, C_IN) run and its targets: a smoothed first channel."""
    rng = np.random.default_rng(3)
    xr = rng.normal(size=(200, C_IN)).astype(np.float32)
    kernel = np.exp(-np.arange(10) / 4.0)
    y = np.convolve(xr[:, 0], kernel / kernel.sum(), mode="same").astype(np.float32)
    return xr[None], y


def _cfg(module, **kw):
    base = dict(num_windows=32, window_len=12, batch_size=8, epochs=2, seed=0)
    base.update(kw)
    return module.TrainConfig(**base)


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _rel(got, want) -> float:
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# the model, its forward and predict
# ---------------------------------------------------------------------------

def test_init_draws_the_jax_shapes_and_limits(jax_models):
    m = P.init_conv_lstm(torch.Generator().manual_seed(0), in_channels=C_IN, filters=FILTERS,
                         kernel_size=K, units=UNITS, device="cpu")
    j = jax_models["dense"]
    got, want = P.to_numpy_tree(m), j
    assert type(got).__name__ == type(want).__name__ == "ConvLSTMParams"
    assert [a.shape for a in _leaves(got)] == [a.shape for a in _leaves(want)]
    limit = np.sqrt(6.0 / (K * C_IN + K * FILTERS))
    assert 0.5 * limit < np.abs(got.conv.w).max() <= limit
    assert not got.conv.b.any() and np.all(got.layers[0].b[UNITS[0]:2 * UNITS[0]] == 1.0)
    assert P.model_input_dim(m) == japi.model_input_dim(j) == C_IN


@pytest.fixture(scope="module")
def jax_out(jax_models, x):
    """Each family's JAX forward of (x, x reversed): what the JAX package's
    exact predict returns for that batch, and for x alone its first row."""
    xb = jnp.asarray(np.stack([x, x[::-1]]))
    return {f: np.asarray(jax.jit(JAX_APPLY[f])(jax_models[f], xb)) for f in FAMILIES}


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax(models, x, jax_out, family):
    xb = torch.tensor(np.stack([x, x[::-1]]))
    got = PORT_APPLY[family](models[family], xb)
    np.testing.assert_allclose(got.detach().numpy(), jax_out[family], **CLOSE)
    last = PORT_APPLY[family](models[family], xb, return_sequences=False)
    np.testing.assert_allclose(last.detach().numpy(), jax_out[family][:, -1], **CLOSE)


@pytest.mark.parametrize("family", FAMILIES)
def test_predict_every_impl_matches_jax(jax_models, models, x, jax_out, family):
    """Batch-1 under every valid impl, exact against the JAX package's
    forward and fast within the band of exact; batched exact and fast."""
    m, jm = models[family], jax_models[family]
    want = jax_out[family][0]
    impls = P.valid_impls(m, torch.tensor(x))
    assert impls == japi.valid_impls(jm, jnp.asarray(x)) == ["scan", "fused", "hybrid"]
    for impl in ["auto", *impls]:
        got = P.predict(m, torch.tensor(x), impl=impl, consult_cache=False)
        np.testing.assert_allclose(got.numpy(), want, err_msg=impl, **CLOSE)
        fast = P.predict(m, torch.tensor(x), impl=impl, precision="fast", consult_cache=False)
        assert fast.shape == got.shape and _rel(fast.numpy(), want) < FAST_BAND, impl
    xb = torch.tensor(np.stack([x, x[::-1]]))
    for precision in ("exact", "high", "fast"):
        got = P.predict(m, xb, precision=precision, consult_cache=False)
        assert _rel(got.numpy(), jax_out[family]) < (1e-5 if precision == "exact" else FAST_BAND), \
            precision
    assert P.valid_impls(m, xb) == japi.valid_impls(jm, jnp.asarray(xb.numpy())) == ["scan"]
    with pytest.raises(ValueError, match="batch-1"):
        P.predict(m, xb, impl="fused")


def test_surgery_matches_jax_and_is_exact(jax_models, models, x):
    dense = models["dense"]
    xt = torch.tensor(x[None])
    for merged in (False, True):
        s = P.make_conv_singular_model(dense, merged_kernel=merged)
        js = jsvd.make_conv_singular_model(jax_models["dense"], merged_kernel=merged)
        for a, b in zip(_leaves(P.to_numpy_tree(s)), _leaves(js)):
            np.testing.assert_allclose(a, b, **EXACT)
        np.testing.assert_allclose(P.conv_singular_apply(s, xt).detach(),
                                   P.conv_lstm_apply(dense, xt).detach(), **CLOSE)
        full = P.make_conv_reduced_model(s, cutoff=None, rank=6)  # every σ kept
        np.testing.assert_allclose(P.conv_reduced_apply(full, xt).detach(),
                                   P.conv_singular_apply(s, xt).detach(), **CLOSE)
        back = P.conv_singular_to_dense(s)
        assert torch.equal(back.conv.w, dense.conv.w) and back.conv.w is not dense.conv.w
        for a, b in zip(back.parameters(), dense.parameters()):
            np.testing.assert_allclose(a.detach(), b.detach(), **EXACT)
    r = models["reduced"]
    assert r.weight_count() == jax_models["reduced"].weight_count() < models["singular"].weight_count()
    for fn, arg in ((P.make_conv_singular_model, models["singular"]),
                    (P.make_conv_reduced_model, dense), (P.conv_singular_to_dense, dense)):
        with pytest.raises(TypeError):
            fn(arg)


# ---------------------------------------------------------------------------
# training: the kernel applies, fit, the σ fine-tune, the recovery
# ---------------------------------------------------------------------------

_FAST = {"dense": (pct.conv_lstm_apply_fast_train, jct.conv_lstm_apply_fast_train),
         "singular": (pct.conv_singular_apply_fast_train, jct.conv_singular_apply_fast_train),
         "reduced": (pct.conv_reduced_apply_fast_train, jct.conv_reduced_apply_fast_train)}


@pytest.mark.parametrize("family", FAMILIES)
def test_fast_train_apply_grads_match_jax(jax_models, models, family):
    """The forward and every leaf's gradient, the conv's w and b included,
    of the port's kernel apply (the plain versions here) against jax.grad of
    the JAX kernel apply in interpret mode."""
    rng = np.random.default_rng(1)
    xb = rng.normal(size=(3, 5, C_IN)).astype(np.float32)
    yb = rng.normal(size=(3,)).astype(np.float32)
    port_fn, jax_fn = _FAST[family]

    def jloss(q):
        pred = jax_fn(q, jnp.asarray(xb), return_sequences=False, interpret=True)[..., 0]
        return jnp.mean(jnp.square(pred - yb))

    want = jax.jit(jax.grad(jloss))(jax_models[family])
    model = P.from_numpy_tree(jax_models[family], device="cpu")
    loss = torch.mean((port_fn(model, torch.tensor(xb), return_sequences=False)[..., 0]
                       - torch.tensor(yb)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jax.jit(jloss)(jax_models[family])), rtol=1e-5)
    grads = []  # in the tree's leaf order, the JAX package's
    map_tree(lambda p: grads.append(p.grad.numpy()), to_tensor_tree(model))
    assert len(grads) == len(jax.tree.leaves(want))
    for i, (a, b) in enumerate(zip(grads, _leaves(want))):
        np.testing.assert_allclose(a, b, err_msg=f"leaf {i}", **GRAD)
    assert model.conv.w.grad.abs().max() > 0 and model.conv.b.grad.abs().max() > 0


@pytest.fixture(scope="module")
def jax_fit_run(jax_models, run):
    """The JAX package's two epochs of the dense hybrid (its exact scan: on
    the CPU its kernels compute the same float32 values, more slowly)."""
    X, y = run
    return jax_fit(jax_models["dense"], X, y, _cfg(jcfg), apply_fn=jconv.conv_lstm_apply)


@pytest.mark.parametrize("kernel", [False, True], ids=["scan", "kernel"])
def test_fit_matches_jax(jax_models, run, jax_fit_run, kernel):
    X, y = run
    init = P.from_numpy_tree(jax_models["dense"], device="cpu")
    res = P.fit(init, X, y, _cfg(pcfg, recurrence_kernel=kernel))
    np.testing.assert_allclose(res.history, jax_fit_run.history, **HIST)
    for a, b in zip(_leaves(P.to_numpy_tree(res.params)), _leaves(jax_fit_run.params)):
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)
    assert not torch.equal(res.params.conv.w, init.conv.w)
    np.testing.assert_allclose(P.predict_full_run(res.params, X), P.predict_full_run(
        P.from_numpy_tree(jax_fit_run.params, device="cpu"), X), **CLOSE)


def test_sigma_finetune_freezes_the_conv_and_matches_jax(jax_models, models, run):
    X, y = run
    fcfg = pcfg.FactorConfig(hoyer=0.01)
    jres = jft.finetune(jax_models["singular"], X, y, jcfg.FactorConfig(hoyer=0.01), _cfg(jcfg))
    init = models["singular"]
    res = P.finetune(init, X, y, fcfg, _cfg(pcfg, recurrence_kernel=True))
    np.testing.assert_allclose(res.history, jres.history, **HIST)
    mask = trainable_mask(init, train_uv=False)
    assert {n for n, t in mask.items() if t} == {
        *(f"inner.layers.{i}.{s}" for i in range(2) for s in ("ws", "us")),
        "inner.head.w", "inner.head.b"}
    for (name, old), new in zip(init.named_parameters(), res.params.parameters()):
        assert torch.equal(old, new) != mask[name], name
    assert all(trainable_mask(init, train_uv=True).values())
    for (a, b), (c, d) in zip(P.harvest_sigmas(res.params), jft.harvest_sigmas(jres.params)):
        np.testing.assert_allclose(a, c, atol=2e-6)
        np.testing.assert_allclose(b, d, atol=2e-6)
    reg = jft.regularization_loss(jax_models["singular"], jcfg.FactorConfig(hoyer=0.01))
    np.testing.assert_allclose(regularization_loss(init, fcfg).item(), float(reg),
                               rtol=1e-6)


def test_recover_reduced_gated_matches_jax(jax_models, run):
    X, y = run
    kw = dict(lr_ladder=(3e-3,), clip=0.5, max_epochs=1)
    out_j, info_j = jft.recover_reduced_gated(jax_models["reduced"], X, y,
                                              train_cfg=_cfg(jcfg, epochs=1), **kw)
    out, info = P.recover_reduced_gated(P.from_numpy_tree(jax_models["reduced"], device="cpu"), X, y,
                                        train_cfg=_cfg(pcfg, epochs=1, recurrence_kernel=True), **kw)
    assert [t["accepted"] for t in info["trace"]] == [t["accepted"] for t in info_j["trace"]]
    for k in ("raw_val_mse", "best_val_mse"):
        np.testing.assert_allclose(info[k], info_j[k], err_msg=k, **GATE)
    assert info["gate"] == info_j["gate"] and info["best_val_mse"] <= info["raw_val_mse"]
    for a, b in zip(_leaves(P.to_numpy_tree(out)), _leaves(out_j)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    hist = P.finetune_reduced(out, X, y, _cfg(pcfg, epochs=1)).history
    assert np.isfinite(hist).all()
    rmod, infos = P.truncate_recover_progressive(
        P.from_numpy_tree(jax_models["dense"], device="cpu"), X, y, ranks=(5, 4),
        train_cfg=_cfg(pcfg, epochs=1, recurrence_kernel=True), merged_kernel=False, **kw)
    assert isinstance(rmod, P.ConvReducedLSTM) and [i["rank"] for i in infos] == [5, 4]
    assert all(i["best_val_mse"] <= i["raw_val_mse"] for i in infos)
    assert {r for l in rmod.inner.layers for side in l.ranks for r in side} == {4}


def test_item4_refusals(jax_models, models, run):
    """The conv hybrids' dropout and remat, once refused, against the JAX
    package: ``conv_singular_apply`` with dropout, recurrent dropout and
    remat on the JAX package's own masks (its key split once a layer, then
    into ``k_dp, k_rdp``; the front end takes none), forward and gradients;
    ``conv_lstm_apply`` with remat; and ``fit`` of the dense hybrid with
    ``remat_chunk`` against the JAX ``fit``'s history and parameters."""
    from svd_lstm_tpu.models import singular as jsing

    X, y = run
    xb = np.random.default_rng(7).normal(size=(3, 16, C_IN)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    js = jax_models["singular"]
    masks = []
    for layer, k in zip(js.inner.layers, jax.random.split(key, len(js.inner.layers))):
        k_dp, k_rdp = jax.random.split(k)
        masks.append(tuple(torch.tensor(np.asarray(jsing.dropout_masks(kk, rate, (3, dim), 4, jnp.float32)))
                           for kk, rate, dim in ((k_dp, 0.2, layer.input_dim), (k_rdp, 0.3, layer.units))))
    kw = dict(dropout=0.2, recurrent_dropout=0.3, remat_chunk=5)

    def loss_j(p):
        return jnp.sum(jconv.conv_singular_apply(p, jnp.asarray(xb), rng=key, **kw) ** 2)

    want, gwant = jax.value_and_grad(loss_j)(js)
    m = P.from_numpy_tree(js, device="cpu")
    got = torch.sum(P.conv_singular_apply(m, torch.tensor(xb), rng=masks, **kw) ** 2)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for (name, p), g in zip(m.named_parameters(), jax.tree.leaves(gwant)):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), atol=1e-5 * float(np.abs(g).max()),
                                   rtol=0, err_msg=name)
    out_j = jconv.conv_lstm_apply(jax_models["dense"], jnp.asarray(xb), remat_chunk=5)
    np.testing.assert_allclose(P.conv_lstm_apply(models["dense"], torch.tensor(xb), remat_chunk=5)
                               .detach().numpy(), np.asarray(out_j), **CLOSE)
    want = jax_fit(jax_models["dense"], X, y, _cfg(jcfg, remat_chunk=4), apply_fn=jconv.conv_lstm_apply)
    got = P.fit(models["dense"], X, y, _cfg(pcfg, remat_chunk=4))
    np.testing.assert_allclose(got.history, want.history, **HIST)
    for a, b in zip(_leaves(P.to_numpy_tree(got.params)), _leaves(want.params)):
        np.testing.assert_allclose(a, b, atol=2e-6, rtol=0)


# ---------------------------------------------------------------------------
# checkpoints, exports, the native runtime, streaming, quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_npz_cross_loads_both_ways(jax_models, models, x, jax_out, family, tmp_path):
    """Each package loads the other's file; the JAX package's load is the
    JAX model leaf for leaf (so its predict is ``jax_out``'s), and the
    port's predict of the JAX file agrees with that within 1e-5."""
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_params(jpath, jax_models[family])
    P.save_params(ppath, models[family])
    loaded = P.load_params(jpath, device="cpu")
    assert type(loaded) is type(models[family])
    back = jckpt.load_params(ppath)
    assert type(back).__name__ == type(jax_models[family]).__name__
    for a, b in zip(_leaves(back), _leaves(jax_models[family])):
        np.testing.assert_array_equal(a, b)
    got = P.predict(loaded, torch.tensor(x), consult_cache=False).numpy()
    np.testing.assert_allclose(got, jax_out[family][0], atol=1e-5, rtol=0)


@has_cxx
def test_csv_exports_cross_load_and_run_natively(jax_models, models, x, tmp_path):
    d = str(tmp_path / "dense")
    pcsv.save_model_weights_as_csv(models["dense"], d)
    back = jcsv.load_model_from_csv(d)
    assert type(back).__name__ == "ConvLSTMParams"
    for a, b in zip(_leaves(back), _leaves(jax_models["dense"])):
        np.testing.assert_allclose(a, b, atol=1e-6)
    jd = str(tmp_path / "jax")
    jcsv.save_model_weights_as_csv(jax_models["dense"], jd)
    assert isinstance(pcsv.load_model_from_csv(jd, device="cpu"), P.ConvLSTM)
    for name in ("w.csv", "b.csv", "shape.csv"):
        with open(os.path.join(d, "conv", name)) as f, open(os.path.join(jd, "conv", name)) as g:
            assert f.read() == g.read(), name
    nm = pn.NativeModel.from_export_dir(d)
    assert nm.input_dim == C_IN
    got = nm.run(x)
    np.testing.assert_allclose(got, P.predict(models["dense"], torch.tensor(x))[:, 0].numpy(),
                               atol=NATIVE)
    nm.reset()
    np.testing.assert_array_equal(nm.run(x), got)  # the reset clears the conv's buffer
    for family in ("reduced", "merged"):
        rd = str(tmp_path / family)
        pn.save_reduced_weights_as_csv(models[family], rd)
        np.testing.assert_allclose(
            pn.NativeModel.from_export_dir(rd).run(x),
            P.predict(models[family], torch.tensor(x))[:, 0].numpy(), atol=NATIVE)
    with open(os.path.join(d, "conv", "shape.csv"), "w") as f:
        f.write("2,4\n")
    with pytest.raises(ValueError, match="shape.csv"):
        pcsv.load_conv_front_csv(d, device="cpu")
    for fn, family in ((pcsv.save_model_weights_as_csv, "reduced"),
                       (pn.save_reduced_weights_as_csv, "dense"),
                       (pcsv.save_model_weights_as_json, "dense")):
        with pytest.raises(TypeError):
            fn(models[family], str(tmp_path / "wrong"))


@has_cxx
def test_int8_bin_matches_jax_and_runs_natively(jax_models, models, x, tmp_path):
    for family in ("dense", "reduced", "merged"):
        p, jp = str(tmp_path / f"{family}.bin"), str(tmp_path / f"{family}_jax.bin")
        size = pint8.save_model_int8_bin(models[family], p)
        jint8.save_model_int8_bin(jax_models[family], jp)
        with open(p, "rb") as f, open(jp, "rb") as g:
            blob = f.read()
            assert blob == g.read() and len(blob) == size, family
        assert int.from_bytes(blob[8:12], "little") == 3
        oracle = pint8.dequantized_params(models[family])
        want = jint8.dequantized_params(jax_models[family])
        for a, b in zip(_leaves(P.to_numpy_tree(oracle)), _leaves(want)):
            np.testing.assert_allclose(a, b, atol=1e-6)
        np.testing.assert_allclose(pn.NativeModel.from_int8(p).run(x),
                                   P.predict(oracle, torch.tensor(x))[:, 0].numpy(), atol=NATIVE)
    trunc = str(tmp_path / "trunc.bin")
    with open(trunc, "wb") as f:
        f.write(blob[:40])  # cut inside the conv section's qmat
    with pytest.raises(RuntimeError):
        pn.NativeModel.from_int8(trunc)
    with pytest.raises(TypeError):
        pint8.save_model_int8_bin(models["singular"], str(tmp_path / "s.bin"))


@has_cxx
def test_export_command_takes_the_hybrids(models, x, tmp_path):
    """``export --int8`` of a hybrid checkpoint: its stack's CSVs with
    ``conv/``, which the native runtime runs as ``predict`` does; a
    factorized hybrid is refused as the factorized stack is."""
    from svd_lstm_tpu_torch import __main__ as cli

    for family in ("dense", "reduced"):
        ckpt, out = str(tmp_path / f"{family}.npz"), str(tmp_path / family)
        P.save_params(ckpt, models[family])
        cli._export([ckpt, out, "--int8", "--device", "cpu"])
        assert os.path.exists(os.path.join(out, "conv", "w.csv"))
        assert os.path.exists(os.path.join(out, "model_int8.bin"))
        np.testing.assert_allclose(pn.NativeModel.from_export_dir(out).run(x),
                                   P.predict(models[family], torch.tensor(x))[:, 0].numpy(), atol=NATIVE)
    P.save_params(str(tmp_path / "s.npz"), models["singular"])
    with pytest.raises(SystemExit, match="singular"):
        cli._export([str(tmp_path / "s.npz"), str(tmp_path / "s"), "--device", "cpu"])


@pytest.mark.parametrize("family", FAMILIES)
def test_streaming_matches_predict(jax_models, models, x, family):
    m = models[family]
    state0 = P.init_stream(m)
    jstate = jstream.init_stream(jax_models[family])
    assert [tuple(t.shape) for t in jax.tree.leaves(state0)] == [
        tuple(t.shape) for t in jax.tree.leaves(jstate)]
    assert tuple(state0[0].shape) == (1, K, C_IN)
    fn, s = P.make_stream_fn(m)
    state, ys, ysp = state0, [], []
    with torch.no_grad():
        for t in range(T):
            y, state = P.stream_step(m, state, torch.tensor(x[t : t + 1]))
            yp, s = fn(s, torch.tensor(x[t : t + 1]))
            ys.append(y)
            ysp.append(yp)
        many, _ = P.stream_many(m, P.init_stream(m), torch.tensor(x[None]))
    eager = torch.cat(ys)
    np.testing.assert_allclose(eager.numpy(), P.predict(m, torch.tensor(x)).numpy(), atol=1e-5)
    assert torch.equal(torch.cat(ysp), eager) and torch.equal(many[0], eager)
    assert not state0[0].any()  # a step never writes into its state


@pytest.mark.parametrize("family", FAMILIES)
def test_quantization_matches_jax(jax_models, models, x, family):
    """The reduced hybrid's whole int8 tree against the JAX package's; for
    the other two its conv kernel's grid (their stacks' trees are held to
    the JAX package's in tests/test_torch_quantize.py)."""
    q = P.quantize_params(models[family])
    assert isinstance(q.conv.w, P.QuantizedTensor) and tuple(q.conv.w.scale.shape) == (1, 1, FILTERS)
    got = P.to_numpy_tree(q)
    if family == "reduced":
        pairs = zip(jax.tree.leaves(got), jax.tree.leaves(jq.quantize_params(jax_models[family])))
    else:  # the conv's grid against the JAX package's; the stack as the port quantizes it
        w = np.asarray(jax_models[family].conv.w).reshape(K * C_IN, FILTERS)
        jw = jq.quantize_tensor(jnp.asarray(w), axis=0)
        stack = P.to_numpy_tree(P.quantize_params(inner_stack(models[family])))
        mine = got.inner if family == "singular" else (got.layers, got.head)
        pairs = [(got.conv.w.q.reshape(-1, FILTERS), jw.q), (got.conv.w.scale.reshape(1, -1), jw.scale),
                 *zip(jax.tree.leaves(mine), jax.tree.leaves(stack))]
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max() <= 1  # a tie may round apart
        else:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)
    for a, b in zip(jax.tree.leaves(P.to_numpy_tree(P.quantize_params(q))), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)  # idempotent
    assert P.param_bytes(q) == sum(np.asarray(a).nbytes for a in jax.tree.leaves(got))
    y8 = P.quantized_apply(P.predict)(q, torch.tensor(x))
    np.testing.assert_array_equal(y8.numpy(), P.predict(P.dequantize_params(q), torch.tensor(x)).numpy())
    assert _rel(y8.numpy(), P.predict(models[family], torch.tensor(x)).numpy()) < FAST_BAND
    m = P.from_numpy_tree(jax_models[family], device="cpu")
    view = P.fake_quantize_params(m)  # the QAT view: the int8 grid's values
    np.testing.assert_allclose(view.conv.w.detach().numpy(),
                               P.dequantize_params(q).conv.w.detach().numpy(), atol=1e-7)
    loss = P.qat_apply(PORT_APPLY[family])(m, torch.tensor(x[None])).square().mean()
    loss.backward()
    assert m.conv.w.grad is not None and m.conv.w.grad.abs().max() > 0


# ---------------------------------------------------------------------------
# evaluation: the sweep, the autotune keys; the exact scope's cuDNN switch
# ---------------------------------------------------------------------------

def test_rank_sweep_matches_jax(jax_models, models, run):
    X, y = run
    inv = lambda a: 2.0 * a  # noqa: E731
    cfg = pcfg.SweepConfig(evaluate_every=4)
    got = rank_sweep(models["dense"], X, inv(y), inv, cfg, max_reductions=12)
    want = jsweep.rank_sweep(jax_models["dense"], X, inv(y), inv, jcfg.SweepConfig(evaluate_every=4),
                             max_reductions=12)
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_allclose(got.rmse, want.rmse, rtol=1e-5)
    np.testing.assert_array_equal(got.weights_eliminated, want.weights_eliminated)
    assert got.reductions_done == want.reductions_done == 12


@pytest.mark.parametrize("family", FAMILIES)
def test_autotune_keys_are_the_jax_packages_but_the_device(jax_models, models, x, family):
    m, jm = models[family], jax_models[family]
    for xx, precision in ((x, "exact"), (np.stack([x, x]), "fast")):
        got = json.loads(at.cache_key(m, torch.tensor(xx), precision))
        want = json.loads(jat.cache_key(jm, jnp.asarray(xx), precision))
        assert got.pop("device") == "cpu"
        want.pop("device")
        assert got == want and got["family"] == f"conv+{family}"
    xw = np.zeros((8, 12, C_IN), np.float32)
    got = json.loads(at.train_cache_key(m, torch.tensor(xw)))
    want = json.loads(jat.train_cache_key(jm, xw))
    got.pop("device")
    want.pop("device")
    assert got == want


def test_autotune_routes_the_hybrid(models, x, tmp_path, monkeypatch):
    monkeypatch.setattr(at, "_MEM_CACHE", {})
    cache = str(tmp_path / "autotune.json")
    m = models["reduced"]
    r = at.autotune(m, torch.tensor(x), repeats=1)
    assert set(r.table) == {"scan", "fused", "hybrid"} and not r.failed
    assert at.tuned_impl(m, torch.tensor(x), cache_path=cache) in r.table
    # the training half measures each family's own step: its forward and,
    # for the factorized hybrid, the σ fine-tune's penalty and optimizer
    for family, apply_fn in PORT_APPLY.items():
        fwd, extra, _ = at._train_apply_for(models[family])
        assert fwd is apply_fn and (extra is None) == (family != "singular")
        assert resolve_train_apply_fn(_cfg(pcfg, recurrence_kernel=True), fwd)[1]


def test_exact_scope_turns_cudnn_tf32_off_and_restores_it():
    for before in (True, False):
        torch.backends.cudnn.allow_tf32 = before
        try:
            with exact_matmul():
                assert torch.backends.cudnn.allow_tf32 is False
                with matmul_scope("high"):
                    assert torch.backends.cudnn.allow_tf32 is True
                assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is before
            for regime, inside in (("float32", False), ("tensorfloat32", True), ("bfloat16", False)):
                with train_matmul_scope(regime):
                    assert torch.backends.cudnn.allow_tf32 is inside, regime
                assert torch.backends.cudnn.allow_tf32 is before
        finally:
            torch.backends.cudnn.allow_tf32 = True


def test_bf16_regime_rounds_the_conv_operands(models):
    """In the "bfloat16" regime the conv is a DEFAULT product: both operands
    rounded to bf16, the sums float32; outside it the conv is exact."""
    conv = models["dense"].conv
    xt = torch.tensor(np.random.default_rng(4).normal(size=(2, 9, C_IN)).astype(np.float32))
    with train_matmul_scope("bfloat16"):
        got = causal_conv1d(conv, xt)
    rounded = P.ConvFront(conv.w.detach().bfloat16().float(), conv.b.detach())
    want = causal_conv1d(rounded, xt.bfloat16().float())
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-6)
    exact = causal_conv1d(conv, xt).detach().numpy()
    assert np.abs(got.detach().numpy() - exact).max() > 1e-5
    jwant = np.asarray(jconv.causal_conv1d(jconv.ConvParams(*[jnp.asarray(p.detach().numpy())
                                                              for p in (conv.w, conv.b)]),
                                           jnp.asarray(xt.numpy())))
    np.testing.assert_allclose(exact, jwant, **CLOSE)
