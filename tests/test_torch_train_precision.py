"""The port's training regimes (``TrainConfig.matmul_precision``) on the CPU.

* ``utils.precision.dot`` in the bf16 scope and every plain bf16 train
  version (K7f/K8f,
  K9f, K6f: forward and backward) against a float64 numpy emulation that
  rounds the same operands to bf16 through ``jnp.bfloat16``: relative error
  (max abs error over the largest value) at most 1e-6, float32 sums against
  float64 ones;
* ``fit`` in "tensorfloat32" against the JAX package's ``fit`` with the
  same config: TF32 and the TPU's 3-pass bf16 are both exact float32 on the
  CPU, so the histories agree within 1e-5 (relative) and the parameters
  within 1e-5;
* ``fit`` in "bfloat16", the scan and the kernel regime, against the JAX
  package's: JAX ignores bf16 matmul precision on the CPU (its DEFAULT dot
  is exact float32 there), so the port's bf16 run is held to the JAX run by
  the fast bands of tests/test_pallas_batched.py: the whole-run prediction
  of the trained models within relative Frobenius 3e-2 (narrow) and 2e-2
  (wide); and to its own emulation through the scan regime (the two bf16
  regimes round the same operands: histories within 1e-5);
* the σ fine-tune and the gated recovery in each regime;
* validation runs exact in every regime, and the scope restores torch's
  settings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu import config as jcfg
from svd_lstm_tpu.factor.svd import make_singular_model as jax_make_singular
from svd_lstm_tpu.models.lstm import init_stacked_lstm as jax_init
from svd_lstm_tpu.models.lstm import stacked_lstm_apply as jax_apply
from svd_lstm_tpu.train.finetune import finetune as jax_finetune
from svd_lstm_tpu.train.loop import fit as jax_fit
from svd_lstm_tpu_torch import config as pcfg
from svd_lstm_tpu_torch.data import batcher as pbatch
from svd_lstm_tpu_torch.data.dropbear import preprocess_raw
from svd_lstm_tpu_torch.data.synthetic import synthetic_dropbear_raw
from svd_lstm_tpu_torch.ops import cuda_train as ct
from svd_lstm_tpu_torch.train.loop import predict_full_run
from svd_lstm_tpu_torch.utils import precision as prec

WIN_T, WIN_N, BATCH = 12, 32, 8
EMU_RTOL = 1e-6
FAST_BAND = {"narrow": 3e-2, "wide": 2e-2}


@pytest.fixture(scope="module")
def data():
    return preprocess_raw(synthetic_dropbear_raw(duration=6.0), pcfg.DataConfig(split_time=4.0))


@pytest.fixture(scope="module")
def windows(data):
    return pbatch.split_train_random(data.X_train, data.y_train, WIN_N, WIN_T, seed=0)


def _cfg(module, **kw):
    base = dict(num_windows=WIN_N, window_len=WIN_T, batch_size=BATCH, epochs=2)
    base.update(kw)
    return module.TrainConfig(**base)


# ---------------------------------------------------------------------------
# the float64 emulation: each operand of a product rounded by jnp.bfloat16
# ---------------------------------------------------------------------------

def r(a):
    """An operand as the TPU's DEFAULT dot takes it: rounded to bf16."""
    return np.asarray(np.asarray(a, np.float64).astype(jnp.bfloat16), np.float64)


def _sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def emu_recurrence_fwd(xp, U):
    T, B, _ = xp.shape
    n = U.shape[0]
    h, c = np.zeros((B, n)), np.zeros((B, n))
    hs, cs = [], []
    for t in range(T):
        z = xp[t] + r(h) @ r(U)
        i, f, g, o = _sig(z[:, :n]), _sig(z[:, n:2 * n]), np.tanh(z[:, 2 * n:3 * n]), _sig(z[:, 3 * n:])
        c = f * c + i * g
        h = o * np.tanh(c)
        hs.append(h)
        cs.append(c)
    return np.stack(hs), np.stack(cs)


def emu_layer_fwd(x, W, U, b):
    return emu_recurrence_fwd(r(x) @ r(W) + b, U)


def emu_layer_bwd(x, W, U, b, h, c, dh_seq, xp=None):
    """(dx, dW, dU, db), or with ``xp`` (K6: W and b unused) (dxp, dU)."""
    T, B, _ = h.shape
    n = U.shape[0]
    xp = r(x) @ r(W) + b if xp is None else xp
    h_prev = np.concatenate([np.zeros((1, B, n)), h[:-1]])
    c_prev = np.concatenate([np.zeros((1, B, n)), c[:-1]])
    dh_c, dc = np.zeros((B, n)), np.zeros((B, n))
    dz = np.zeros((T, B, 4 * n))
    for t in range(T - 1, -1, -1):
        z = xp[t] + r(h_prev[t]) @ r(U)
        i, f, g, o = _sig(z[:, :n]), _sig(z[:, n:2 * n]), np.tanh(z[:, 2 * n:3 * n]), _sig(z[:, 3 * n:])
        tc = np.tanh(c[t])
        dh = dh_seq[t] + dh_c
        dct = dc + dh * o * (1 - tc * tc)
        dz[t] = np.concatenate([dct * g * i * (1 - i), dct * c_prev[t] * f * (1 - f),
                                dct * i * (1 - g * g), dh * tc * o * (1 - o)], axis=-1)
        dc = dct * f
        dh_c = r(dz[t]) @ r(U).T
    dU = np.einsum("tbn,tbg->ng", r(h_prev), r(dz))
    if x is None:
        return dz, dU
    return r(dz) @ r(W).T, np.einsum("tbd,tbg->dg", r(x), r(dz)), dU, dz.sum(axis=(0, 1))


def _assert_rel(name, got, want, rtol=EMU_RTOL):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= rtol, (name, err)


def _layers(seed, units, d):
    rng = np.random.default_rng(seed)
    out, din = [], d
    for n in units:
        out.append(tuple(rng.normal(scale=s, size=shape).astype(np.float32) for s, shape in
                         ((din ** -0.5, (din, 4 * n)), (n ** -0.5, (n, 4 * n)), (0.1, (4 * n,)))))
        din = n
    return out


def _t(a):
    if isinstance(a, (list, tuple)):
        return [_t(v) for v in a]
    return torch.tensor(a, dtype=torch.float32)


# ---------------------------------------------------------------------------
# the bf16 scope's dot and the plain bf16 versions against the emulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape_a,shape_b", [((5, 7), (7, 3)), ((4, 12, 8), (8, 32))])
def test_bf16_dot_matches_emulation(shape_a, shape_b):
    """The forward takes bf16-rounded operands and returns an unrounded
    float32 sum; the backward rounds the cotangent and the other operand
    before each product."""
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=shape_a).astype(np.float32), rng.normal(size=shape_b).astype(np.float32)
    g = rng.normal(size=shape_a[:-1] + shape_b[-1:]).astype(np.float32)
    ta, tb = (torch.tensor(v, requires_grad=True) for v in (a, b))
    with prec.train_matmul_scope("bfloat16"):
        out = prec.dot(ta, tb)
        out.backward(torch.tensor(g))
    want = r(a) @ r(b)
    _assert_rel("out", out, want)
    assert not np.array_equal(out.detach().numpy(), r(out.detach().numpy()))  # not rounded
    _assert_rel("da", ta.grad, r(g) @ r(b).T)
    k, m = shape_b
    _assert_rel("db", tb.grad, r(a).reshape(-1, k).T @ r(g).reshape(-1, m))
    # not the rounding of the product's result, nor a gradient rounded after it
    assert np.abs(ta.grad.numpy() - g @ r(b).T).max() > 1e-4


def test_bf16_einsum_in_the_scope_matches_emulation():
    rng = np.random.default_rng(1)
    x, left = rng.normal(size=(3, 6)).astype(np.float32), rng.normal(size=(4, 6, 5)).astype(np.float32)
    tx = torch.tensor(x, requires_grad=True)
    with prec.train_matmul_scope("bfloat16"):
        out = prec.einsum("...d,gdk->...gk", tx, torch.tensor(left))
    g = rng.normal(size=out.shape).astype(np.float32)
    out.backward(torch.tensor(g))
    _assert_rel("out", out, np.einsum("bd,gdk->bgk", r(x), r(left)))
    _assert_rel("dx", tx.grad, np.einsum("bgk,gdk->bd", r(g), r(left)))


NARROW = dict(units=(8, 8), d=16, T=12, B=4)


@pytest.mark.parametrize("compact", [False, True], ids=["K7f", "K8f"])
def test_plain_narrow_bf16_matches_emulation(compact):
    fwd = ct.fused_narrow_train_compact_fwd_plain if compact else ct.fused_narrow_train_fwd_plain
    bwd = ct.fused_narrow_train_compact_bwd_plain if compact else ct.fused_narrow_train_bwd_plain
    layers = _layers(2, NARROW["units"], NARROW["d"])
    rng = np.random.default_rng(3)
    x = rng.normal(size=(NARROW["T"], NARROW["B"], NARROW["d"])).astype(np.float32)
    dh = rng.normal(size=(NARROW["T"], NARROW["B"], NARROW["units"][-1])).astype(np.float32)
    hs, cs = fwd(_t(layers), _t(x), True)
    inp, want_h, want_c = x, [], []
    for W, U, b in layers:
        h, c = emu_layer_fwd(inp, W, U, b)
        want_h.append(h)
        want_c.append(c)
        inp = h
    for i in range(len(layers)):
        _assert_rel(f"h{i}", hs[i], want_h[i])
        _assert_rel(f"c{i}", cs[i], want_c[i])
    dWs, dUs, dbs, dx = bwd(_t(layers), _t(x), hs, cs, _t(dh), True)
    hs_np = [h.double().numpy() for h in hs]
    cs_np = [c.double().numpy() for c in cs]
    g = dh
    for i in range(len(layers) - 1, -1, -1):
        W, U, b = layers[i]
        g, dW, dU, db = emu_layer_bwd(x if i == 0 else hs_np[i - 1], W, U, b, hs_np[i], cs_np[i], g)
        _assert_rel(f"dW{i}", dWs[i], dW)
        _assert_rel(f"dU{i}", dUs[i], dU)
        _assert_rel(f"db{i}", dbs[i], db)
    _assert_rel("dx", dx, g)


def test_plain_wide_and_recurrence_bf16_match_emulation():
    """K9f's and K6f's plain versions (the wrappers take n % 128 == 0; the
    plain versions any n)."""
    n, d, T, B = 8, 16, 12, 4
    (W, U, b), = _layers(4, (n,), d)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(T, B, d)).astype(np.float32)
    dh = rng.normal(size=(T, B, n)).astype(np.float32)
    h, c = ct.wide_layer_fwd_plain(*_t([x, W, U, b]), True)
    want_h, want_c = emu_layer_fwd(x, W, U, b)
    _assert_rel("h", h, want_h)
    _assert_rel("c", c, want_c)
    got = ct.wide_layer_bwd_plain(*_t([x, W, U, b]), h, c, _t(dh), True)
    want = emu_layer_bwd(x, W, U, b, h.double().numpy(), c.double().numpy(), dh)
    for name, a, w in zip(("dx", "dW", "dU", "db"), got, want):
        _assert_rel(name, a, w)
    xp = rng.normal(size=(T, B, 4 * n)).astype(np.float32)
    h, c = ct.lstm_recurrence_train_fwd_plain(*_t([xp, U]), True)
    want_h, want_c = emu_recurrence_fwd(xp.astype(np.float64), U)
    _assert_rel("K6 h", h, want_h)
    _assert_rel("K6 c", c, want_c)
    dxp, dU = ct.lstm_recurrence_train_bwd_plain(*_t([xp, U]), h, c, _t(dh), True)
    want = emu_layer_bwd(None, None, U, None, h.double().numpy(), c.double().numpy(), dh,
                         xp=xp.astype(np.float64))
    _assert_rel("K6 dxp", dxp, want[0])
    _assert_rel("K6 dU", dU, want[1])


def test_wrappers_and_functions_take_the_bf16_plain_versions_on_the_cpu():
    """On CPU tensors a wrapper with bf16 runs the plain bf16 version and
    launches nothing; the autograd Functions carry the flag to both
    directions."""
    layers = _t(_layers(6, (8, 8), 16))
    rng = np.random.default_rng(7)
    x = _t(rng.normal(size=(5, 3, 16)).astype(np.float32))
    before = dict(ct.LAUNCHES)
    got = ct.fused_narrow_train_fwd(layers, x, True)
    want = ct.fused_narrow_train_fwd_plain(layers, x, True)
    exact = ct.fused_narrow_train_fwd_plain(layers, x)
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert not torch.equal(want[0][-1], exact[0][-1])
    flat = [t.clone().requires_grad_(True) for t in (x, *(w for l in layers for w in l))]
    out = ct.FusedNarrowTrain.apply(True, *flat)
    out.sum().backward()
    grads = ct.fused_narrow_train_bwd_plain(layers, x, *want, torch.ones_like(out), True)
    assert torch.equal(flat[0].grad, grads[3]) and torch.equal(flat[2].grad, grads[1][0])
    assert ct.LAUNCHES == before


# ---------------------------------------------------------------------------
# fit in each regime against the JAX package
# ---------------------------------------------------------------------------

def _rel_frob(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("kernel", [False, True], ids=["scan", "kernel"])
def test_fit_tf32_matches_jax(data, windows, kernel):
    params = jax_init(jax.random.PRNGKey(0), input_dim=16, units=(8, 8))
    kw = dict(matmul_precision="tensorfloat32", recurrence_kernel=kernel)
    want = jax_fit(params, data.X_train, data.y_train, _cfg(jcfg, **kw), windows=windows,
                   jit_epoch=False)
    got = P.fit(P.from_numpy_tree(params, device="cpu"), data.X_train, data.y_train, _cfg(pcfg, **kw),
                windows=windows)
    np.testing.assert_allclose(got.history, want.history, rtol=1e-5, atol=0)
    for a, b in zip(jax.tree.leaves(P.to_numpy_tree(got.params)), jax.tree.leaves(want.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=0)


@pytest.mark.parametrize("units,band", [((8, 8), "narrow"), ((128,), "wide")], ids=["narrow", "wide"])
@pytest.mark.parametrize("kernel", [False, True], ids=["bf16_scan", "fused_kernel"])
def test_fit_bf16_matches_jax_within_the_fast_band(data, windows, kernel, units, band):
    """One epoch: 4 steps (narrow), 2 (wide, 16 windows)."""
    params = jax_init(jax.random.PRNGKey(0), input_dim=16, units=units)
    kw = dict(matmul_precision="bfloat16", recurrence_kernel=kernel, epochs=1)
    if band == "wide":
        windows = tuple(w[:2 * BATCH] for w in windows)
    want = jax_fit(params, data.X_train, data.y_train, _cfg(jcfg, **kw), windows=windows,
                   jit_epoch=False)
    got = P.fit(P.from_numpy_tree(params, device="cpu"), data.X_train, data.y_train, _cfg(pcfg, **kw),
                windows=windows)
    exact = P.fit(P.from_numpy_tree(params, device="cpu"), data.X_train, data.y_train,
                  _cfg(pcfg, recurrence_kernel=kernel), windows=windows)
    X = data.X_train[:, :256]
    pred_j = np.asarray(jax_apply(want.params, jnp.asarray(X[0])[None], return_sequences=True))[0, :, 0]
    pred = predict_full_run(got.params, X)
    err = _rel_frob(pred, pred_j)
    assert err <= FAST_BAND[band], err
    assert got.history != exact.history  # the bf16 regime is not the exact one
    np.testing.assert_allclose(got.history, want.history, rtol=FAST_BAND[band])


def test_fit_bf16_kernel_regime_equals_the_bf16_scan(data, windows):
    """On the CPU the kernel regime runs the bf16 plain versions and the
    scan regime the model's own products through the bf16 dot: the same
    operands rounded, so the same training within float32 sums."""
    params = P.from_numpy_tree(jax_init(jax.random.PRNGKey(4), input_dim=16, units=(8, 8)), device="cpu")
    runs = [P.fit(params, data.X_train, data.y_train,
                  _cfg(pcfg, matmul_precision="bfloat16", recurrence_kernel=k), windows=windows)
            for k in (False, True)]
    np.testing.assert_allclose(runs[1].history, runs[0].history, rtol=1e-5)


@pytest.mark.parametrize("matmul_precision", ["tensorfloat32", "bfloat16"])
def test_finetune_in_each_regime_matches_jax(data, windows, matmul_precision):
    """The σ fine-tune through the kernels (the dense view's reconstruction
    exact): TF32 within 1e-5 of the JAX run, bf16 within the narrow band."""
    dense = jax_init(jax.random.PRNGKey(1), input_dim=16, units=(8, 8))
    sj = jax_make_singular(dense, merged_kernel=False)
    kw = dict(matmul_precision=matmul_precision, recurrence_kernel=True)
    want = jax_finetune(sj, data.X_train, data.y_train, jcfg.FactorConfig(hoyer=0.01),
                        _cfg(jcfg, **kw), windows=windows)
    smodel = P.from_numpy_tree(sj, device="cpu")
    got = P.finetune(smodel, data.X_train, data.y_train, pcfg.FactorConfig(hoyer=0.01),
                     _cfg(pcfg, **kw), windows=windows)
    rtol = 1e-5 if matmul_precision == "tensorfloat32" else FAST_BAND["narrow"]
    np.testing.assert_allclose(got.history, want.history, rtol=rtol)
    for old, new in zip(smodel.layers, got.params.layers):
        assert torch.equal(old.wl, new.wl) and not torch.equal(old.ws, new.ws)  # σ moved, factors frozen


@pytest.mark.parametrize("matmul_precision", ["tensorfloat32", "bfloat16"])
def test_recovery_in_each_regime_is_gated(data, windows, matmul_precision):
    """recover_reduced_gated in each regime, through the kernels: never
    worse than the raw truncation on its (exact) validation."""
    model = P.from_numpy_tree(jax_init(jax.random.PRNGKey(2), input_dim=16, units=(8, 8)), device="cpu")
    red = P.make_reduced_model(P.make_singular_model(model, merged_kernel=False), rank=4)
    cfg = _cfg(pcfg, matmul_precision=matmul_precision, recurrence_kernel=True, epochs=1)
    val = (data.X_train[:, :256], data.y_train[:256])
    got, info = P.recover_reduced_gated(red, data.X_train, data.y_train, train_cfg=cfg,
                                        max_epochs=2, validation=val, windows=windows)
    assert np.isfinite(info["best_val_mse"]) and info["best_val_mse"] <= info["raw_val_mse"]
    assert len(info["trace"]) >= 1


# ---------------------------------------------------------------------------
# validation and the scope's settings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("matmul_precision", pcfg.TRAIN_PRECISIONS)
def test_validation_stays_exact_and_the_scope_restores_the_settings(data, windows, matmul_precision):
    model = P.from_numpy_tree(jax_init(jax.random.PRNGKey(3), input_dim=16, units=(8,)), device="cpu")
    val = (data.X_test, data.y_test)
    torch.set_float32_matmul_precision("medium")  # a caller's setting, kept around the fit
    try:
        got = P.fit(model, data.X_train, data.y_train,
                    _cfg(pcfg, matmul_precision=matmul_precision, epochs=1), windows=windows,
                    validation=val)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision("highest")
    assert not torch.backends.cuda.matmul.allow_tf32
    a, b = (torch.tensor(np.random.default_rng(9).normal(size=s).astype(np.float32)) for s in ((5, 6), (6, 3)))
    assert torch.equal(prec.dot(a, b), torch.matmul(a, b))  # no regime left behind
    pred = predict_full_run(got.params, data.X_test)
    want = float(np.mean(np.square(pred - data.y_test.reshape(-1))))
    assert got.val_history == [pytest.approx(want, rel=1e-6)]


def test_scope_routes_only_its_products():
    """Inside the bf16 scope dot rounds; plain torch.matmul (the
    reconstructions) stays exact; outside it dot is the plain product."""
    rng = np.random.default_rng(8)
    a, b = (torch.tensor(rng.normal(size=s).astype(np.float32)) for s in ((6, 9), (9, 4)))
    with prec.train_matmul_scope("bfloat16"):
        _assert_rel("dot", prec.dot(a, b), r(a.numpy()) @ r(b.numpy()))
        _assert_rel("matmul", torch.matmul(a, b), a.double().numpy() @ b.double().numpy())
        with prec.train_matmul_scope("float32"):
            assert torch.equal(prec.dot(a, b), torch.matmul(a, b))
        _assert_rel("dot after the inner scope", prec.dot(a, b), r(a.numpy()) @ r(b.numpy()))
    assert torch.equal(prec.dot(a, b), torch.matmul(a, b))
    with pytest.raises(ValueError, match="matmul_precision"):
        with prec.train_matmul_scope("float16"):
            pass
    with pytest.raises(ValueError, match="matmul_precision"):
        pcfg.check_train_config(dataclasses.replace(pcfg.TrainConfig(), matmul_precision="highest"))


def test_tf32_scope_is_one_setting_with_the_reconstructions_exact():
    """The TF32 regime turns TF32 on for the whole block (dot is the native
    product) and ``exact_products`` turns it off around its function, in
    the forward and in the backward, with the plain function's values and
    gradients; outside the TF32 scope it is the plain call."""
    seen = []

    def recon(left, sigma, right):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()))
        return torch.matmul(left * sigma, right)

    rng = np.random.default_rng(10)
    args = [torch.tensor(rng.normal(size=s).astype(np.float32), requires_grad=True)
            for s in ((6, 3), (3,), (3, 8))]
    g = torch.tensor(rng.normal(size=(6, 8)).astype(np.float32))
    want = recon(*args)
    want_grads = torch.autograd.grad(want, args, g)
    seen.clear()
    with prec.train_matmul_scope("tensorfloat32"):
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
        a, b = (t.detach() for t in args[::2])
        assert torch.equal(prec.dot(a, b), torch.matmul(a, b))
        out = prec.exact_products(recon, *args)
        grads = torch.autograd.grad(out, args, g)
    assert seen == [(False, "highest")] * 2  # the forward, and the backward's rerun
    assert torch.equal(out, want)
    for got_g, want_g in zip(grads, want_grads):
        torch.testing.assert_close(got_g, want_g, rtol=1e-6, atol=1e-6)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    seen.clear()
    with prec.train_matmul_scope("bfloat16"):
        prec.exact_products(recon, *args)
    assert seen == [(False, "highest")]
