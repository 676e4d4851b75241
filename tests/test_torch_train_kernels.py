"""Training kernels of the PyTorch port (svd_lstm_tpu_torch/ops/cuda_train.py).

On the CPU:

* the plain versions of K7 (narrow whole stack) and K9 (one wide layer)
  are held against the JAX package's Pallas kernels in interpret mode, on
  the same numpy inputs, after the JAX side's 128-lane padding is removed;
* K6 (the recurrence-only pair): its plain versions and its autograd
  Function against the JAX package's ``lstm_recurrence_trainable``
  (interpret mode) and JAX autodiff through it: h within 1e-5, dxp and dU
  within 1e-5 × their largest value;
* each autograd Function is held against torch autograd of the plain
  forward (an independent oracle), and gradchecked in float64;
* the training dispatch, forward and every gradient, against the JAX one;
* the wrappers' argument checks.

Tolerances: forwards atol 2e-5, rtol 1e-5 (those of
tests/test_torch_kernels.py: float32 on both sides, another summation
order); gradients atol 1e-5, rtol 1e-4, because a weight gradient sums T·B
products in another order than the reference does.

The ``cuda``-marked tests hold each CUDA kernel against its plain version
on the card, with the plain version disabled to prove there is no fallback,
and skip without a card. On a machine with a card:

    python -m pytest tests/test_torch_train_kernels.py -m cuda --noconftest -q
"""

import functools

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.io.checkpoint import NODE_TYPES, from_numpy_tree
from svd_lstm_tpu_torch.ops import cuda_train as ct

FWD = dict(atol=2e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)
LANE = 128


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _normal(rng, shape, scale=1.0):
    return rng.normal(scale=scale, size=shape).astype(np.float32)


def _layers_np(seed, units, d):
    """(W, U, b) per layer, weights scaled by 1/sqrt(fan-in) as trained ones are."""
    rng = np.random.default_rng(seed)
    out, din = [], d
    for n in units:
        out.append((_normal(rng, (din, 4 * n), din ** -0.5), _normal(rng, (n, 4 * n), n ** -0.5),
                    _normal(rng, (4 * n,), 0.1)))
        din = n
    return out


def _t(a, device="cpu", dtype=torch.float32):
    if isinstance(a, (tuple, list)):
        return [_t(v, device, dtype) for v in a]
    return torch.tensor(a, device=device, dtype=dtype)


def _close(got, want, tol=FWD, err_msg=""):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want), err_msg=err_msg, **tol)


def _jax_layers(layers):
    import jax.numpy as jnp
    from svd_lstm_tpu.models.lstm import LSTMLayerParams

    return tuple(LSTMLayerParams(*(jnp.asarray(a) for a in l)) for l in layers)


# ---------------------------------------------------------------------------
# CPU: K7 plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

NARROW_UNITS, NARROW_D, NARROW_B, NARROW_T = (8, 12, 5), 16, 8, 10  # B % 8 == 0 for JAX


@pytest.fixture(scope="module")
def narrow_case():
    """The same inputs through JAX _fused_fwd/_fused_bwd (interpret=True),
    unpadded: (layers, x, dh_last, hs, cs, dWs, dUs, dbs, dx)."""
    import jax.numpy as jnp
    from svd_lstm_tpu.ops.pallas_train_fused import _fused_bwd, _fused_fwd

    layers = _layers_np(0, NARROW_UNITS, NARROW_D)
    rng = np.random.default_rng(1)
    x = _normal(rng, (NARROW_T, NARROW_B, NARROW_D))
    dh = _normal(rng, (NARROW_T, NARROW_B, NARROW_UNITS[-1]))
    jl = _jax_layers(layers)
    h_all, c_all = _fused_fwd(jl, jnp.asarray(x), interpret=True)
    dh_p = jnp.zeros((NARROW_T, NARROW_B, LANE), jnp.float32).at[:, :, : NARROW_UNITS[-1]].set(dh)
    dWs, dUs, dbs, dx = _fused_bwd(jl, jnp.asarray(x), h_all, c_all, dh_p, interpret=True)
    hs = [np.asarray(h_all)[:, :, i * LANE : i * LANE + n] for i, n in enumerate(NARROW_UNITS)]
    cs = [np.asarray(c_all)[:, :, i * LANE : i * LANE + n] for i, n in enumerate(NARROW_UNITS)]
    return layers, x, dh, hs, cs, [np.asarray(g) for g in dWs], [np.asarray(g) for g in dUs], \
        [np.asarray(g) for g in dbs], np.asarray(dx)


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_narrow_fwd_matches_pallas(narrow_case, entry):
    layers, x, _, hs_j, cs_j, *_ = narrow_case
    fn = ct.fused_narrow_train_fwd_plain if entry == "plain" else ct.fused_narrow_train_fwd
    hs, cs = fn(_t(layers), _t(x))
    for i in range(len(layers)):
        _close(hs[i], hs_j[i], err_msg=f"h{i}")
        _close(cs[i], cs_j[i], err_msg=f"c{i}")


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_narrow_bwd_matches_pallas(narrow_case, entry):
    layers, x, dh, hs_j, cs_j, dWs_j, dUs_j, dbs_j, dx_j = narrow_case
    fn = ct.fused_narrow_train_bwd_plain if entry == "plain" else ct.fused_narrow_train_bwd
    dWs, dUs, dbs, dx = fn(_t(layers), _t(x), _t(hs_j), _t(cs_j), _t(dh))
    for i in range(len(layers)):
        _close(dWs[i], dWs_j[i], GRAD, f"dW{i}")
        _close(dUs[i], dUs_j[i], GRAD, f"dU{i}")
        _close(dbs[i], dbs_j[i], GRAD, f"db{i}")
    _close(dx, dx_j, GRAD, "dx")


# ---------------------------------------------------------------------------
# CPU: K9 plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

WIDE_N, WIDE_B, WIDE_T = 128, 8, 6


def _wide_case(seed, din):
    rng = np.random.default_rng(seed)
    W, U, b = _layers_np(seed, (WIDE_N,), din)[0]
    return _normal(rng, (WIDE_T, WIDE_B, din)), W, U, b, _normal(rng, (WIDE_T, WIDE_B, WIDE_N))


@pytest.mark.parametrize("din", [WIDE_N, 16], ids=["square", "layer0"])
def test_wide_layer_matches_pallas(din):
    """JAX takes layer 0 zero-padded to n (x's columns, W's rows); the port
    takes d as it is, so the pad's gradient rows are dropped."""
    import jax.numpy as jnp
    from svd_lstm_tpu.ops.pallas_train_wide import _wide_bwd, _wide_fwd

    x, W, U, b, dh = _wide_case(2, din)
    pad = WIDE_N - din
    xj = jnp.asarray(np.pad(x, ((0, 0), (0, 0), (0, pad))))
    Wj = jnp.asarray(np.pad(W, ((0, pad), (0, 0))))
    h_j, c_j = _wide_fwd(xj, Wj, jnp.asarray(U), jnp.asarray(b), 8, interpret=True)
    dx_j, dW_j, dU_j, db_j = _wide_bwd(xj, Wj, jnp.asarray(U), jnp.asarray(b), h_j, c_j,
                                       jnp.asarray(dh), 8, interpret=True)
    for fwd, bwd in ((ct.wide_layer_fwd_plain, ct.wide_layer_bwd_plain),
                     (ct.wide_layer_fwd, ct.wide_layer_bwd)):
        h, c = fwd(*_t([x, W, U, b]))
        _close(h, h_j, err_msg="h")
        _close(c, c_j, err_msg="c")
        dx, dW, dU, db = bwd(*_t([x, W, U, b]), h, c, _t(dh))
        _close(dx, np.asarray(dx_j)[:, :, :din], GRAD, "dx")
        _close(dW, np.asarray(dW_j)[:din], GRAD, "dW")
        _close(dU, dU_j, GRAD, "dU")
        _close(db, db_j, GRAD, "db")


# ---------------------------------------------------------------------------
# CPU: K6 plain versions and autograd Function against the JAX package
# ---------------------------------------------------------------------------

def _recurrence_case(seed, T, B, n=WIDE_N):
    """xp, U, cot as the JAX package's own K6 test draws them (U · 0.05)."""
    rng = np.random.default_rng(seed)
    return (_normal(rng, (T, B, 4 * n)), _normal(rng, (n, 4 * n), 0.05),
            _normal(rng, (T, B, n)))


def _scaled(g):
    g = np.asarray(g)
    return dict(atol=1e-5 * np.abs(g).max(), rtol=0)


@pytest.mark.parametrize("T,B", [(5, 8), (4, 12)])
def test_recurrence_train_matches_jax(T, B):
    import jax
    import jax.numpy as jnp
    from svd_lstm_tpu.ops.pallas_train import lstm_recurrence_trainable as jax_trainable

    xp, U, cot = _recurrence_case(23 + B, T, B)

    def loss(xp, U):
        return jnp.sum(jax_trainable(xp, U, 8, True) * cot)

    h_j = np.asarray(jax_trainable(jnp.asarray(xp), jnp.asarray(U), 8, True))
    dxp_j, dU_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(xp), jnp.asarray(U))
    for fwd, bwd in ((ct.lstm_recurrence_train_fwd_plain, ct.lstm_recurrence_train_bwd_plain),
                     (ct.lstm_recurrence_train_fwd, ct.lstm_recurrence_train_bwd)):
        h, c = fwd(*_t([xp, U]))
        _close(h, h_j, dict(atol=1e-5, rtol=0), "h")
        dxp, dU = bwd(*_t([xp, U]), h, c, _t(cot))
        _close(dxp, dxp_j, _scaled(dxp_j), "dxp")
        _close(dU, dU_j, _scaled(dU_j), "dU")
    out, (dxp, dU) = _loss_and_grads(functools.partial(ct.RecurrenceTrain.apply, False), _t([xp, U]), _t(cot))
    _close(out, h_j, dict(atol=1e-5, rtol=0), "Function h")
    _close(dxp, dxp_j, _scaled(dxp_j), "Function dxp")
    _close(dU, dU_j, _scaled(dU_j), "Function dU")


# ---------------------------------------------------------------------------
# CPU: autograd Functions against autograd of the plain forward
# ---------------------------------------------------------------------------

def _loss_and_grads(fn, inputs, cot):
    inputs = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*inputs)
    grads = torch.autograd.grad((out * cot).sum(), inputs)
    return out.detach(), grads


def test_fused_narrow_function_matches_autograd_of_plain():
    layers = _t(_layers_np(3, (6, 9, 7), 5))
    rng = np.random.default_rng(4)
    x = _t(_normal(rng, (7, 3, 5)))
    cot = _t(_normal(rng, (7, 3, 7)))
    flat = [x, *(w for l in layers for w in l)]

    def oracle(x, *w):
        return ct.fused_narrow_train_fwd_plain([w[i : i + 3] for i in range(0, len(w), 3)], x)[0][-1]

    out_k, g_k = _loss_and_grads(functools.partial(ct.FusedNarrowTrain.apply, False), flat, cot)
    out_r, g_r = _loss_and_grads(oracle, flat, cot)
    _close(out_k, out_r.numpy())
    for i, (a, r) in enumerate(zip(g_k, g_r)):
        _close(a, r.numpy(), GRAD, f"input {i}")


def test_wide_layer_function_matches_autograd_of_plain():
    x, W, U, b, cot = _wide_case(5, 24)
    flat = _t([x, W, U, b])
    out_k, g_k = _loss_and_grads(functools.partial(ct.WideLayerTrain.apply, False), flat, _t(cot))
    out_r, g_r = _loss_and_grads(lambda *a: ct.wide_layer_fwd_plain(*a)[0], flat, _t(cot))
    _close(out_k, out_r.numpy())
    for name, a, r in zip("xWUb", g_k, g_r):
        _close(a, r.numpy(), GRAD, name)


def test_recurrence_function_matches_autograd_of_plain():
    xp, U, cot = _recurrence_case(24, 6, 5)
    flat = _t([xp, U])
    out_k, g_k = _loss_and_grads(functools.partial(ct.RecurrenceTrain.apply, False), flat, _t(cot))
    out_r, g_r = _loss_and_grads(lambda *a: ct.lstm_recurrence_train_fwd_plain(*a)[0], flat, _t(cot))
    _close(out_k, out_r.numpy())
    for name, a, r in zip(("xp", "U"), g_k, g_r):
        _close(a, r.numpy(), GRAD, name)


def test_recurrence_gradcheck_float64():
    xp, U, _ = _recurrence_case(25, 2, 2)
    inputs = [t.requires_grad_(True) for t in _t([xp, U], dtype=torch.float64)]
    assert torch.autograd.gradcheck(functools.partial(ct.RecurrenceTrain.apply, False), inputs, fast_mode=True)


def test_fused_narrow_gradcheck_float64():
    layers = _t(_layers_np(6, (2, 3), 3), dtype=torch.float64)
    x = _t(_normal(np.random.default_rng(7), (3, 2, 3)), dtype=torch.float64)
    inputs = [t.requires_grad_(True) for t in (x, *(w for l in layers for w in l))]
    assert torch.autograd.gradcheck(functools.partial(ct.FusedNarrowTrain.apply, False), inputs)


def test_wide_layer_gradcheck_float64():
    rng = np.random.default_rng(8)
    W, U, b = _layers_np(8, (WIDE_N,), 3)[0]
    inputs = [t.requires_grad_(True)
              for t in _t([_normal(rng, (2, 2, 3)), W, U, b], dtype=torch.float64)]
    assert torch.autograd.gradcheck(functools.partial(ct.WideLayerTrain.apply, False), inputs, fast_mode=True)


# ---------------------------------------------------------------------------
# CPU: the training dispatch against the JAX one
# ---------------------------------------------------------------------------

def _stack_tree(layers, seed, head=1):
    rng = np.random.default_rng(seed)
    n = layers[-1][1].shape[0]
    return NODE_TYPES["StackedLSTMParams"](
        layers=tuple(NODE_TYPES["LSTMLayerParams"](*l) for l in layers),
        head=NODE_TYPES["DenseParams"](w=_normal(rng, (n, head), 0.3), b=_normal(rng, (head,))),
    )


@pytest.mark.parametrize("units,d", [((8, 12, 5), 16), ((256, 256), 6), ((256,), 6), ((256, 40), 6)],
                         ids=["narrow", "uniform", "one-aligned", "mixed"])
def test_dispatch_matches_jax(units, d):
    import jax
    import jax.numpy as jnp
    from svd_lstm_tpu.models.lstm import DenseParams, LSTMLayerParams, StackedLSTMParams
    from svd_lstm_tpu.ops.pallas_train import stacked_lstm_apply_fast_train as jax_apply

    tree = _stack_tree(_layers_np(9, units, d), 10)
    params = StackedLSTMParams(
        layers=tuple(LSTMLayerParams(*(jnp.asarray(a) for a in l)) for l in tree.layers),
        head=DenseParams(jnp.asarray(tree.head.w), jnp.asarray(tree.head.b)),
    )
    x = _normal(np.random.default_rng(11), (8, 7, d))

    def jloss(p):
        return jnp.mean(jax_apply(p, jnp.asarray(x), return_sequences=False, interpret=True) ** 2)

    y_j = jax_apply(params, jnp.asarray(x), interpret=True)
    g_j = jax.grad(jloss)(params)

    model = from_numpy_tree(tree, device="cpu")
    y = ct.stacked_lstm_apply_fast_train(model, _t(x))
    _close(y, y_j)
    loss = torch.mean(ct.stacked_lstm_apply_fast_train(model, _t(x), return_sequences=False) ** 2)
    loss.backward()
    for l, lj in zip(model.layers, g_j.layers):
        for name in ("W", "U", "b"):
            _close(getattr(l, name).grad, getattr(lj, name), GRAD, name)
    _close(model.head.w.grad, g_j.head.w, GRAD, "head.w")
    _close(model.head.b.grad, g_j.head.b, GRAD, "head.b")


def test_dispatch_routes():
    """Narrow -> K7, uniform wide -> K9, exactly one 128-aligned layer ->
    K6 on it, anything else -> the plain scan."""
    rng = np.random.default_rng(12)

    def model(units, d):
        return from_numpy_tree(_stack_tree(_layers_np(13, units, d), 14), device="cpu"), _t(_normal(rng, (2, 3, d)))

    calls = []
    real = {name: getattr(ct, name) for name in ("fused_narrow_train_apply", "wide_layer_trainable",
                                                 "lstm_recurrence_trainable")}
    try:
        for name, fn in real.items():
            setattr(ct, name, lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
        k6 = "lstm_recurrence_trainable"
        for units, d, want in (((8, 8), 4, "fused_narrow_train_apply"),
                               ((128, 128), 4, "fused_narrow_train_apply"),
                               ((256, 256), 4, "wide_layer_trainable"),
                               ((256,), 4, k6), ((128, 136), 4, k6), ((8, 256), 4, k6),
                               ((136, 144), 4, None), ((256, 384), 4, None)):
            calls.clear()
            m, x = model(units, d)
            y = ct.stacked_lstm_apply_fast_train(m, x)
            assert tuple(y.shape) == (2, 3, 1)
            assert (calls[0] if calls else None) == want, units
    finally:
        for name, fn in real.items():
            setattr(ct, name, fn)


# ---------------------------------------------------------------------------
# CPU: wrapper contract
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = dict(ct.LAUNCHES)
    layers = _t(_layers_np(15, (4,), 3))
    x = _t(_normal(np.random.default_rng(15), (3, 2, 3)))
    hs, cs = ct.fused_narrow_train_fwd(layers, x)
    ct.fused_narrow_train_bwd(layers, x, hs, cs, torch.ones_like(hs[-1]))
    W, U, b = _t(_layers_np(15, (WIDE_N,), 3)[0])
    h, c = ct.wide_layer_fwd(x, W, U, b)
    ct.wide_layer_bwd(x, W, U, b, h, c, torch.ones_like(h))
    xp = _t(_normal(np.random.default_rng(15), (3, 2, 4 * WIDE_N)))
    h, c = ct.lstm_recurrence_train_fwd(xp, U)
    ct.lstm_recurrence_train_bwd(xp, U, h, c, torch.ones_like(h))
    assert ct.LAUNCHES == before


def test_wrappers_reject_bad_arguments():
    layers = _t(_layers_np(16, (4, 4), 3))
    x = _t(_normal(np.random.default_rng(16), (3, 2, 3)))
    with pytest.raises(TypeError, match="float32"):
        ct.fused_narrow_train_fwd(layers, x.half())
    with pytest.raises(ValueError, match="shape"):
        ct.fused_narrow_train_fwd([layers[0], (layers[1][0][:3], *layers[1][1:])], x)
    with pytest.raises(ValueError, match="contiguous"):
        ct.fused_narrow_train_fwd([(layers[0][0].t().contiguous().t(), *layers[0][1:])], x)
    with pytest.raises(ValueError, match="empty"):
        ct.fused_narrow_train_fwd(layers, x[:0])
    wide = _t(_layers_np(16, (136,), 3))
    with pytest.raises(ValueError, match="at most 128"):
        ct.fused_narrow_train_fwd(wide, x)
    with pytest.raises(ValueError, match="layers"):
        ct.fused_narrow_train_fwd(_t(_layers_np(16, (2,) * (ct.MAX_LAYERS + 1), 3)), x)
    hs, cs = ct.fused_narrow_train_fwd(layers, x)
    with pytest.raises(ValueError, match="dh_last"):
        ct.fused_narrow_train_bwd(layers, x, hs, cs, torch.ones((3, 2, 5)))
    with pytest.raises(ValueError, match="n % 128"):
        ct.wide_layer_fwd(x, *wide[0])
    W, U, b = _t(_layers_np(16, (WIDE_N,), 3)[0])
    h, c = ct.wide_layer_fwd(x, W, U, b)
    with pytest.raises(ValueError, match="dh_seq"):
        ct.wide_layer_bwd(x, W, U, b, h, c, torch.ones((3, 2, 5)))
    with pytest.raises(ValueError, match="n % 128"):
        ct.lstm_recurrence_train_fwd(torch.zeros((3, 2, 4 * 136)), wide[0][1])
    with pytest.raises(ValueError, match="xp"):
        ct.lstm_recurrence_train_fwd(torch.zeros((3, 2, 5)), U)
    xp = torch.zeros((3, 2, 4 * WIDE_N))
    h, c = ct.lstm_recurrence_train_fwd(xp, U)
    with pytest.raises(ValueError, match="dh_seq"):
        ct.lstm_recurrence_train_bwd(xp, U, h, c, torch.ones((3, 2, 5)))


def test_wrappers_reject_other_devices():
    layers = _t(_layers_np(17, (4,), 3), "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ct.fused_narrow_train_fwd(layers, _t(np.zeros((3, 2, 3), np.float32), "meta"))
    with pytest.raises(ValueError, match="different devices"):
        ct.fused_narrow_train_fwd(layers, _t(np.zeros((3, 2, 3), np.float32)))


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

def _launched(wrapper, fn, bf16=False):
    name = wrapper.__name__ + ("_fast" if bf16 else "")
    before = dict(ct.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    assert ct.LAUNCHES == {**before, name: before[name] + 1}
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("units,d,B,T", [
    ((8, 12, 5), 16, 8, 20), ((40, 40, 40, 40), 16, 32, 20), ((128, 30), 128, 6, 20),
    # the forward's edges: T < L (the wavefront's edge layers idle), one
    # layer, 8 layers, 8x128 at 1024 threads (one lane a unit), uneven
    # widths with d > n, B = 1 and B % 4 != 0; with the lane rule's choices
    # (tests/test_torch_narrow_fwd.py) these reach S = 8 and 4 with the
    # weights staged, and S = 8, 4, 2, 1 from the wrapper's copy in global
    # memory (4x100, 1x128, 128+30, 8x128)
    ((40, 40, 40, 40), 16, 8, 1), ((40, 40, 40, 40), 16, 8, 3),
    ((24,), 16, 5, 20), ((16,) * 8, 16, 8, 12), ((128,) * 8, 128, 4, 6),
    ((12, 20, 9), 48, 1, 10), ((6, 7, 5), 20, 7, 9),
    ((100,) * 4, 16, 5, 3), ((128,), 128, 6, 8),
    # the backward's rule (tests/test_torch_narrow_bwd.py) reaches S = 8
    # and 4 staged, S = 4, 2, 1 from the global copy (1x128, 4x100 and
    # 128+30, 8x128 with d = 128, where dx shares layer 0's groups) with
    # the cases above; here S = 2 staged, S = 8 from the global copy, and
    # S = 4 from the global copy on stacks of K8's route with d = 16 and
    # 128 (S = 1 never fits staged)
    ((17,) * 8, 128, 6, 5), ((110,), 18, 7, 6), ((42, 42, 42, 42), 16, 9, 7),
    ((48, 48), 128, 5, 6),
])
def test_cuda_fused_narrow_matches_plain(cuda, units, d, B, T, monkeypatch):
    layers = _t(_layers_np(18, units, d), cuda)
    rng = np.random.default_rng(19)
    x = _t(_normal(rng, (T, B, d)), cuda)
    dh = _t(_normal(rng, (T, B, units[-1])), cuda)
    hs_p, cs_p = ct.fused_narrow_train_fwd_plain(layers, x)
    grads_p = ct.fused_narrow_train_bwd_plain(layers, x, hs_p, cs_p, dh)
    monkeypatch.setattr(ct, "fused_narrow_train_fwd_plain", None)  # no fallback on the card
    monkeypatch.setattr(ct, "fused_narrow_train_bwd_plain", None)
    hs, cs = _launched(ct.fused_narrow_train_fwd, lambda: ct.fused_narrow_train_fwd(layers, x))
    for a, r in zip(hs + cs, hs_p + cs_p):
        _close(a, r.cpu().numpy())
    grads = _launched(ct.fused_narrow_train_bwd,
                      lambda: ct.fused_narrow_train_bwd(layers, x, hs_p, cs_p, dh))
    for got, want in zip(grads[:3], grads_p[:3]):
        for a, r in zip(got, want):
            _close(a, r.cpu().numpy(), GRAD)
    _close(grads[3], grads_p[3].cpu().numpy(), GRAD)


@pytest.mark.cuda
@pytest.mark.parametrize("compact,units,d", [
    (False, (12, 9, 5), 7),   # S = 8, staged
    (False, (128, 30), 127),  # S = 4, from the global copy
    (True, (12, 9, 5), 7),    # K8
])
def test_cuda_narrow_fwd_keeps_a_diverged_layer_to_itself(cuda, compact, units, d):
    """A top layer whose h is NaN leaves the layers below as the plain
    version computes them: no lane's dot reads past its layer's din + n
    inputs into the next layer's h (din + n is no multiple of S here)."""
    layers = _layers_np(29, units, d)
    layers[-1][2][:] = np.nan  # the top layer's bias
    layers = _t(layers, cuda)
    x = _t(_normal(np.random.default_rng(30), (5, 6, d)), cuda)
    hs_p, cs_p = ct.fused_narrow_train_fwd_plain(layers, x)
    wrapper = ct.fused_narrow_train_compact_fwd if compact else ct.fused_narrow_train_fwd
    hs, cs = _launched(wrapper, lambda: wrapper(layers, x))
    assert torch.isnan(hs[-1]).all()
    for a, r in zip(hs[:-1] + cs[:-1], hs_p[:-1] + cs_p[:-1]):
        _close(a, r.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("din,B", [(128, 8), (16, 20), (256, 32)])
def test_cuda_wide_layer_matches_plain(cuda, din, B, monkeypatch):
    n = 256 if din == 256 else WIDE_N
    W, U, b = _t(_layers_np(20, (n,), din)[0], cuda)
    rng = np.random.default_rng(21)
    x = _t(_normal(rng, (12, B, din)), cuda)
    dh = _t(_normal(rng, (12, B, n)), cuda)
    h_p, c_p = ct.wide_layer_fwd_plain(x, W, U, b)
    grads_p = ct.wide_layer_bwd_plain(x, W, U, b, h_p, c_p, dh)
    monkeypatch.setattr(ct, "wide_layer_fwd_plain", None)
    monkeypatch.setattr(ct, "wide_layer_bwd_plain", None)
    h, c = _launched(ct.wide_layer_fwd, lambda: ct.wide_layer_fwd(x, W, U, b))
    _close(h, h_p.cpu().numpy())
    _close(c, c_p.cpu().numpy())
    grads = _launched(ct.wide_layer_bwd, lambda: ct.wide_layer_bwd(x, W, U, b, h_p, c_p, dh))
    for name, a, r in zip(("dx", "dW", "dU", "db"), grads, grads_p):
        _close(a, r.cpu().numpy(), GRAD, name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(128, 8), (128, 20), (256, 33)])
def test_cuda_recurrence_train_matches_plain(cuda, n, B, monkeypatch):
    xp, U, dh = _t(_recurrence_case(26, 12, B, n), cuda)
    h_p, c_p = ct.lstm_recurrence_train_fwd_plain(xp, U)
    grads_p = ct.lstm_recurrence_train_bwd_plain(xp, U, h_p, c_p, dh)
    monkeypatch.setattr(ct, "lstm_recurrence_train_fwd_plain", None)  # no fallback on the card
    monkeypatch.setattr(ct, "lstm_recurrence_train_bwd_plain", None)
    h, c = _launched(ct.lstm_recurrence_train_fwd, lambda: ct.lstm_recurrence_train_fwd(xp, U))
    _close(h, h_p.cpu().numpy())
    _close(c, c_p.cpu().numpy())
    grads = _launched(ct.lstm_recurrence_train_bwd,
                      lambda: ct.lstm_recurrence_train_bwd(xp, U, h_p, c_p, dh))
    for name, a, r in zip(("dxp", "dU"), grads, grads_p):
        _close(a, r.cpu().numpy(), GRAD, name)


# the four-phase backward of K9 and K6 (R: z, C: the dh chain, X: dx, G: the
# weight gradients) at the shapes its rule must take: (n, d, B, T) with
# ragged B (1, 17, 130: masked row tiles; 130 and 600: more than one row
# tile a CTA; 2048: the chain in two launches), T = 1 (no step reads dz_T),
# n = 128 and 256 (fewer unit groups), n = 1024 (U from the global copy), n
# = 2176 and 4352 on 132 SMs (wider unit groups: 16 x 32, 8 x 64), d = 16
# and 7 (K not a multiple of the GEMM's chunk)
WIDE_BWD_CASES = [
    (512, 16, 1, 5), (512, 512, 17, 4), (512, 16, 130, 3), (512, 16, 600, 2),
    (256, 64, 256, 3), (128, 16, 33, 1), (128, 7, 9, 4), (1024, 128, 20, 3),
    (512, 16, 2048, 2), (2176, 16, 20, 2), (4352, 16, 9, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,B,T", WIDE_BWD_CASES)
def test_cuda_wide_bwd_matches_plain(cuda, n, d, B, T, monkeypatch):
    W, U, b = _t(_layers_np(40 + n + B, (n,), d)[0], cuda)
    rng = np.random.default_rng(41 + B)
    x = _t(_normal(rng, (T, B, d)), cuda)
    dh = _t(_normal(rng, (T, B, n)), cuda)
    plan = ct.chain_plan(B, n, ct.sm_count(cuda))
    assert plan.staged == (n <= 512)
    h_p, c_p = ct.wide_layer_fwd_plain(x, W, U, b)
    grads_p = ct.wide_layer_bwd_plain(x, W, U, b, h_p, c_p, dh)
    xp = (torch.matmul(x, W) + b).contiguous()
    rec_p = ct.lstm_recurrence_train_bwd_plain(xp, U, h_p, c_p, dh)
    monkeypatch.setattr(ct, "wide_layer_bwd_plain", None)  # no fallback on the card
    monkeypatch.setattr(ct, "lstm_recurrence_train_bwd_plain", None)
    grads = _launched(ct.wide_layer_bwd, lambda: ct.wide_layer_bwd(x, W, U, b, h_p, c_p, dh))
    for name, a, r in zip(("dx", "dW", "dU", "db"), grads, grads_p):
        _close(a, r.cpu().numpy(), GRAD, name)
    rec = _launched(ct.lstm_recurrence_train_bwd,
                    lambda: ct.lstm_recurrence_train_bwd(xp, U, h_p, c_p, dh))
    for name, a, r in zip(("dxp", "dU"), rec, rec_p):
        _close(a, r.cpu().numpy(), GRAD, name)


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
def test_cuda_wide_bwd_weight_homes_match_plain(cuda, staged):
    """Phase C with U staged and from the global copy at one shape (the
    rule stages it there), forced past the rule."""
    n, d, B, T = 256, 16, 40, 4
    W, U, b = _t(_layers_np(50, (n,), d)[0], cuda)
    rng = np.random.default_rng(51)
    x = _t(_normal(rng, (T, B, d)), cuda)
    dh = _t(_normal(rng, (T, B, n)), cuda)
    h_p, c_p = ct.wide_layer_fwd_plain(x, W, U, b)
    plan = ct.chain_plan(B, n, ct.sm_count(cuda))
    assert plan.staged
    plan = plan._replace(staged=staged, smem_bytes=ct.chain_smem_bytes(n, plan.rows, plan.units, staged))
    xp = (torch.matmul(x, W) + b).contiguous()
    for inp, Wi, bi, plain in ((x, W, b, ct.wide_layer_bwd_plain(x, W, U, b, h_p, c_p, dh)),
                               (xp, None, None, ct.lstm_recurrence_train_bwd_plain(xp, U, h_p, c_p, dh))):
        z = ct.phase_r(inp, Wi, U, bi, h_p)
        dz = torch.empty_like(z)
        ct.phase_c(z, U.t().contiguous(), c_p, dh, dz, plan)
        grads = (dz, ct.phase_g(None, h_p, dz, ct.sm_count(cuda))) if Wi is None else \
            (ct.phase_x(dz, W), *ct.phase_g(x, h_p, dz, ct.sm_count(cuda)))
        torch.cuda.synchronize()
        for i, (a, r) in enumerate(zip(grads, plain)):
            _close(a, r.cpu().numpy(), GRAD, f"gradient {i}")


@pytest.mark.cuda
def test_cuda_wide_bwd_refuses_a_grid_that_cannot_be_co_resident(cuda):
    """A chain grid larger than the card holds at once is refused by the
    launcher (cudaErrorCooperativeLaunchTooLarge), not run another way; the
    rule raises before it for a width whose unit groups alone overflow."""
    n, B, T = 512, 256, 2
    sms = ct.sm_count(cuda)
    U = torch.zeros((n, 4 * n), device=cuda)
    z = torch.zeros((T, B, 4 * n), device=cuda)
    c = torch.zeros((T, B, n), device=cuda)
    plan = ct.chain_plan(B, n, sms)
    forged = plan._replace(row_groups=-(-B // plan.rows))  # 8 row groups: 256 CTAs
    assert forged.ctas > sms
    with pytest.raises(RuntimeError, match="cudaError"):
        ct.phase_c(z, U.t().contiguous(), c, c, torch.empty_like(z), forged)
    with pytest.raises(ValueError, match="co-resident"):
        ct.chain_plan(B, 64 * sms + 128, sms)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_float64(cuda):
    layers = _t(_layers_np(22, (4,), 3), cuda, torch.float64)
    with pytest.raises(TypeError, match="float32"):
        ct.fused_narrow_train_fwd(layers, _t(np.zeros((3, 2, 3)), cuda, torch.float64))


# ---------------------------------------------------------------------------
# on the card: the bf16-operand variants (K7f, K8f, K9f, K6f) against their
# plain bf16 versions
# ---------------------------------------------------------------------------

def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(v, 1e-30))) - 7)


def _close_fast(name, got, plain, plain64):
    """A bf16 variant's output against its plain bf16 version: within 2 bf16
    ulps of the plain output's largest value or twice the plain float32
    version's distance from the same arithmetic in float64, whichever is
    larger (the kernel sums in another order, which can flip a bf16
    rounding of h or dz, and a flip carries on through the later steps)."""
    drift = float((plain.double() - plain64).abs().max())
    tol = max(2 * _bf16_ulp(float(plain.abs().max())), 2 * drift)
    err = float((got.double() - plain.double()).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= tol, (name, err, tol)


def _double(tensors):
    return [_double(t) if isinstance(t, (list, tuple)) else t.double() for t in tensors]


@pytest.mark.cuda
@pytest.mark.parametrize("units,d,B,T,compact", [
    # run A's stack and K8f's route at B = 128 (the weights in registers both
    # ways), the global copy (4x100, 128+30 with d = 128, 8x128, 2x64; 8x17
    # with d = 128, B < 8), three and one layers, B % 8 != 0, widths not a
    # multiple of 16 (4x30, 2x15 with d = 15, 4x20), T < L
    ((40, 40, 40, 40), 16, 32, 20, False), ((40, 40, 40, 40), 16, 128, 12, True),
    ((100,) * 4, 16, 5, 6, False), ((128, 30), 128, 6, 10, False), ((8, 12, 5), 16, 8, 20, False),
    ((24,), 16, 7, 9, False), ((30, 30, 30, 30), 16, 130, 8, True),
    ((64, 64), 16, 9, 7, False), ((17,) * 8, 128, 3, 5, False), ((15, 15), 15, 11, 6, False),
    ((20, 20, 20, 20), 16, 1, 2, False), ((128,) * 8, 128, 4, 3, False),
])
def test_cuda_fused_narrow_fast_matches_plain(cuda, units, d, B, T, compact, monkeypatch):
    fwd = ct.fused_narrow_train_compact_fwd if compact else ct.fused_narrow_train_fwd
    bwd = ct.fused_narrow_train_compact_bwd if compact else ct.fused_narrow_train_bwd
    layers = _t(_layers_np(30, units, d), cuda)
    rng = np.random.default_rng(31)
    x = _t(_normal(rng, (T, B, d)), cuda)
    dh = _t(_normal(rng, (T, B, units[-1])), cuda)
    hs_p, cs_p = ct.fused_narrow_train_fwd_plain(layers, x, True)
    hs64, cs64 = ct.fused_narrow_train_fwd_plain(_double(layers), x.double(), True)
    grads_p = ct.fused_narrow_train_bwd_plain(layers, x, hs_p, cs_p, dh, True)
    grads64 = ct.fused_narrow_train_bwd_plain(_double(layers), x.double(), _double(hs_p),
                                              _double(cs_p), dh.double(), True)
    for name in ("fused_narrow_train_fwd_plain", "fused_narrow_train_bwd_plain",
                 "fused_narrow_train_compact_fwd_plain", "fused_narrow_train_compact_bwd_plain"):
        monkeypatch.setattr(ct, name, None)  # no fallback on the card
    hs, cs = _launched(fwd, lambda: fwd(layers, x, True), bf16=True)
    for i, (a, r, r64) in enumerate(zip(hs + cs, hs_p + cs_p, hs64 + cs64)):
        _close_fast(f"state {i}", a, r, r64)
    grads = _launched(bwd, lambda: bwd(layers, x, hs_p, cs_p, dh, True), bf16=True)
    for k, (got, want, want64) in enumerate(zip(grads[:3], grads_p[:3], grads64[:3])):
        for i, (a, r, r64) in enumerate(zip(got, want, want64)):
            _close_fast(f"{'dW dU db'.split()[k]}{i}", a, r, r64)
    _close_fast("dx", grads[3], grads_p[3], grads64[3])


@pytest.mark.cuda
@pytest.mark.parametrize("n,din,B", [(128, 16, 20), (256, 256, 33), (512, 512, 128)])
def test_cuda_wide_layer_fast_matches_plain(cuda, n, din, B, monkeypatch):
    W, U, b = _t(_layers_np(32, (n,), din)[0], cuda)
    rng = np.random.default_rng(33)
    x = _t(_normal(rng, (12, B, din)), cuda)
    dh = _t(_normal(rng, (12, B, n)), cuda)
    h_p, c_p = ct.wide_layer_fwd_plain(x, W, U, b, True)
    h64, c64 = ct.wide_layer_fwd_plain(*_double([x, W, U, b]), True)
    grads_p = ct.wide_layer_bwd_plain(x, W, U, b, h_p, c_p, dh, True)
    grads64 = ct.wide_layer_bwd_plain(*_double([x, W, U, b, h_p, c_p, dh]), True)
    monkeypatch.setattr(ct, "wide_layer_fwd_plain", None)
    monkeypatch.setattr(ct, "wide_layer_bwd_plain", None)
    h, c = _launched(ct.wide_layer_fwd, lambda: ct.wide_layer_fwd(x, W, U, b, True), bf16=True)
    _close_fast("h", h, h_p, h64)
    _close_fast("c", c, c_p, c64)
    grads = _launched(ct.wide_layer_bwd, lambda: ct.wide_layer_bwd(x, W, U, b, h_p, c_p, dh, True),
                      bf16=True)
    for name, a, r, r64 in zip(("dx", "dW", "dU", "db"), grads, grads_p, grads64):
        _close_fast(name, a, r, r64)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(128, 20), (512, 128)])
def test_cuda_recurrence_train_fast_matches_plain(cuda, n, B, monkeypatch):
    xp, U, dh = _t(_recurrence_case(34, 12, B, n), cuda)
    h_p, c_p = ct.lstm_recurrence_train_fwd_plain(xp, U, True)
    h64, c64 = ct.lstm_recurrence_train_fwd_plain(xp.double(), U.double(), True)
    grads_p = ct.lstm_recurrence_train_bwd_plain(xp, U, h_p, c_p, dh, True)
    grads64 = ct.lstm_recurrence_train_bwd_plain(*_double([xp, U, h_p, c_p, dh]), True)
    monkeypatch.setattr(ct, "lstm_recurrence_train_fwd_plain", None)  # no fallback on the card
    monkeypatch.setattr(ct, "lstm_recurrence_train_bwd_plain", None)
    h, c = _launched(ct.lstm_recurrence_train_fwd, lambda: ct.lstm_recurrence_train_fwd(xp, U, True),
                     bf16=True)
    _close_fast("h", h, h_p, h64)
    _close_fast("c", c, c_p, c64)
    grads = _launched(ct.lstm_recurrence_train_bwd,
                      lambda: ct.lstm_recurrence_train_bwd(xp, U, h_p, c_p, dh, True), bf16=True)
    for name, a, r, r64 in zip(("dxp", "dU"), grads, grads_p, grads64):
        _close_fast(name, a, r, r64)


@pytest.mark.cuda
@pytest.mark.parametrize("units,kind", [((40, 40), "fused_narrow_train"), ((256, 256), "wide_layer"),
                                        ((256,), "lstm_recurrence_train")])
def test_cuda_dispatch_fast_launches_the_fast_kernels(cuda, units, kind):
    """The dispatch with bf16 launches the _fast variants and no float32
    kernel (K7f; K9f on a uniform wide stack; K6f on one aligned layer)."""
    m = from_numpy_tree(_stack_tree(_layers_np(35, units, 16), 36), device=cuda)
    x = _t(_normal(np.random.default_rng(37), (8, 10, 16)), cuda)
    before = dict(ct.LAUNCHES)
    ct.stacked_lstm_apply_fast_train(m, x, return_sequences=False, bf16=True).sum().backward()
    torch.cuda.synchronize()
    launched = {k for k, v in ct.LAUNCHES.items() if v != before[k]}
    assert launched == {f"{kind}_fwd_fast", f"{kind}_bwd_fast"}, launched


# ---------------------------------------------------------------------------
# on the card: K9f's and K6f's tensor-core backward (gemm_bf16 and the bf16
# dh chain)
# ---------------------------------------------------------------------------

def _rounded64(t):
    """A card tensor rounded to bf16, as float64 on the CPU."""
    return t.bfloat16().double().cpu()


def _close_products(name, got, want, scale):
    """A gemm_bf16 output against float64 products of the same bf16
    operands: within 1e-5 of the largest Σ|a|·|b| (float32 sums of up to a
    few thousand products in another order; a wrong tile or transpose is
    off by O(1))."""
    err = float((got.double().cpu() - want).abs().max())
    assert bool(torch.isfinite(got).all()) and err <= 1e-5 * scale, (name, err, scale)


# (n, d, B, T): ragged M = T·B (51, 9), d = 16 and 7 (one padded column),
# T·B = 520 (phase G in two splits, the second ragged)
GEMM_BF16_CASES = [(128, 16, 17, 3), (128, 7, 9, 1), (256, 7, 130, 4), (128, 16, 130, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,B,T", GEMM_BF16_CASES)
def test_cuda_gemm_bf16_forms_match_float64_products(cuda, n, d, B, T):
    """gemm_bf16 in each form against float64 products of the bf16-rounded
    operands: R with the h_prev shift and the bias (K9), R with K6's xp
    addend, X (dz·Wᵀ), G with its splits ([dW; db; dU], db unrounded)."""
    W, U, b = _t(_layers_np(60 + n + d, (n,), d)[0], cuda)
    rng = np.random.default_rng(61 + B)
    M, G = T * B, 4 * n
    x = _t(_normal(rng, (T, B, d)), cuda)
    h = _t(_normal(rng, (T, B, n), 0.5), cuda)
    xp = _t(_normal(rng, (T, B, G)), cuda)
    dz = _t(_normal(rng, (M, G), 0.1), cuda)
    ops = ct.bf16_operands(x, W, U, h)
    assert ops.x.shape == (M, ct.bf16_ld(d)) and ops.W.shape == (ct.bf16_ld(d), G)
    assert not ops.x[:, d:].any() and not ops.W[d:].any()  # the padding is zero
    x64, W64, U64, h64, dz64 = (_rounded64(t) for t in (x.view(M, d), W, U, h.view(M, n), dz))
    hp64 = torch.cat([torch.zeros((B, n), dtype=torch.float64), h64[:-B]])
    absum = lambda a, c: float((a.abs() @ c.abs()).max())  # noqa: E731

    z = ct.phase_r_bf16(ops, b, None, B)
    torch.cuda.synchronize()
    want = x64 @ W64 + hp64 @ U64 + b.double().cpu()
    _close_products("R (K9)", z, want, absum(x64, W64) + absum(hp64, U64))
    k6 = ct.Bf16Operands(None, None, ops.U, ops.h)
    z = ct.phase_r_bf16(k6, None, xp, B)
    torch.cuda.synchronize()
    _close_products("R (K6)", z, xp.view(M, G).double().cpu() + hp64 @ U64, absum(hp64, U64))

    dzb = ct.bf16_copy(dz)
    dx = ct.phase_x_bf16(dzb, ops.W, d)
    torch.cuda.synchronize()
    _close_products("X", dx, dz64 @ W64.t(), absum(dz64, W64.t()))

    sms = ct.sm_count(cuda)
    tiles = -(-d // 128) * -(-G // 128) + -(-n // 128) * -(-G // 128)
    splits = ct.gemm_splits(M, tiles, sms, ct.GEMM_BF16_PER_SM)
    assert (splits > 1) == (M >= 512)
    dW, dU, db = ct.phase_g_bf16(ops, dzb, dz, d, B, sms)
    torch.cuda.synchronize()
    _close_products("G dW", dW, x64.t() @ dz64, absum(x64.t(), dz64))
    _close_products("G dU", dU, hp64.t() @ dz64, absum(hp64.t(), dz64))
    _close_products("G db", db, dz.double().cpu().sum(0), float(dz.abs().sum(0).max()))
    dU6 = ct.phase_g_bf16(k6, dzb, dz, 0, B, sms)
    torch.cuda.synchronize()
    _close_products("G dU (K6)", dU6, hp64.t() @ dz64, absum(hp64.t(), dz64))


# (n, d, B, T): n = 128 and 512 (U staged), ragged B (1, 17, 33, 130), T = 1,
# d = 16, 7 and 512, n = 1024 (staged in bf16) and 2176 (16 x 32 tiles, U
# from the copy)
WIDE_BWD_FAST_CASES = [(512, 16, 1, 5), (512, 512, 17, 4), (512, 16, 130, 3), (128, 16, 33, 1),
                       (128, 7, 9, 4), (1024, 128, 20, 3), (2176, 16, 20, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,B,T", WIDE_BWD_FAST_CASES)
def test_cuda_wide_bwd_fast_matches_plain(cuda, n, d, B, T, monkeypatch):
    """K9f's and K6f's backward (gemm_bf16 and the bf16 chain) against
    their plain bf16 versions, the plain fallback taken away."""
    W, U, b = _t(_layers_np(70 + n + B, (n,), d)[0], cuda)
    rng = np.random.default_rng(71 + B)
    x = _t(_normal(rng, (T, B, d)), cuda)
    dh = _t(_normal(rng, (T, B, n)), cuda)
    plan = ct.chain_plan(B, n, ct.sm_count(cuda), ct.chain_smem_bytes_bf16)
    assert plan.staged == (n <= 1024)
    h_p, c_p = ct.wide_layer_fwd_plain(x, W, U, b, True)
    args = (x, W, U, b, h_p, c_p, dh)
    grads_p = ct.wide_layer_bwd_plain(*args, True)
    grads64 = ct.wide_layer_bwd_plain(*_double(args), True)
    xp = (torch.matmul(x, W) + b).contiguous()
    rargs = (xp, U, h_p, c_p, dh)
    rec_p = ct.lstm_recurrence_train_bwd_plain(*rargs, True)
    rec64 = ct.lstm_recurrence_train_bwd_plain(*_double(rargs), True)
    monkeypatch.setattr(ct, "wide_layer_bwd_plain", None)  # no fallback on the card
    monkeypatch.setattr(ct, "lstm_recurrence_train_bwd_plain", None)
    grads = _launched(ct.wide_layer_bwd, lambda: ct.wide_layer_bwd(*args, True), bf16=True)
    for name, a, r, r64 in zip(("dx", "dW", "dU", "db"), grads, grads_p, grads64):
        _close_fast(name, a, r, r64)
    rec = _launched(ct.lstm_recurrence_train_bwd, lambda: ct.lstm_recurrence_train_bwd(*rargs, True),
                    bf16=True)
    for name, a, r, r64 in zip(("dxp", "dU"), rec, rec_p, rec64):
        _close_fast(name, a, r, r64)
