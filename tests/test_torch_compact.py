"""K8 of the PyTorch port: the narrow whole-stack train pair for
compact-eligible stacks (svd_lstm_tpu_torch/ops/cuda_train.py).

On the CPU:

* the wrappers and their plain versions against the JAX package's Pallas
  pair (``pallas_train_compact._fused_fwd`` / ``_fused_bwd``, interpret
  mode) on the same numpy inputs, after the JAX side's 128-lane blocks are
  unpacked; units (40, 40) (two gates a block), (30, 30, 30) (four) and
  (40, 30) (both);
* ``fused_narrow_train_apply_compact`` against the JAX one and ``jax.grad``
  through it;
* the float64 gradcheck of ``FusedNarrowTrainCompact``;
* the routing: ``compact="auto"`` takes K8 from B = 128 on and K7 below,
  ``compact_gates`` reaches the dense ``fit``, the singular and reduced
  views take "auto", and the shared-memory shape rule sends an oversize
  eligible stack to K7;
* CPU tensors launch nothing, and the wrappers' argument checks.

Tolerances are the JAX package's own for K8 (tests/test_pallas_train_compact.py):
forwards within 1e-5, gradients within 2e-5 (float32 on both sides, another
summation order). The raw backward gets the apply's cotangent scale (a
window-end MSE over B rows: 2·(pred − y)/B), so its gradients are of the
size the JAX tests hold to 2e-5.

The ``cuda``-marked tests hold K8 against its plain version on the card,
with the plain version disabled to prove there is no fallback, and skip
without a card. On a machine with a card:

    python -m pytest tests/test_torch_compact.py -m cuda --noconftest -q
"""

import functools

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.io.checkpoint import NODE_TYPES, from_numpy_tree
from svd_lstm_tpu_torch.ops import cuda_train as ct

FWD = dict(atol=1e-5, rtol=0)
GRAD = dict(atol=2e-5, rtol=0)
LANE = 128
D, B, T = 16, 8, 12
UNITS = {"k2": (40, 40), "k4": (30, 30, 30), "k2-k4": (40, 30)}


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


def _tree(layers, seed):
    rng = np.random.default_rng(seed)
    n = layers[-1][1].shape[0]
    return NODE_TYPES["StackedLSTMParams"](
        layers=tuple(NODE_TYPES["LSTMLayerParams"](*l) for l in layers),
        head=NODE_TYPES["DenseParams"](w=_normal(rng, (n, 1), 0.3), b=_normal(rng, (1,))),
    )


def _jax_params(tree):
    import jax.numpy as jnp
    from svd_lstm_tpu.models.lstm import DenseParams, LSTMLayerParams, StackedLSTMParams

    return StackedLSTMParams(
        layers=tuple(LSTMLayerParams(*(jnp.asarray(a) for a in l)) for l in tree.layers),
        head=DenseParams(jnp.asarray(tree.head.w), jnp.asarray(tree.head.b)),
    )


# ---------------------------------------------------------------------------
# CPU: the wrappers against the Pallas pair (interpret mode)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(UNITS), ids=list(UNITS))
def compact_case(request):
    """The same inputs through JAX _fused_fwd/_fused_bwd (interpret=True),
    unpacked: (layers, x, dh_last, hs, cs, dWs, dUs, dbs, dx)."""
    import jax.numpy as jnp
    from svd_lstm_tpu.ops.pallas_train_compact import _fused_bwd, _fused_fwd

    units = UNITS[request.param]
    layers = _layers_np(0, units, D)
    rng = np.random.default_rng(1)
    x = _normal(rng, (T, B, D))
    dh = _normal(rng, (T, B, units[-1]), 2.0 / B) * (np.arange(T) == T - 1)[:, None, None]
    tree = _tree(layers, 2)
    jl = _jax_params(tree).layers
    h_all, c_all = _fused_fwd(jl, jnp.asarray(x), interpret=True)
    dh_p = jnp.zeros((T, B, LANE), jnp.float32).at[:, :, : units[-1]].set(dh)
    dWs, dUs, dbs, dx = _fused_bwd(jl, jnp.asarray(x), h_all, c_all, dh_p, interpret=True)
    hs = [np.asarray(h_all)[:, :, i * LANE : i * LANE + n] for i, n in enumerate(units)]
    cs = [np.asarray(c_all)[:, :, i * LANE : i * LANE + n] for i, n in enumerate(units)]
    return (layers, x, dh.astype(np.float32), hs, cs, [np.asarray(g) for g in dWs],
            [np.asarray(g) for g in dUs], [np.asarray(g) for g in dbs], np.asarray(dx))


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_compact_fwd_matches_pallas(compact_case, entry):
    layers, x, _, hs_j, cs_j, *_ = compact_case
    fn = ct.fused_narrow_train_compact_fwd_plain if entry == "plain" else ct.fused_narrow_train_compact_fwd
    hs, cs = fn(_t(layers), _t(x))
    for i in range(len(layers)):
        _close(hs[i], hs_j[i], err_msg=f"h{i}")
        _close(cs[i], cs_j[i], err_msg=f"c{i}")


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_compact_bwd_matches_pallas(compact_case, entry):
    layers, x, dh, hs_j, cs_j, dWs_j, dUs_j, dbs_j, dx_j = compact_case
    fn = ct.fused_narrow_train_compact_bwd_plain if entry == "plain" else ct.fused_narrow_train_compact_bwd
    dWs, dUs, dbs, dx = fn(_t(layers), _t(x), _t(hs_j), _t(cs_j), _t(dh))
    for i in range(len(layers)):
        _close(dWs[i], dWs_j[i], GRAD, f"dW{i}")
        _close(dUs[i], dUs_j[i], GRAD, f"dU{i}")
        _close(dbs[i], dbs_j[i], GRAD, f"db{i}")
    _close(dx, dx_j, GRAD, "dx")


@pytest.mark.parametrize("name", list(UNITS))
def test_compact_apply_matches_jax(name):
    """The apply and jax.grad through it (window-end MSE, as the JAX
    package's own K8 gradient test): forward within 1e-5, every parameter's
    and the input's gradient within 2e-5."""
    import jax
    import jax.numpy as jnp
    from svd_lstm_tpu.ops.pallas_train_compact import fused_narrow_train_apply_compact as jax_apply

    tree = _tree(_layers_np(3, UNITS[name], D), 4)
    params = _jax_params(tree)
    rng = np.random.default_rng(5)
    x, y = _normal(rng, (B, T, D)), _normal(rng, (B,))

    def jloss(p, xx):
        pred = jax_apply(p, xx, return_sequences=False, interpret=True)[..., 0]
        return jnp.mean((pred - y) ** 2)

    y_j = jax_apply(params, jnp.asarray(x), interpret=True)
    g_j, gx_j = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    model = from_numpy_tree(tree, device="cpu")
    xt = _t(x).requires_grad_(True)
    _close(ct.fused_narrow_train_apply_compact(model, _t(x)), y_j)
    pred = ct.fused_narrow_train_apply_compact(model, xt, return_sequences=False)[..., 0]
    torch.mean((pred - _t(y)) ** 2).backward()
    for l, lj in zip(model.layers, g_j.layers):
        for f in ("W", "U", "b"):
            _close(getattr(l, f).grad, getattr(lj, f), GRAD, f)
    _close(model.head.w.grad, g_j.head.w, GRAD, "head.w")
    _close(model.head.b.grad, g_j.head.b, GRAD, "head.b")
    _close(xt.grad, gx_j, GRAD, "x")


def test_compact_gradcheck_float64():
    layers = _t(_layers_np(6, (2, 3), 3), dtype=torch.float64)
    x = _t(_normal(np.random.default_rng(7), (3, 2, 3)), dtype=torch.float64)
    inputs = [t.requires_grad_(True) for t in (x, *(w for l in layers for w in l))]
    assert torch.autograd.gradcheck(functools.partial(ct.FusedNarrowTrainCompact.apply, False), inputs)


# ---------------------------------------------------------------------------
# CPU: routing
# ---------------------------------------------------------------------------

@pytest.fixture()
def routes(monkeypatch):
    """Records which narrow apply the dispatch takes: "K8" or "K7"."""
    calls = []
    for name, tag in (("fused_narrow_train_apply_compact", "K8"), ("fused_narrow_train_apply", "K7")):
        real = getattr(ct, name)
        monkeypatch.setattr(ct, name, lambda *a, _r=real, _t=tag, **k: calls.append(_t) or _r(*a, **k))
    return calls


def _model(units, d, seed=8):
    return from_numpy_tree(_tree(_layers_np(seed, units, d), seed + 1), device="cpu")


def _x(batch, d, steps=3, seed=9):
    return _t(_normal(np.random.default_rng(seed), (batch, steps, d)))


@pytest.mark.parametrize("batch,compact,want", [
    (127, "auto", "K7"), (128, "auto", "K8"), (130, "auto", "K8"),
    (2, True, "K8"), (128, False, "K7"),
])
def test_dispatch_routes_by_batch_and_flag(routes, batch, compact, want):
    y = ct.stacked_lstm_apply_fast_train(_model((12, 10), 5), _x(batch, 5), compact=compact)
    assert tuple(y.shape) == (batch, 3, 1)
    assert routes == [want]


@pytest.mark.parametrize("units,d", [((65,), 5), ((40,), 130), ((64, 64, 64, 64), 16),
                                     ((64,) * 8, 128)],
                         ids=["n65", "d130", "4x64", "8x64-d128"])
def test_ineligible_or_oversize_stacks_take_k7(routes, units, d):
    """n > 64 and d > 128 are not compact-eligible (d > 128 is not narrow
    either: the plain scan); 4×64 (d = 16) and 8×64 (d = 128) are eligible
    but their resident weights do not fit in a block's shared memory, so
    the shape rule sends them to K7."""
    m = _model(units, d)
    eligible = ct.compact_eligible(m, d)
    assert eligible == (max(units) <= 64 and d <= 128)
    assert not (eligible and ct.compact_fits(list(units), d))
    ct.stacked_lstm_apply_fast_train(m, _x(128, d, steps=2), compact=True)
    assert routes == ([] if d > 128 else ["K7"])


def test_shape_rule_numbers():
    """The reference's 4×40 (d = 16) fits: 193 184 B of resident weights
    and 14 720 B of backward state, within 232 448; so does the dense view
    of 4×30 split r = 15."""
    assert ct.compact_smem_bytes([40] * 4, 16) == 193_184 + 14_720
    assert ct.compact_fits([40] * 4, 16) and ct.compact_fits([30] * 4, 16)
    assert not ct.compact_fits([40] * 5, 16)


@pytest.mark.parametrize("units,d", [((40, 30, 40), 16), ((65, 65), 16), ((40,), 200), ((15, 15, 15), 16),
                                     ((64,), 128)])
def test_compact_eligible_matches_jax(units, d):
    import jax
    from svd_lstm_tpu.models.lstm import init_stacked_lstm
    from svd_lstm_tpu.ops.pallas_train_compact import compact_eligible

    params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=d, units=units)
    assert ct.compact_eligible(from_numpy_tree(params, device="cpu"), d) == compact_eligible(params, d)


@pytest.mark.parametrize("compact_gates", [True, False, "auto"])
def test_resolve_passes_compact_gates(compact_gates):
    """The dense scan gets TrainConfig.compact_gates, as in the JAX package."""
    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.train.loop import resolve_train_apply_fn

    fn, used = resolve_train_apply_fn(
        P.TrainConfig(recurrence_kernel=True, compact_gates=compact_gates), P.stacked_lstm_apply)
    assert used and fn.func is ct.stacked_lstm_apply_fast_train
    assert fn.keywords == {"compact": compact_gates, "bf16": False}


@pytest.mark.parametrize("compact_gates,want", [(False, "K7"), ("auto", "K8"), (True, "K8")])
def test_fit_follows_compact_gates(routes, compact_gates, want):
    """The dense fit at B = 128: compact_gates=False keeps K7."""
    import svd_lstm_tpu_torch as P

    rng = np.random.default_rng(10)
    windows = (_normal(rng, (128, 4, 5)), _normal(rng, (128,)))
    cfg = P.TrainConfig(num_windows=128, window_len=4, batch_size=128, epochs=1,
                        recurrence_kernel=True, compact_gates=compact_gates)
    P.fit(_model((12,), 5), np.zeros((1, 8, 5), np.float32), np.zeros(8, np.float32), cfg,
          windows=windows)
    assert set(routes) == {want}


@pytest.mark.parametrize("family", ["singular", "reduced"])
@pytest.mark.parametrize("batch,want", [(8, "K7"), (128, "K8")])
def test_views_take_auto(routes, family, batch, want):
    """The singular and reduced views pass no compact flag: "auto"."""
    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.ops.reduced_train import reduced_lstm_apply_fast_train
    from svd_lstm_tpu_torch.ops.singular_train import singular_lstm_apply_fast_train

    smodel = P.make_singular_model(_model((12, 10), 5))
    if family == "singular":
        singular_lstm_apply_fast_train(smodel, _x(batch, 5))
    else:
        reduced_lstm_apply_fast_train(P.make_reduced_model(smodel, rank=6), _x(batch, 5))
    assert routes == [want]


# ---------------------------------------------------------------------------
# CPU: wrapper contract
# ---------------------------------------------------------------------------

def test_cpu_tensors_launch_nothing():
    before = dict(ct.LAUNCHES)
    layers = _t(_layers_np(11, (6, 4), 3))
    x = _t(_normal(np.random.default_rng(11), (3, 2, 3)))
    hs, cs = ct.fused_narrow_train_compact_fwd(layers, x)
    ct.fused_narrow_train_compact_bwd(layers, x, hs, cs, torch.ones_like(hs[-1]))
    ct.fused_narrow_train_apply_compact(_model((6, 4), 3), x.transpose(0, 1)).sum().backward()
    assert ct.LAUNCHES == before


def test_compact_wrappers_reject_bad_arguments():
    x = _t(_normal(np.random.default_rng(12), (3, 2, 16)))
    with pytest.raises(ValueError, match="at most 64"):
        ct.fused_narrow_train_compact_fwd(_t(_layers_np(12, (65,), 16)), x)
    with pytest.raises(ValueError, match="shared memory"):
        ct.fused_narrow_train_compact_fwd(_t(_layers_np(12, (64,) * 4, 16)), x)
    layers = _t(_layers_np(12, (8, 8), 16))
    with pytest.raises(TypeError, match="float32"):
        ct.fused_narrow_train_compact_fwd(layers, x.half())
    hs, cs = ct.fused_narrow_train_compact_fwd(layers, x)
    with pytest.raises(ValueError, match="dh_last"):
        ct.fused_narrow_train_compact_bwd(layers, x, hs, cs, torch.ones((3, 2, 5)))
    with pytest.raises(ValueError, match="empty"):
        ct.fused_narrow_train_compact_fwd(layers, x[:0])


# ---------------------------------------------------------------------------
# on the card: K8 against its plain version
# ---------------------------------------------------------------------------

def _launched(wrapper, fn):
    before = ct.LAUNCHES[wrapper.__name__]
    out = fn()
    torch.cuda.synchronize()
    assert ct.LAUNCHES[wrapper.__name__] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("units,d,batch,steps", [
    ((40, 40, 40, 40), 16, 128, 20), ((30, 30, 30, 30), 16, 130, 20), ((8, 12, 5), 7, 9, 20),
    # the forward's edges: T < L, one layer, 8 layers, uneven widths with
    # d > n, B = 1 and B % 4 != 0
    ((40, 40, 40, 40), 16, 128, 1), ((40, 40, 40, 40), 16, 128, 3), ((30,), 16, 9, 20),
    ((8,) * 8, 16, 12, 10), ((20, 12, 9), 40, 1, 10), ((33, 17), 64, 6, 12),
    # the stacks of K8's route whose backward reads the global copy
    # (tests/test_torch_narrow_bwd.py): S = 4 with d = 16 and 128, S = 4
    # with d = 16 on 6 layers, S = 2 with d = 128
    ((42, 42, 42, 42), 16, 12, 6), ((48, 48), 128, 9, 5), ((34,) * 6, 16, 8, 5),
    ((32,) * 5, 128, 5, 4),
])
def test_cuda_compact_matches_plain(cuda, units, d, batch, steps, monkeypatch):
    layers = _t(_layers_np(13, units, d), cuda)
    rng = np.random.default_rng(14)
    x = _t(_normal(rng, (steps, batch, d)), cuda)
    dh = _t(_normal(rng, (steps, batch, units[-1])), cuda)
    hs_p, cs_p = ct.fused_narrow_train_compact_fwd_plain(layers, x)
    grads_p = ct.fused_narrow_train_compact_bwd_plain(layers, x, hs_p, cs_p, dh)
    monkeypatch.setattr(ct, "fused_narrow_train_compact_fwd_plain", None)  # no fallback on the card
    monkeypatch.setattr(ct, "fused_narrow_train_compact_bwd_plain", None)
    hs, cs = _launched(ct.fused_narrow_train_compact_fwd,
                       lambda: ct.fused_narrow_train_compact_fwd(layers, x))
    for a, r in zip(hs + cs, hs_p + cs_p):
        _close(a, r.cpu().numpy(), dict(atol=2e-5, rtol=1e-5))
    grads = _launched(ct.fused_narrow_train_compact_bwd,
                      lambda: ct.fused_narrow_train_compact_bwd(layers, x, hs_p, cs_p, dh))
    for got, want in zip(grads[:3], grads_p[:3]):
        for a, r in zip(got, want):
            _close(a, r.cpu().numpy(), dict(atol=1e-5, rtol=1e-4))
    _close(grads[3], grads_p[3].cpu().numpy(), dict(atol=1e-5, rtol=1e-4))


@pytest.mark.cuda
def test_cuda_dispatch_launches_k8(cuda):
    m = from_numpy_tree(_tree(_layers_np(15, (40, 40), 16), 16), device=cuda)
    x = _t(_normal(np.random.default_rng(17), (128, 10, 16)), cuda)
    names = ("fused_narrow_train_compact_fwd", "fused_narrow_train_compact_bwd")
    before = tuple(ct.LAUNCHES[k] for k in names)
    ct.stacked_lstm_apply_fast_train(m, x, return_sequences=False).sum().backward()
    torch.cuda.synchronize()
    after = tuple(ct.LAUNCHES[k] for k in names)
    assert after == (before[0] + 1, before[1] + 1)
