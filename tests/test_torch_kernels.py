"""Batch-1 recurrence kernels of the PyTorch port (svd_lstm_tpu_torch/ops/cuda_lstm.py).

On the CPU each plain version is held against the JAX package's Pallas
kernel in interpret mode, on the same numpy inputs (atol 2e-5, rtol 1e-5:
JAX CPU against torch CPU in float32, with a different summation order),
and each wrapper's argument checks and device routing are exercised.

The ``cuda``-marked tests hold each CUDA kernel against its plain version on
the card and skip without one. On a machine with a card, run them with

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(``--noconftest`` because tests/conftest.py imports JAX, which the card's
machine need not have; this file imports the JAX package only inside the
fixture that the CPU parity tests use.)
"""

import numpy as np
import pytest
import torch

from svd_lstm_tpu_torch.io.checkpoint import NODE_TYPES, from_numpy_tree
from svd_lstm_tpu_torch.ops import cuda_lstm as ck

ATOL, RTOL = 2e-5, 1e-5
T = 40


@pytest.fixture(scope="module")
def pallas():
    from svd_lstm_tpu.ops import pallas_lstm

    return pallas_lstm


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _normal(rng, shape, scale=1.0):
    return rng.normal(scale=scale, size=shape).astype(np.float32)


# Weights are scaled by 1/sqrt(fan-in), as trained ones are: at a larger
# scale the recurrence turns chaotic and amplifies the last-bit differences
# between two summation orders without bound.

def _dense_case(seed, n, T=T):
    rng = np.random.default_rng(seed)
    return (
        _normal(rng, (T, 4 * n)),
        _normal(rng, (n, 4 * n), n ** -0.5),
        _normal(rng, (n,), 0.5),
        _normal(rng, (n,), 0.5),
    )


def _reduced_case(seed, n, merged, T=T, r=7):
    """xp, uB, uC, h0, c0; split ranks differ per gate (r + g)."""
    rng = np.random.default_rng(seed)
    xp = _normal(rng, (T, 4 * n))
    if merged:
        uB = _normal(rng, (n, r), n ** -0.5)
        uC = _normal(rng, (r, 4 * n - r), r ** -0.5)
    else:
        uB = tuple(_normal(rng, (n, r + g), n ** -0.5) for g in range(4))
        uC = tuple(_normal(rng, (r + g, n - r - g), (r + g) ** -0.5) for g in range(4))
    return xp, uB, uC, _normal(rng, (n,), 0.5), _normal(rng, (n,), 0.5)


def _stack_tree(seed, units, d=16, head=1):
    """A dense stack as a numpy tree (the JAX package's field layout)."""
    rng = np.random.default_rng(seed)
    layers, din = [], d
    for n in units:
        layers.append(NODE_TYPES["LSTMLayerParams"](
            W=_normal(rng, (din, 4 * n), din ** -0.5),
            U=_normal(rng, (n, 4 * n), n ** -0.5),
            b=_normal(rng, (4 * n,), 0.1),
        ))
        din = n
    return NODE_TYPES["StackedLSTMParams"](
        layers=tuple(layers),
        head=NODE_TYPES["DenseParams"](w=_normal(rng, (din, head), 0.3), b=_normal(rng, (head,))),
    )


def _jax_stack(tree):
    import jax.numpy as jnp
    from svd_lstm_tpu.models.lstm import DenseParams, LSTMLayerParams, StackedLSTMParams

    return StackedLSTMParams(
        layers=tuple(LSTMLayerParams(*(jnp.asarray(a) for a in l)) for l in tree.layers),
        head=DenseParams(jnp.asarray(tree.head.w), jnp.asarray(tree.head.b)),
    )


def _t(a, device="cpu"):
    if isinstance(a, tuple):
        return tuple(_t(v, device) for v in a)
    return torch.tensor(a, device=device)


def _jnp(a):
    import jax.numpy as jnp

    if isinstance(a, tuple):
        return tuple(jnp.asarray(v) for v in a)
    return jnp.asarray(a)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(
        got.detach().cpu().numpy(), np.asarray(want), atol=atol, rtol=rtol
    )


# ---------------------------------------------------------------------------
# CPU: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["plain", "wrapper"])
@pytest.mark.parametrize("n", [24, 136])
def test_lstm_recurrence_matches_pallas(pallas, n, entry):
    xp, U, h0, c0 = _dense_case(1, n)
    fn = ck.lstm_recurrence_plain if entry == "plain" else ck.lstm_recurrence
    got = fn(_t(xp), _t(U), _t(h0), _t(c0))
    want = pallas.lstm_recurrence_pallas(
        _jnp(xp), _jnp(U), _jnp(h0).reshape(1, n), _jnp(c0).reshape(1, n), interpret=True
    )
    _close(got, want)


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
@pytest.mark.parametrize("n", [24, 136])
def test_reduced_recurrence_matches_pallas(pallas, n, merged):
    xp, uB, uC, h0, c0 = _reduced_case(2, n, merged)
    got = ck.reduced_recurrence_plain(_t(xp), _t(uB), _t(uC), _t(h0), _t(c0))
    want = pallas.reduced_recurrence_pallas(
        _jnp(xp), _jnp(uB), _jnp(uC), _jnp(h0).reshape(1, n), _jnp(c0).reshape(1, n),
        interpret=True,
    )
    _close(got, want)


@pytest.mark.parametrize("units", [(24, 40), (40, 40)])
def test_fused_dense_stack_matches_pallas(pallas, units):
    tree = _stack_tree(3, units)
    x = _normal(np.random.default_rng(4), (T, 16))
    got = ck.fused_dense_stack_plain(from_numpy_tree(tree, device="cpu"), _t(x))
    want = pallas.fused_dense_stack_pallas(_jax_stack(tree), _jnp(x), interpret=True)
    _close(got, want)


# ---------------------------------------------------------------------------
# CPU: wrapper contract
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    xp, U, h0, c0 = _dense_case(5, 8, T=6)
    before = [k.launches for k in ck.KERNELS]
    got = ck.lstm_recurrence(_t(xp), _t(U), _t(h0), _t(c0))
    torch.testing.assert_close(got, ck.lstm_recurrence_plain(_t(xp), _t(U), _t(h0), _t(c0)),
                               rtol=0, atol=0)
    rxp, uB, uC, rh0, rc0 = _reduced_case(5, 8, merged=False, T=6, r=2)
    ck.reduced_recurrence(_t(rxp), _t(uB), _t(uC), _t(rh0), _t(rc0))
    ck.fused_dense_stack(from_numpy_tree(_stack_tree(5, (8,)), device="cpu"), _t(_normal(np.random.default_rng(5), (6, 16))))
    assert [k.launches for k in ck.KERNELS] == before


def test_wrappers_reject_bad_arguments():
    xp, U, _, _ = _dense_case(6, 8, T=5)
    with pytest.raises(TypeError, match="float32"):
        ck.lstm_recurrence(_t(xp).double(), _t(U).double())
    with pytest.raises(ValueError, match="shape"):
        ck.lstm_recurrence(_t(xp)[:, :20], _t(U))
    with pytest.raises(ValueError, match="contiguous"):
        ck.lstm_recurrence(_t(xp), _t(U).t().contiguous().t())
    with pytest.raises(ValueError, match="h0"):
        ck.lstm_recurrence(_t(xp), _t(U), torch.zeros(9))
    with pytest.raises(ValueError, match="empty"):
        ck.lstm_recurrence(_t(xp)[:0], _t(U))
    rxp, uB, uC, _, _ = _reduced_case(6, 8, merged=False, T=5, r=2)
    with pytest.raises(ValueError, match="4 per-gate"):
        ck.reduced_recurrence(_t(rxp), _t(uB)[:3], _t(uC)[:3])
    with pytest.raises(ValueError, match="uC"):
        ck.reduced_recurrence(_t(rxp), _t(uB), _t(uC)[1:] + _t(uC)[:1])
    model = from_numpy_tree(_stack_tree(6, (8,) * (ck.MAX_LAYERS + 1)), device="cpu")
    with pytest.raises(ValueError, match="layers"):
        ck.fused_dense_stack(model, torch.zeros((5, 16)))


def test_wrappers_reject_other_devices():
    xp, U, _, _ = _dense_case(7, 8, T=5)
    with pytest.raises(ValueError, match="unsupported device"):
        ck.lstm_recurrence(_t(xp, "meta"), _t(U, "meta"))
    with pytest.raises(ValueError, match="different devices"):
        ck.lstm_recurrence(_t(xp), _t(U, "meta"))


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

def _launched(wrapper, fn):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24, 136, 512])
def test_cuda_lstm_recurrence_matches_plain(cuda, n, monkeypatch):
    args = _t(_dense_case(8, n, T=64), cuda)
    want = ck.lstm_recurrence_plain(*args)
    monkeypatch.setattr(ck, "lstm_recurrence_plain", None)  # no fallback on the card
    got = _launched(ck.lstm_recurrence, lambda: ck.lstm_recurrence(*args))
    _close(got, want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
@pytest.mark.parametrize("n", [24, 136, 512])
def test_cuda_reduced_recurrence_matches_plain(cuda, n, merged, monkeypatch):
    args = _t(_reduced_case(9, n, merged, T=64, r=24 if n == 512 else 7), cuda)
    want = ck.reduced_recurrence_plain(*args)
    monkeypatch.setattr(ck, "reduced_recurrence_plain", None)
    got = _launched(ck.reduced_recurrence, lambda: ck.reduced_recurrence(*args))
    _close(got, want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("units", [(24, 40), (40, 40, 40, 40), (30, 30, 30, 30), (128,), (8, 128, 16)])
def test_cuda_fused_dense_stack_matches_plain(cuda, units, monkeypatch):
    model = from_numpy_tree(_stack_tree(10, units), cuda)
    x = _t(_normal(np.random.default_rng(11), (64, 16)), cuda)
    want = ck.fused_dense_stack_plain(model, x)
    monkeypatch.setattr(ck, "fused_dense_stack_plain", None)
    got = _launched(ck.fused_dense_stack, lambda: ck.fused_dense_stack(model, x))
    _close(got, want.cpu())


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_arguments(cuda):
    xp, U, _, _ = _t(_dense_case(12, 8, T=5), cuda)
    with pytest.raises(TypeError, match="float32"):
        ck.lstm_recurrence(xp.double(), U.double())
    with pytest.raises(ValueError, match="contiguous"):
        ck.lstm_recurrence(xp, U.t().contiguous().t())
    with pytest.raises(ValueError, match="different devices"):
        ck.lstm_recurrence(xp, U.cpu())
