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


def _jax_reduced(units, merged, rank, d=8, seed=1):
    """A reduced JAX model: a fresh stack truncated to ``rank``."""
    import jax
    from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    params = init_stacked_lstm(jax.random.PRNGKey(seed), d, units)
    return make_reduced_model(make_singular_model(params, merged_kernel=merged), rank=rank)


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
@pytest.mark.parametrize("units,rank", [((136,), 20), ((24, 40), 6)])
def test_fused_reduced_stack_matches_pallas(pallas, units, rank, merged, entry):
    """K4 in exact mode, as tests/test_pallas_wide.py holds the Pallas kernel
    to the two-step scan: atol 2e-5."""
    params = _jax_reduced(units, merged, rank)
    x = _normal(np.random.default_rng(13), (10, 8))
    fn = ck.fused_reduced_stack_plain if entry == "plain" else ck.fused_reduced_stack
    got = fn(from_numpy_tree(params, device="cpu"), _t(x))
    want = pallas.fused_reduced_stack_pallas(params, _jnp(x), interpret=True)
    _close(got, want, atol=2e-5, rtol=0)


def test_fused_reduced_stack_plain_matches_the_two_step_scan():
    """K4's plain version, time-outer, against the port's layer-outer
    two-step scan of the same model (the same products in the same order)."""
    import svd_lstm_tpu_torch as P

    for merged in (True, False):
        model = from_numpy_tree(_jax_reduced((24, 40), merged, 6, seed=2), device="cpu")
        x = _t(_normal(np.random.default_rng(14), (12, 8)))
        torch.testing.assert_close(ck.fused_reduced_stack_plain(model, x),
                                   P.reduced_lstm_apply(model, x[None])[0].detach(),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# CPU: wrapper contract
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    xp, U, h0, c0 = _dense_case(5, 8, T=6)
    before = dict(ck.LAUNCHES)
    got = ck.lstm_recurrence(_t(xp), _t(U), _t(h0), _t(c0))
    torch.testing.assert_close(got, ck.lstm_recurrence_plain(_t(xp), _t(U), _t(h0), _t(c0)),
                               rtol=0, atol=0)
    rxp, uB, uC, rh0, rc0 = _reduced_case(5, 8, merged=False, T=6, r=2)
    ck.reduced_recurrence(_t(rxp), _t(uB), _t(uC), _t(rh0), _t(rc0))
    ck.fused_dense_stack(from_numpy_tree(_stack_tree(5, (8,)), device="cpu"), _t(_normal(np.random.default_rng(5), (6, 16))))
    ck.lstm_recurrence(_t(xp), _t(U), dot_precision="default")
    ck.fused_reduced_stack(from_numpy_tree(_jax_reduced((8,), False, 2), device="cpu"),
                           _t(_normal(np.random.default_rng(5), (6, 8))), dot_precision="default")
    assert ck.LAUNCHES == before


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
    deep = from_numpy_tree(_jax_reduced((8,) * (ck.MAX_LAYERS + 1), False, 2), device="cpu")
    with pytest.raises(ValueError, match="layers"):
        ck.fused_reduced_stack(deep, torch.zeros((5, 8)))
    reduced = from_numpy_tree(_jax_reduced((8,), False, 2), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ck.fused_reduced_stack(reduced, torch.zeros((5, 9)))
    reduced.layers[0].wB[1] = torch.nn.Parameter(torch.zeros((8, 3)))  # gate 1's C keeps r = 2
    with pytest.raises(ValueError, match=r"layers\[0\].wC\[1\]"):
        ck.fused_reduced_stack(reduced, torch.zeros((5, 8)))


def test_wrappers_reject_other_devices():
    xp, U, _, _ = _dense_case(7, 8, T=5)
    with pytest.raises(ValueError, match="unsupported device"):
        ck.lstm_recurrence(_t(xp, "meta"), _t(U, "meta"))
    with pytest.raises(ValueError, match="different devices"):
        ck.lstm_recurrence(_t(xp), _t(U, "meta"))


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

def _launched(variant, fn):
    """fn() after checking that it launched the kernel variant once."""
    before = dict(ck.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    assert ck.LAUNCHES == {**before, variant: before[variant] + 1}
    return out


def _bf16_ulp(v: float) -> float:
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _fast_close(got, want, want64):
    """A fast variant against its plain version: within 2 bf16 ulps of the
    largest value or twice the plain version's distance from the same
    arithmetic with float64 state, whichever is larger (a float32 sum order
    that flips one bf16 rounding of h carries on to later steps)."""
    drift = float((want.double() - want64).abs().max())
    tol = max(2 * _bf16_ulp(float(want.abs().max())), 2 * drift)
    assert float((got - want).abs().max()) <= tol


def _double(a):
    return tuple(_double(v) for v in a) if isinstance(a, tuple) else a.double()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24, 136, 512])
def test_cuda_lstm_recurrence_matches_plain(cuda, n, monkeypatch):
    args = _t(_dense_case(8, n, T=64), cuda)
    want = ck.lstm_recurrence_plain(*args)
    monkeypatch.setattr(ck, "lstm_recurrence_plain", None)  # no fallback on the card
    got = _launched("lstm_recurrence", lambda: ck.lstm_recurrence(*args))
    _close(got, want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
@pytest.mark.parametrize("n", [24, 136, 512])
def test_cuda_reduced_recurrence_matches_plain(cuda, n, merged, monkeypatch):
    args = _t(_reduced_case(9, n, merged, T=64, r=24 if n == 512 else 7), cuda)
    want = ck.reduced_recurrence_plain(*args)
    monkeypatch.setattr(ck, "reduced_recurrence_plain", None)
    got = _launched("reduced_recurrence", lambda: ck.reduced_recurrence(*args))
    _close(got, want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("units", [(24, 40), (40, 40, 40, 40), (30, 30, 30, 30), (128,), (8, 128, 16),
                                   (128, 128, 128, 128), (512, 512, 512)])
def test_cuda_fused_dense_stack_matches_plain(cuda, units, monkeypatch):
    model = from_numpy_tree(_stack_tree(10, units), cuda)
    x = _t(_normal(np.random.default_rng(11), (64, 16)), cuda)
    want = ck.fused_dense_stack_plain(model, x)
    monkeypatch.setattr(ck, "fused_dense_stack_plain", None)
    got = _launched("fused_dense_stack", lambda: ck.fused_dense_stack(model, x))
    _close(got, want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [24, 136, 512])
def test_cuda_lstm_recurrence_fast_matches_plain(cuda, n, monkeypatch):
    args = _t(_dense_case(8, n, T=64), cuda)
    want = ck.lstm_recurrence_plain(*args, dot_precision="default")
    want64 = ck.lstm_recurrence_plain(*_double(args), dot_precision="default")
    monkeypatch.setattr(ck, "lstm_recurrence_plain", None)  # no fallback on the card
    got = _launched("lstm_recurrence_fast",
                    lambda: ck.lstm_recurrence(*args, dot_precision="default"))
    _fast_close(got, want, want64)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_cuda_lstm_recurrence_3x512_length_from_state(cuda, fast, monkeypatch):
    """K3 and K3f at a 3x512 layer's width over the main path's T = 6656,
    from h0 and c0: the chain's 6656 grid barriers, within 5e-4 (exact, the
    limit of chip_smoke.py over T = 6656) or K3f's limit."""
    args = _t(_dense_case(12, 512, T=6656), cuda)
    dp = "default" if fast else None
    want = ck.lstm_recurrence_plain(*args, dot_precision=dp)
    want64 = ck.lstm_recurrence_plain(*_double(args), dot_precision=dp) if fast else None
    monkeypatch.setattr(ck, "lstm_recurrence_plain", None)  # no fallback on the card
    got = _launched("lstm_recurrence_fast" if fast else "lstm_recurrence",
                    lambda: ck.lstm_recurrence(*args, dot_precision=dp))
    if fast:
        _fast_close(got, want, want64)
    else:
        assert float((got - want).abs().max()) <= 5e-4


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("n", [130, 1030, 2048])
def test_cuda_lstm_recurrence_every_home_and_masked_units(cuda, n, fast, monkeypatch):
    """n = 130 (registers, 4 units a CTA: 2 masked), 1030 (staged, 6
    masked) and 2048 (the global copy), as the plan picks on this card."""
    args = _t(_dense_case(13, n), cuda)
    dp = "default" if fast else None
    plan = ck.card_recurrence_plan(cuda, n, fast)
    assert plan.home == ("registers" if n <= 512 else "staged" if n < 2048 else "global")
    assert (n % plan.units != 0) == (n != 2048)
    want = ck.lstm_recurrence_plain(*args, dot_precision=dp)
    want64 = ck.lstm_recurrence_plain(*_double(args), dot_precision=dp) if fast else None
    monkeypatch.setattr(ck, "lstm_recurrence_plain", None)
    got = _launched("lstm_recurrence_fast" if fast else "lstm_recurrence",
                    lambda: ck.lstm_recurrence(*args, dot_precision=dp))
    if fast:
        _fast_close(got, want, want64)
    else:
        _close(got, want.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
@pytest.mark.parametrize("n", [24, 136, 512])
def test_cuda_reduced_recurrence_fast_matches_plain(cuda, n, merged, monkeypatch):
    args = _t(_reduced_case(9, n, merged, T=64, r=24 if n == 512 else 7), cuda)
    want = ck.reduced_recurrence_plain(*args, dot_precision="default")
    want64 = ck.reduced_recurrence_plain(*_double(args), dot_precision="default")
    monkeypatch.setattr(ck, "reduced_recurrence_plain", None)
    got = _launched("reduced_recurrence_fast",
                    lambda: ck.reduced_recurrence(*args, dot_precision="default"))
    _fast_close(got, want, want64)


@pytest.mark.cuda
@pytest.mark.parametrize("units", [(24, 40), (30, 30, 30, 30), (128,), (8, 128, 16),
                                   (128, 128, 128, 128), (512, 512, 512)])
def test_cuda_fused_dense_stack_fast_matches_plain(cuda, units, monkeypatch):
    import copy

    model = from_numpy_tree(_stack_tree(10, units), cuda)
    x = _t(_normal(np.random.default_rng(11), (64, 16)), cuda)
    want = ck.fused_dense_stack_plain(model, x, dot_precision="default")
    want64 = ck.fused_dense_stack_plain(copy.deepcopy(model).double(), x.double(),
                                        dot_precision="default")
    monkeypatch.setattr(ck, "fused_dense_stack_plain", None)
    got = _launched("fused_dense_stack_fast",
                    lambda: ck.fused_dense_stack(model, x, dot_precision="default"))
    _fast_close(got, want, want64)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("route,lanes", [("registers", 8), ("registers", 4), ("staged", 8),
                                         ("staged", 2), ("global", 8), ("global", 1)])
def test_cuda_dense_wave_every_home_and_lane_count(cuda, route, lanes, fast):
    """K1's wavefront with the weights in each home and at each lane count,
    forced past the wrapper's rule, on a stack that admits them all."""
    import copy

    model = from_numpy_tree(_stack_tree(16, (24, 40)), cuda)
    x = _t(_normal(np.random.default_rng(17), (64, 16)), cuda)
    dp = "default" if fast else None
    want = ck.fused_dense_stack_plain(model, x, dp)
    threads = ck.wave_threads((24, 40), 16, lanes)
    plan = ck.DensePlan(route, lanes, threads, 0)
    h = torch.empty((64, 40), dtype=torch.float32, device=cuda)
    ck._launch_dense(model, x, fast, plan, h)
    got = model.head(h)
    if fast:
        want64 = ck.fused_dense_stack_plain(copy.deepcopy(model).double(), x.double(), dp)
        _fast_close(got, want, want64)
    else:
        _close(got, want.cpu())


@pytest.mark.cuda
def test_cuda_dense_wave_refuses_what_its_block_cannot_hold(cuda):
    """The launcher checks the wrapper's choice: more lanes than the block
    holds, or a lane's entries past the registers' bound, are refused."""
    model = from_numpy_tree(_stack_tree(18, (40, 40, 40, 40)), cuda)
    x = _t(_normal(np.random.default_rng(19), (8, 16)), cuda)
    h = torch.empty((8, 40), dtype=torch.float32, device=cuda)
    for plan in (ck.DensePlan("staged", 8, 1280, 0), ck.DensePlan("registers", 4, 640, 0)):
        with pytest.raises(RuntimeError, match="cudaError"):
            ck._launch_dense(model, x, False, plan, h)


@pytest.mark.cuda
@pytest.mark.parametrize("dot_precision", [None, "default"], ids=["exact", "fast"])
@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
@pytest.mark.parametrize("units,rank", [((24, 40), 6), ((136,), 20), ((512,), 24)])
def test_cuda_fused_reduced_stack_matches_plain(cuda, units, rank, merged, dot_precision,
                                                monkeypatch):
    """Exact: within 2e-5 or twice the plain float32 version's distance
    from float64 (a truncation can be ill-conditioned, ROADMAP fault 3.1);
    fast: as the other fast variants."""
    import copy

    import svd_lstm_tpu_torch as P

    dense = P.init_stacked_lstm(torch.Generator().manual_seed(3), input_dim=8, units=units, device=cuda)
    model = P.make_reduced_model(P.make_singular_model(dense, merged_kernel=merged), rank=rank)
    x = _t(_normal(np.random.default_rng(15), (64, 8)), cuda)
    want = ck.fused_reduced_stack_plain(model, x, dot_precision)
    want64 = ck.fused_reduced_stack_plain(copy.deepcopy(model).double(), x.double(), dot_precision)
    monkeypatch.setattr(ck, "fused_reduced_stack_plain", None)
    variant = "fused_reduced_stack" if dot_precision is None else "fused_reduced_stack_fast"
    got = _launched(variant, lambda: ck.fused_reduced_stack(model, x, dot_precision=dot_precision))
    if dot_precision is None:
        drift = float((want.double() - want64).abs().max())
        assert float((got - want).abs().max()) <= max(2e-5, 2 * drift)
    else:
        _fast_close(got, want, want64)


def _reduced_on_card(cuda, units, rank, merged, d, seed=3):
    """A fresh stack truncated to ``rank`` on the card, with biases drawn
    from ``seed``, its head the identity (the output is the last layer's h,
    which the kernel writes)."""
    import svd_lstm_tpu_torch as P
    from svd_lstm_tpu_torch.models.lstm import DenseHead

    dense = P.init_stacked_lstm(torch.Generator().manual_seed(seed), input_dim=d, units=units,
                                device=cuda)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for l in dense.layers:
            l.b.copy_(_t(_normal(rng, tuple(l.b.shape), 0.5), cuda))
    model = P.make_reduced_model(P.make_singular_model(dense, merged_kernel=merged), rank=rank)
    model.head = DenseHead(torch.eye(units[-1], device=cuda), torch.zeros(units[-1], device=cuda))
    return model


def _stack_close(got, model, x, fast):
    """K4 on h: exact within 2e-5 or twice the plain float32 version's
    distance from float64; fast as the other fast variants."""
    import copy

    dp = "default" if fast else None
    want = ck.fused_reduced_stack_plain(model, x, dp)
    want64 = ck.fused_reduced_stack_plain(copy.deepcopy(model).double(), x.double(), dp)
    assert bool(torch.isfinite(got).all())
    if fast:
        _fast_close(got, want, want64)
    else:
        drift = float((want.double() - want64).abs().max())
        assert float((got - want).abs().max()) <= max(2e-5, 2 * drift)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
@pytest.mark.parametrize("units,rank,merged,plan", [
    ((30, 30, 30, 30), 15, False, ("wave", 1, 16, "registers")),
    ((30, 30, 30, 30), 15, True, ("wave", 1, 16, "registers")),
    ((512, 512, 512), 24, True, ("wave", 16, 12, "registers")),
])
def test_cuda_reduced_stack_wave_matches_plain(cuda, units, rank, merged, plan, fast):
    """K4 as the rule launches it at 4x30 (r = 15) and 3x512 (r = 24), d =
    16, T = 64, on the last layer's h."""
    model = _reduced_on_card(cuda, units, rank, merged, 16)
    x = _t(_normal(np.random.default_rng(20), (64, 16)), cuda)
    got_plan = ck.card_reduced_stack_plan(cuda, model, 16, fast)
    assert (got_plan.route, got_plan.cluster, got_plan.warps, got_plan.home) == plan
    variant = "fused_reduced_stack_fast" if fast else "fused_reduced_stack"
    got = _launched(variant, lambda: ck.fused_reduced_stack(
        model, x, dot_precision="default" if fast else None))
    _stack_close(got, model, x, fast)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster,home", [(1, "registers"), (1, "staged"), (2, "registers"),
                                          (2, "staged"), (4, "registers"), (4, "staged"),
                                          (8, "registers"), (8, "staged"), (16, "registers"),
                                          (16, "staged"), (1, "layers")])
@pytest.mark.parametrize("units,rank,merged", [((24, 40), 6, True), ((24, 40), 6, False),
                                               ((30, 30, 30, 30), 15, False)])
def test_cuda_reduced_stack_every_plan(cuda, units, rank, merged, cluster, home):
    """K4 forced to each cluster size and home of its rule, and to the layer
    loop, exact and fast, T = 32: CTAs that hold two layers' warps, CTAs
    that hold none."""
    d = 8
    model = _reduced_on_card(cuda, units, rank, merged, d, seed=4)
    x = _t(_normal(np.random.default_rng(21), (32, d)), cuda)
    stack = ck._stack_ranks(model)
    geom = ck.stack_geometry(*stack)
    for fast in (False, True):
        if home == "layers":
            plan = ck.layers_stack_plan(stack[0], d, geom)
        else:
            warps = -(-geom.warps // cluster)
            plan = ck.ReducedStackPlan("wave", cluster, warps, home, 32 * warps,
                                       ck.reduced_stack_smem_bytes(geom, d, cluster, warps, home, fast))
        h = torch.empty((32, units[-1]), dtype=torch.float32, device=cuda)
        ck._launch_reduced_stack(model, x, fast, plan, h)
        torch.cuda.synchronize()
        _stack_close(model.head(h), model, x, fast)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_arguments(cuda):
    xp, U, _, _ = _t(_dense_case(12, 8, T=5), cuda)
    with pytest.raises(TypeError, match="float32"):
        ck.lstm_recurrence(xp.double(), U.double())
    with pytest.raises(ValueError, match="contiguous"):
        ck.lstm_recurrence(xp, U.t().contiguous().t())
    with pytest.raises(ValueError, match="different devices"):
        ck.lstm_recurrence(xp, U.cpu())
