"""Batched inference with its precision modes in the PyTorch port
(svd_lstm_tpu_torch/ops/cuda_batched.py, utils/precision.py and the batched
branch of api.predict), against the JAX package on the CPU.

K5's plain version is held against
* a bf16-operand emulation written in JAX here (bf16 h and U, float32
  accumulation and state): h within 1 bf16 ulp of max |h|, since the
  float32 sums are taken in another order and may flip the last bit of a
  bf16 h;
* the JAX package's Pallas kernel in interpret mode, whose dot runs in
  float32 on the CPU: within the bf16-operand error, at most 1e-2;
* the exact float32 recurrence, with float32 xp: relative error ≤ 1e-2.

The whole batched fast ``predict`` is held against the JAX package's
``batched_forward_fast`` (interpret mode) within its own tests' bands:
relative Frobenius error 2e-2 for a stack with a 128-aligned layer, 3e-2
for a narrow one (tests/test_pallas_batched.py), whose narrow layers ran an
all-bf16 scan in JAX and run K5 here.

The ``cuda``-marked tests hold K5 against its plain version on the card and
skip without one. On a machine with a card:

    python -m pytest tests/test_torch_batched.py -m cuda --noconftest -q
"""

import os
import types

import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu_torch.ops import cuda_batched as cb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQUENTIAL = os.path.join(REPO, "model_saves", "pretrained_sequential.npz")
WIDE_R24 = os.path.join(REPO, "model_saves", "wide_r24_progressive.npz")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _normal(rng, shape, scale=1.0):
    return rng.normal(scale=scale, size=shape).astype(np.float32)


def _case(seed, T, B, n):
    """xp (T, B, 4n) and U (n, 4n) scaled 1/sqrt(n), as trained weights are."""
    rng = np.random.default_rng(seed)
    return _normal(rng, (T, B, 4 * n)), _normal(rng, (n, 4 * n), n ** -0.5)


def _ulp(v: float) -> float:
    """One bf16 ulp at |v| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _jax_bf16_recurrence(xp, U):
    """The kernel's arithmetic in JAX: bf16 operands, float32 accumulation
    and state, h out in xp's dtype."""
    import jax
    import jax.numpy as jnp
    from svd_lstm_tpu.models.lstm import gate_update

    U16 = U.astype(jnp.bfloat16)
    T, B, g4 = xp.shape
    n = g4 // 4

    def step(carry, xp_t):
        h, c = carry
        z = jnp.dot(h.astype(jnp.bfloat16), U16, preferred_element_type=jnp.float32)
        h, c = gate_update(z + xp_t.astype(jnp.float32), c)
        return (h, c), h.astype(xp.dtype)

    zeros = jnp.zeros((B, n), jnp.float32)
    return jax.lax.scan(step, (zeros, zeros), xp)[1]


# ---------------------------------------------------------------------------
# CPU: K5's plain version against the JAX package
# ---------------------------------------------------------------------------

SHAPES = [(7, 12, 40), (5, 24, 64), (4, 8, 128)]


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
@pytest.mark.parametrize("T,B,n", SHAPES)
def test_k5_matches_bf16_emulation(T, B, n, entry):
    import jax.numpy as jnp

    xp, U = _case(1, T, B, n)
    want = np.asarray(_jax_bf16_recurrence(jnp.asarray(xp).astype(jnp.bfloat16), jnp.asarray(U))
                      .astype(jnp.float32))
    fn = cb.batched_lstm_recurrence_plain if entry == "plain" else cb.batched_lstm_recurrence
    got = fn(torch.tensor(xp).bfloat16(), torch.tensor(U))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (T, B, n)
    np.testing.assert_allclose(_np(got), want, atol=_ulp(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("T,B,n", SHAPES)
def test_k5_plain_matches_pallas_interpret(T, B, n):
    """The interpret kernel's dot is float32 on the CPU; the port's rounds its
    operands to bf16, as the TPU's DEFAULT-precision dot did."""
    import jax.numpy as jnp
    from svd_lstm_tpu.ops.pallas_batched import batched_lstm_recurrence_pallas

    xp, U = _case(2, T, B, n)
    want = batched_lstm_recurrence_pallas(jnp.asarray(xp).astype(jnp.bfloat16), jnp.asarray(U),
                                          bt=8, interpret=True)
    got = cb.batched_lstm_recurrence_plain(torch.tensor(xp).bfloat16(), torch.tensor(U))
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)), atol=1e-2, rtol=0)


@pytest.mark.parametrize("T,B,n", SHAPES)
def test_k5_float32_xp_close_to_exact(T, B, n):
    import jax.numpy as jnp

    xp, U = _case(3, T, B, n)
    got = cb.batched_lstm_recurrence_plain(torch.tensor(xp), torch.tensor(U))
    assert got.dtype == torch.float32
    # the exact recurrence: float32 operands (the emulation with U and h unrounded)
    exact = _exact_recurrence(jnp.asarray(xp), jnp.asarray(U))
    assert _rel(_np(got), exact) <= 1e-2


def _exact_recurrence(xp, U):
    import jax
    import jax.numpy as jnp
    from svd_lstm_tpu.models.lstm import gate_update

    B, n = xp.shape[1], U.shape[0]

    def step(carry, xp_t):
        h, c = gate_update(xp_t + carry[0] @ U, carry[1])
        return (h, c), h

    zeros = jnp.zeros((B, n), jnp.float32)
    return np.asarray(jax.lax.scan(step, (zeros, zeros), xp)[1])


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
def test_k5_batch_rows_are_independent(entry):
    """Two identical halves of the batch give identical outputs: no state
    leaks from one row (or one tile of rows) into another."""
    xp, U = _case(4, 3, 16, 32)
    xp = np.concatenate([xp, xp], axis=1)
    fn = cb.batched_lstm_recurrence_plain if entry == "plain" else cb.batched_lstm_recurrence
    got = fn(torch.tensor(xp).bfloat16(), torch.tensor(U))
    assert torch.equal(got[:, :16], got[:, 16:])


# ---------------------------------------------------------------------------
# CPU: batched predict in its precision modes against the JAX package
# ---------------------------------------------------------------------------

def _jax_dense(units, d, seed):
    import jax
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    return init_stacked_lstm(jax.random.PRNGKey(seed), input_dim=d, units=units)


def _family(dense, family):
    """(JAX params of the family, JAX dense form batched_forward_fast runs)."""
    from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model, singular_to_dense
    from svd_lstm_tpu.ops.layouts import reconstruct_dense_model

    if family == "dense":
        return dense, dense
    single = make_singular_model(dense)
    if family == "singular":
        return single, singular_to_dense(single)
    reduced = make_reduced_model(single, rank=8)
    return reduced, reconstruct_dense_model(reduced)


@pytest.mark.parametrize("family", ["dense", "singular", "reduced"])
@pytest.mark.parametrize("units,band", [((40, 128), 2e-2), ((24, 40), 3e-2)], ids=["aligned", "narrow"])
def test_batched_fast_predict_matches_jax(units, band, family):
    import jax.numpy as jnp
    from svd_lstm_tpu import api as japi
    from svd_lstm_tpu.ops.pallas_batched import batched_forward_fast

    params, dense = _family(_jax_dense(units, 6, 1), family)
    x = _normal(np.random.default_rng(5), (4, 9, 6))
    want = np.asarray(batched_forward_fast(dense, jnp.asarray(x), bt=8, interpret=True))
    exact = np.asarray(japi.predict(params, jnp.asarray(x), consult_cache=False))
    model = P.from_numpy_tree(params, device="cpu")
    before = cb.batched_lstm_recurrence.launches
    got = P.predict(model, torch.tensor(x), precision="fast")
    assert cb.batched_lstm_recurrence.launches == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 9, 1)
    assert _rel(_np(got), want) <= band
    assert _rel(_np(got), exact) <= band
    # impl='scan' is the exact float32 loop in every mode
    scan = P.predict(model, torch.tensor(x), impl="scan", precision="fast")
    np.testing.assert_allclose(_np(scan), exact, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("path", [SEQUENTIAL, WIDE_R24], ids=["narrow", "wide-reduced"])
def test_batched_high_equals_exact_on_cpu(path):
    """TF32 does not exist on the CPU: 'high' gives the exact result there."""
    model = P.load_params(path, device="cpu")
    x = torch.tensor(_normal(np.random.default_rng(6), (3, 10, 16)))
    torch.testing.assert_close(P.predict(model, x, precision="high"), P.predict(model, x),
                               rtol=0, atol=0)


def test_batch1_high_equals_exact():
    model = P.load_params(WIDE_R24, device="cpu")
    x = torch.tensor(_normal(np.random.default_rng(7), (10, 16)))
    for impl in ("auto", "scan", "hybrid"):
        torch.testing.assert_close(P.predict(model, x, impl=impl, precision="high"),
                                   P.predict(model, x, impl=impl), rtol=0, atol=0)


def test_batch1_fast_raises_naming_roadmap():
    """Batch-1 fast returns the float32 (T, out) of the plain fast versions
    on the CPU (tests/test_torch_fast.py holds them to the JAX package), and
    an unknown precision raises. The name is historical: batch-1 fast raised,
    naming the ROADMAP item, until its bf16-operand kernels were ported."""
    model = P.load_params(SEQUENTIAL, device="cpu")
    x = torch.tensor(_normal(np.random.default_rng(9), (5, 16)))
    got = P.predict(model, x, precision="fast")
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 1)
    assert not torch.equal(got, P.predict(model, x))
    with pytest.raises(ValueError, match="unknown precision"):
        P.predict(model, x, precision="bf16")


@pytest.mark.parametrize("precision", ["exact", "high", "fast"])
@pytest.mark.parametrize("batched", [False, True], ids=["batch1", "batched"])
@pytest.mark.parametrize("path", [SEQUENTIAL, WIDE_R24], ids=["narrow", "wide"])
def test_valid_impls_with_precision_match_jax(path, batched, precision):
    import jax.numpy as jnp
    from svd_lstm_tpu import api as japi
    from svd_lstm_tpu.io.checkpoint import load_params as jax_load_params

    x = _normal(np.random.default_rng(8), (3, 8, 16) if batched else (8, 16))
    assert P.valid_impls(P.load_params(path, device="cpu"), torch.tensor(x), precision) == \
        japi.valid_impls(jax_load_params(path), jnp.asarray(x), precision)


def test_valid_impls_batched_fast_on_the_card_lists_auto():
    """valid_impls reads only the input's rank and device."""
    model = P.load_params(SEQUENTIAL, device="cpu")
    on_card = types.SimpleNamespace(ndim=3, device=torch.device("cuda", 0))
    assert P.valid_impls(model, on_card, "fast") == ["auto", "scan"]
    assert P.valid_impls(model, on_card, "high") == ["scan"]
    assert P.valid_impls(model, on_card) == ["scan"]


# ---------------------------------------------------------------------------
# CPU: precision scopes and cast_params
# ---------------------------------------------------------------------------

def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()


@pytest.mark.parametrize("start", ["highest", "high", "medium"])
def test_matmul_scope_sets_and_restores_every_flag(start):
    before = _flags()
    try:
        torch.set_float32_matmul_precision(start)
        outside = _flags()
        for mode, inside in (("exact", (False, "highest")), ("high", (True, "high")),
                             ("fast", outside)):
            with P.matmul_scope(mode):
                assert _flags() == inside, mode
            assert _flags() == outside, mode
        with P.exact_matmul():
            assert _flags() == (False, "highest")
        assert _flags() == outside
        with pytest.raises(ValueError, match="unknown precision"):
            P.matmul_scope("bf16")
    finally:
        torch.set_float32_matmul_precision(before[1])
        torch.backends.cuda.matmul.allow_tf32 = before[0]


def test_predict_high_runs_batched_with_tf32_and_restores(monkeypatch):
    from svd_lstm_tpu_torch import api

    seen = []
    real = api._dispatch
    monkeypatch.setattr(api, "_dispatch", lambda *a: seen.append(_flags()) or real(*a))
    model = P.load_params(SEQUENTIAL, device="cpu")
    before = _flags()
    P.predict(model, torch.zeros((2, 3, 16)), precision="high")
    P.predict(model, torch.zeros((3, 16)), precision="high")
    assert seen == [(True, "high"), (False, "highest")]  # batch-1 'high' is exact
    assert _flags() == before


def test_cast_params_matches_jax_and_leaves_the_model():
    import jax
    import jax.numpy as jnp
    from svd_lstm_tpu.utils.precision import cast_params as jax_cast

    params = _jax_dense((8, 12), 5, 2)
    model = P.from_numpy_tree(params, device="cpu")
    cast = P.cast_params(model)
    # the modules' parameter order is the JAX tree's leaf order
    for a, b in zip(cast.parameters(), jax.tree.leaves(jax_cast(params, jnp.bfloat16)), strict=True):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(a), np.asarray(b.astype(jnp.float32)))
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ---------------------------------------------------------------------------
# CPU: wrapper contract
# ---------------------------------------------------------------------------

def test_wrapper_rejects_bad_arguments():
    xp, U = (torch.tensor(a) for a in _case(9, 3, 2, 8))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        cb.batched_lstm_recurrence(xp.double(), U)
    with pytest.raises(ValueError, match="expected xp"):
        cb.batched_lstm_recurrence(xp[..., :20], U)
    with pytest.raises(ValueError, match="contiguous"):
        cb.batched_lstm_recurrence(xp.transpose(0, 1).contiguous().transpose(0, 1), U)
    with pytest.raises(ValueError, match="empty"):
        cb.batched_lstm_recurrence(xp[:0], U)
    with pytest.raises(ValueError, match="unsupported device"):
        cb.batched_lstm_recurrence(xp.to("meta"), U.to("meta"))
    with pytest.raises(ValueError, match="different devices"):
        cb.batched_lstm_recurrence(xp, U.to("meta"))


# ---------------------------------------------------------------------------
# on the card: K5 against its plain version
# ---------------------------------------------------------------------------

def _k5_tol(xp, U, plain) -> float:
    """2 bf16 ulps of max |h| (the output's rounding), or twice the plain
    version's distance from the same recurrence with float64 state (a
    float32 sum order that flips one bf16 h carries on), whichever is larger."""
    ref64 = cb.batched_lstm_recurrence_plain(xp.double(), U.double())
    drift = float((plain.double() - ref64).abs().max())
    return max(2 * _ulp(float(plain.float().abs().max())), 2 * drift)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,dtype", [(512, 40, torch.bfloat16), (30, 33, torch.bfloat16),
                                       (128, 20, torch.float32), (96, 16, torch.float32),
                                       (512, 2048, torch.bfloat16), (136, 40, torch.bfloat16),
                                       (512, 64, torch.float32), (30, 33, torch.float32)])
def test_cuda_k5_matches_plain(cuda, n, B, dtype, monkeypatch):
    xp, U = _case(10, 16, B, n)
    xp, U = torch.tensor(xp, device=cuda).to(dtype), torch.tensor(U, device=cuda)
    want = cb.batched_lstm_recurrence_plain(xp, U)
    tol = _k5_tol(xp, U, want)
    monkeypatch.setattr(cb, "batched_lstm_recurrence_plain", None)  # no fallback on the card
    before = cb.batched_lstm_recurrence.launches
    got = cb.batched_lstm_recurrence(xp, U)
    torch.cuda.synchronize()
    assert cb.batched_lstm_recurrence.launches == before + 1
    assert got.dtype == dtype
    assert float((got.float() - want.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n,B", [(512, 256), (512, 2048), (30, 256)])
def test_cuda_k5_one_launch_per_row_chunk(cuda, n, B, monkeypatch):
    """One K5 call issues one cooperative launch for each chunk of rows of
    its plan (one at B = 256), each for all T steps: not T launches."""
    xp, U = _case(13, 128, B, n)
    xp, U = torch.tensor(xp, device=cuda).bfloat16(), torch.tensor(U, device=cuda)
    calls = []
    launch = cb._launch
    monkeypatch.setattr(cb, "_launch", lambda name, *a: calls.append(name) or launch(name, *a))
    cb.batched_lstm_recurrence(xp, U)
    torch.cuda.synchronize()
    plan = cb.card_plan(cuda, B, n, True)
    assert calls == ["batched_lstm_recurrence"] * plan.chunks(B)
    assert (len(calls) == 1) == (B == 256)


@pytest.mark.cuda
def test_cuda_k5_batch_rows_are_independent(cuda):
    xp, U = _case(11, 5, 16, 64)
    xp = torch.tensor(np.concatenate([xp, xp], axis=1), device=cuda).bfloat16()
    got = cb.batched_lstm_recurrence(xp, torch.tensor(U, device=cuda))
    assert torch.equal(got[:, :16], got[:, 16:])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["dense", "reduced"])
def test_cuda_predict_fast_launches_k5_per_layer(cuda, family):
    model = P.load_params(SEQUENTIAL if family == "dense" else WIDE_R24, device=cuda)
    x = torch.tensor(_normal(np.random.default_rng(12), (8, 20, 16)), device=cuda)
    before = cb.batched_lstm_recurrence.launches
    got = P.predict(model, x, precision="fast")
    torch.cuda.synchronize()
    assert cb.batched_lstm_recurrence.launches == before + len(model.layers)
    exact = P.predict(model, x)
    assert _rel(_np(got), _np(exact)) <= 2e-2
