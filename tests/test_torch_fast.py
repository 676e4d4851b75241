"""Batch-1 fast mode of the PyTorch port: the bf16-operand variants of K1–K4
(svd_lstm_tpu_torch/ops/cuda_lstm.py), the fast hybrids and the batch-1
fast routing of ``predict``, against the JAX package on the CPU.

Fast mode is the TPU's single-pass ``precision=DEFAULT`` dot: both operands
of every product rounded to bf16, exact products, float32 sums. On the CPU
the JAX package computes a DEFAULT-precision float32 dot in full float32,
so its fast functions are exact there. Hence three kinds of reference:

* where the JAX function itself rounds (``lstm_recurrence_pallas(
  weights_bf16=True)``: bf16 U and h), it is held to atol 1e-5;
* a bf16-operand emulation written in JAX here (``jnp.dot`` of bf16-cast
  operands with float32 accumulation, as the TPU's dot) for K1, K2 (with
  ``h·B`` rounded before the second product), K4 and the fast hybrids:
  atol 1e-5. The float32 sums run in another order, which can flip the
  rounding of a bf16 h and carry on through later steps (~1e-4); the
  seeds below give no such flip, and each test also asserts that the exact
  result is more than 1e-4 away, so a no-op rounding cannot pass;
* the JAX package's exact-on-the-CPU fast functions (``dot_precision=
  "default"``, ``predict(precision="fast")``): relative Frobenius error
  within the fast bands of the JAX package's own tests (2e-2 for a stack
  with a layer of 128 units or more, 3e-2 for a narrow one;
  tests/test_pallas_batched.py), and more than zero.
"""

import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu_torch.io.checkpoint import from_numpy_tree
from svd_lstm_tpu_torch.models.reduced import reduced_projection
from svd_lstm_tpu_torch.ops import cuda_lstm as ck
from svd_lstm_tpu_torch.ops import layouts

ATOL = 1e-5       # against a function that rounds as the kernels do
NOOP_GAP = 1e-4   # the exact result is at least this far from the fast one


def _normal(rng, shape, scale=1.0):
    return rng.normal(scale=scale, size=shape).astype(np.float32)


def _t(a):
    return tuple(_t(v) for v in a) if isinstance(a, tuple) else torch.tensor(a)


def _jnp(a):
    import jax.numpy as jnp

    return tuple(_jnp(v) for v in a) if isinstance(a, tuple) else jnp.asarray(a)


def _np(t):
    return t.detach().float().cpu().numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _band(units) -> float:
    return 2e-2 if max(units) >= 128 else 3e-2


# ---------------------------------------------------------------------------
# the bf16-operand emulation in JAX
# ---------------------------------------------------------------------------

def _d16(a, b):
    """The TPU's single-pass dot: bf16 operands, float32 accumulation."""
    import jax.numpy as jnp

    return jnp.dot(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)


def _two_step16(v, Bs, Cs, round_mid=True):
    """(v·B)·[I|C] per side (merged, or split: one pair per gate), both
    products bf16-operand; ``round_mid=False`` leaves v·B in float32."""
    import jax.numpy as jnp
    from svd_lstm_tpu.utils.linalg import fold_IC

    def pair(B, C):
        vb = _d16(v, B)
        if not round_mid:
            return jnp.dot(vb, fold_IC(B, C).astype(jnp.bfloat16).astype(jnp.float32))
        return _d16(vb, fold_IC(B, C))

    if isinstance(Bs, tuple):
        return jnp.concatenate([pair(B, C) for B, C in zip(Bs, Cs)], axis=-1)
    return pair(Bs, Cs)


def _scan_layers(x, zfns, units, h0=None, c0=None):
    """Time-outer, layer-inner recurrence: zfns[i](inp, h) -> z of layer i.
    x (T, d) -> the last layer's h (T, n)."""
    import jax
    import jax.numpy as jnp
    from svd_lstm_tpu.models.lstm import gate_update

    hs = [jnp.zeros((1, n), jnp.float32) if h0 is None else h0.reshape(1, n) for n in units]
    cs = [jnp.zeros((1, n), jnp.float32) if c0 is None else c0.reshape(1, n) for n in units]

    def step(carry, xt):
        hs, cs = carry
        inp, hs2, cs2 = xt[None], [], []
        for i, zfn in enumerate(zfns):
            h, c = gate_update(zfn(inp, hs[i]), cs[i])
            hs2.append(h)
            cs2.append(c)
            inp = h
        return (hs2, cs2), inp[0]

    return jax.lax.scan(step, (hs, cs), x)[1]


# ---------------------------------------------------------------------------
# inputs (weights scaled 1/sqrt(fan-in), as trained ones are)
# ---------------------------------------------------------------------------

def _dense_case(seed, n, T):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (T, 4 * n)), _normal(rng, (n, 4 * n), n ** -0.5),
            _normal(rng, (n,), 0.5), _normal(rng, (n,), 0.5))


def _reduced_case(seed, n, merged, T, r=7):
    rng = np.random.default_rng(seed)
    xp = _normal(rng, (T, 4 * n))
    if merged:
        uB = _normal(rng, (n, r), n ** -0.5)
        uC = _normal(rng, (r, 4 * n - r), r ** -0.5)
    else:
        uB = tuple(_normal(rng, (n, r + g), n ** -0.5) for g in range(4))
        uC = tuple(_normal(rng, (r + g, n - r - g), (r + g) ** -0.5) for g in range(4))
    return xp, uB, uC, _normal(rng, (n,), 0.5), _normal(rng, (n,), 0.5)


def _jax_dense(units, d, seed):
    import jax
    from svd_lstm_tpu.models.lstm import init_stacked_lstm

    return init_stacked_lstm(jax.random.PRNGKey(seed), input_dim=d, units=units)


def _well_conditioned(params, d: int) -> bool:
    """Whether a truncation's exact float32 forward stays within 3e-7
    (relative Frobenius) of its float64 forward on a probe input."""
    import copy

    model = from_numpy_tree(params, device="cpu")
    x = torch.tensor(_x(16, d, seed=0))
    f32 = ck.fused_reduced_stack_plain(model, x)
    f64 = ck.fused_reduced_stack_plain(copy.deepcopy(model).double(), x.double())
    return _rel(_np(f32), f64.numpy()) <= 3e-7


def _jax_family(units, family, d=16, seed=1):
    """JAX params of the family: dense, its singular form, or its reduced
    truncation (split, or merged for 'reduced_merged') at rank 8. A direct
    truncation of random weights is often ill-conditioned (|C| up to ~1e3,
    ROADMAP fault 3.1): its float32 forward drifts from float64, and bf16
    operands amplify the same C past the fast band in either package (up to
    0.7 relative on these shapes). The reduced families
    therefore take the first seed from ``seed`` on whose truncation is
    well-conditioned (:func:`_well_conditioned`)."""
    from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model

    while True:
        dense = _jax_dense(units, d, seed)
        if family == "dense":
            return dense
        single = make_singular_model(dense, merged_kernel=family == "reduced_merged")
        if family == "singular":
            return single
        reduced = make_reduced_model(single, rank=8)
        if _well_conditioned(reduced, d):
            return reduced
        seed += 1


def _x(T, d=16, seed=5):
    return _normal(np.random.default_rng(seed), (T, d))


# ---------------------------------------------------------------------------
# K3: against the JAX kernel's own bf16 form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["plain", "wrapper"])
@pytest.mark.parametrize("n,T", [(24, 16), (136, 64)])
def test_k3_fast_matches_pallas_weights_bf16(n, T, entry):
    """lstm_recurrence_pallas(weights_bf16=True) rounds U and h to bf16 and
    accumulates in float32 on the CPU too: the kernels' fast arithmetic,
    which the port runs for dot_precision="default"."""
    from svd_lstm_tpu.ops.pallas_lstm import lstm_recurrence_pallas

    xp, U, h0, c0 = _dense_case(1, n, T)
    want = np.asarray(lstm_recurrence_pallas(
        _jnp(xp), _jnp(U), _jnp(h0).reshape(1, n), _jnp(c0).reshape(1, n),
        weights_bf16=True, interpret=True))
    fn = ck.lstm_recurrence_plain if entry == "plain" else ck.lstm_recurrence
    got = fn(*_t((xp, U, h0, c0)), dot_precision="default")
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)
    assert _maxdiff(_np(fn(*_t((xp, U, h0, c0)))), want) > NOOP_GAP


# ---------------------------------------------------------------------------
# K2: against the bf16-operand emulation, and within the band of JAX's own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["plain", "wrapper"])
@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
@pytest.mark.parametrize("n,T", [(24, 16), (136, 40)])
def test_k2_fast_matches_bf16_emulation(n, T, merged, entry):
    xp, uB, uC, h0, c0 = _reduced_case(2, n, merged, T)
    jB, jC = _jnp(uB), _jnp(uC)
    want = _scan_layers(_jnp(xp), [lambda inp, h: inp + _two_step16(h, jB, jC)], [n],
                        _jnp(h0), _jnp(c0))
    # the likely mistake, h·B left in float32, lies outside the tolerance
    no_mid = _scan_layers(_jnp(xp), [lambda inp, h: inp + _two_step16(h, jB, jC, False)], [n],
                          _jnp(h0), _jnp(c0))
    assert _maxdiff(no_mid, want) > ATOL
    # the scan adds xp_t as the layer's "input": z = xp_t + rec(h)
    fn = ck.reduced_recurrence_plain if entry == "plain" else ck.reduced_recurrence
    got = fn(*_t((xp, uB, uC, h0, c0)), dot_precision="default")
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0)
    assert _maxdiff(_np(fn(*_t((xp, uB, uC, h0, c0)))), want) > NOOP_GAP


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "split"])
@pytest.mark.parametrize("n", [24, 136])
def test_k2_fast_within_band_of_pallas_default(n, merged):
    from svd_lstm_tpu.ops.pallas_lstm import reduced_recurrence_pallas

    xp, uB, uC, h0, c0 = _reduced_case(3, n, merged, 32)
    want = np.asarray(reduced_recurrence_pallas(
        _jnp(xp), _jnp(uB), _jnp(uC), _jnp(h0).reshape(1, n), _jnp(c0).reshape(1, n),
        interpret=True, dot_precision="default"))
    got = _np(ck.reduced_recurrence_plain(*_t((xp, uB, uC, h0, c0)), dot_precision="default"))
    assert 0 < _rel(got, want) <= _band([n])


# ---------------------------------------------------------------------------
# K1 and K4: whole stacks
# ---------------------------------------------------------------------------

def _k1_emulation(params, x):
    zfns = [lambda inp, h, l=l: _d16(inp, l.W) + _d16(h, l.U) + l.b for l in params.layers]
    h = _scan_layers(_jnp(x), zfns, [l.units for l in params.layers])
    return np.asarray(h @ params.head.w + params.head.b)


def _k4_emulation(params, x):
    zfns = []
    for l in params.layers:
        wB, wC, uB, uC = (tuple(f) if l.split else f for f in (l.wB, l.wC, l.uB, l.uC))
        zfns.append(lambda inp, h, wB=wB, wC=wC, uB=uB, uC=uC, b=l.b:
                    _two_step16(inp, wB, wC) + _two_step16(h, uB, uC) + b)
    h = _scan_layers(_jnp(x), zfns, [l.units for l in params.layers])
    return np.asarray(h @ params.head.w + params.head.b)


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
@pytest.mark.parametrize("units", [(24, 40), (136,)])
def test_k1_fast_matches_bf16_emulation(units, entry):
    params = _jax_dense(units, 16, 3)
    x = _x(24)
    model = from_numpy_tree(params, device="cpu")
    fn = ck.fused_dense_stack_plain if entry == "plain" else ck.fused_dense_stack
    want = _k1_emulation(params, x)
    np.testing.assert_allclose(_np(fn(model, _t(x), dot_precision="default")), want,
                               atol=ATOL, rtol=0)
    assert _maxdiff(_np(fn(model, _t(x))), want) > NOOP_GAP


@pytest.mark.parametrize("units", [(24, 40), (136,)])
def test_k1_fast_within_band_of_pallas_default(units):
    from svd_lstm_tpu.ops.pallas_lstm import fused_dense_stack_pallas

    params = _jax_dense(units, 16, 4)
    x = _x(24, seed=6)
    want = np.asarray(fused_dense_stack_pallas(params, _jnp(x), interpret=True,
                                               dot_precision="default"))
    got = _np(ck.fused_dense_stack_plain(from_numpy_tree(params, device="cpu"), _t(x),
                                         dot_precision="default"))
    assert 0 < _rel(got, want) <= _band(units)


@pytest.mark.parametrize("entry", ["plain", "wrapper"])
@pytest.mark.parametrize("family", ["reduced", "reduced_merged"], ids=["split", "merged"])
@pytest.mark.parametrize("units", [(24, 40), (136,)])
def test_k4_fast_matches_bf16_emulation(units, family, entry):
    params = _jax_family(units, family, seed=5)
    x = _x(24, seed=7)
    model = from_numpy_tree(params, device="cpu")
    fn = ck.fused_reduced_stack_plain if entry == "plain" else ck.fused_reduced_stack
    want = _k4_emulation(params, x)
    np.testing.assert_allclose(_np(fn(model, _t(x), dot_precision="default")), want,
                               atol=ATOL, rtol=0)
    assert _maxdiff(_np(fn(model, _t(x))), want) > NOOP_GAP


@pytest.mark.parametrize("family", ["reduced", "reduced_merged"], ids=["split", "merged"])
@pytest.mark.parametrize("units", [(24, 40), (136,)])
def test_k4_fast_within_band_of_pallas_default(units, family):
    from svd_lstm_tpu.ops.pallas_lstm import fused_reduced_stack_pallas

    params = _jax_family(units, family, seed=6)
    x = _x(24, seed=8)
    want = np.asarray(fused_reduced_stack_pallas(params, _jnp(x), interpret=True,
                                                 dot_precision="default"))
    got = _np(ck.fused_reduced_stack_plain(from_numpy_tree(params, device="cpu"), _t(x),
                                           dot_precision="default"))
    assert 0 < _rel(got, want) <= _band(units)


# ---------------------------------------------------------------------------
# the fast hybrids: x-side products with bf16 operands, results not rounded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("units", [(24, 40), (136,)])
def test_dense_hybrid_fast_matches_bf16_emulation(units):
    params = _jax_dense(units, 16, 7)
    x = _x(20, seed=9)
    h = _jnp(x)
    for l in params.layers:
        xp = _d16(h, l.W) + l.b
        h = _scan_layers(xp, [lambda inp, hh, U=l.U: inp + _d16(hh, U)], [l.units])
    want = np.asarray(h @ params.head.w + params.head.b)
    model = from_numpy_tree(params, device="cpu")
    got = ck.dense_forward_hybrid(model, _t(x), dot_precision="default")
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)
    assert _maxdiff(_np(ck.dense_forward_hybrid(model, _t(x))), want) > NOOP_GAP


@pytest.mark.parametrize("family", ["reduced", "reduced_merged"], ids=["split", "merged"])
@pytest.mark.parametrize("units", [(24, 40), (136,)])
def test_reduced_hybrid_fast_matches_bf16_emulation(units, family):
    params = _jax_family(units, family, seed=9)
    x = _x(20, seed=11)
    h = _jnp(x)
    for l in params.layers:
        wB, wC, uB, uC = (tuple(f) if l.split else f for f in (l.wB, l.wC, l.uB, l.uC))
        xp = _two_step16(h, wB, wC) + l.b
        h = _scan_layers(xp, [lambda inp, hh, uB=uB, uC=uC: inp + _two_step16(hh, uB, uC)],
                         [l.units])
    want = np.asarray(h @ params.head.w + params.head.b)
    model = from_numpy_tree(params, device="cpu")
    got = ck.reduced_forward_hybrid(model, _t(x), dot_precision="default")
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)
    assert _maxdiff(_np(ck.reduced_forward_hybrid(model, _t(x))), want) > NOOP_GAP


def test_reduced_projection_bf16_keeps_float32():
    """The fast x-side form: bf16-rounded operands, a float32 result that is
    not rounded to bf16 (the batched path's choice, not this one's)."""
    params = _jax_family((40,), "reduced_merged", seed=10)
    layer = from_numpy_tree(params, device="cpu").layers[0]
    x = torch.tensor(_x(12, seed=12))
    fast = reduced_projection(layer, x, "w", bf16=True)
    assert fast.dtype == torch.float32
    assert not torch.equal(fast, fast.to(torch.bfloat16).float())
    assert not torch.equal(fast, reduced_projection(layer, x, "w"))


# ---------------------------------------------------------------------------
# predict(x (T, d), precision="fast")
# ---------------------------------------------------------------------------

WIDTHS = {"narrow": ((24, 40), 32), "mid": ((136,), 24), "wide": ((256,), 16)}
FAMILIES = ["dense", "singular", "reduced", "reduced_merged"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("width", list(WIDTHS))
def test_predict_fast_matches_jax(width, family):
    """Every family × width of the routing table. JAX's predict(fast) runs
    the exact scan on the CPU; the port runs its plain fast versions."""
    import jax.numpy as jnp
    from svd_lstm_tpu import api as japi

    units, T = WIDTHS[width]
    params = _jax_family(units, family, seed=11)
    x = _x(T, seed=13)
    want = np.asarray(japi.predict(params, jnp.asarray(x), precision="fast", consult_cache=False))
    model = from_numpy_tree(params, device="cpu")
    before = dict(ck.LAUNCHES)
    got = P.predict(model, _t(x), precision="fast")
    assert ck.LAUNCHES == before  # CPU tensors: the plain versions
    assert got.dtype == torch.float32 and tuple(got.shape) == (T, 1)
    assert 0 < _rel(_np(got), want) <= _band(units)
    assert not torch.equal(got, P.predict(model, _t(x)))
    # impl='scan' is the exact float32 loop in every mode
    scan = P.predict(model, _t(x), impl="scan", precision="fast")
    np.testing.assert_allclose(_np(scan), want, atol=2e-5, rtol=1e-5)


# the routing table of svd_lstm_tpu/api.py:212-290 in fast mode: the
# recurrence kernel each (family, width, impl) reaches
ROUTES = {
    ("dense", "narrow", "auto"): "K1", ("dense", "narrow", "fused"): "K1",
    ("dense", "narrow", "hybrid"): "K3", ("dense", "mid", "auto"): "K3",
    ("dense", "mid", "hybrid"): "K3", ("dense", "wide", "auto"): "K3",
    ("dense", "wide", "hybrid"): "K3",
    ("singular", "narrow", "auto"): "K1", ("singular", "narrow", "fused"): "K1",
    ("singular", "narrow", "hybrid"): "K3", ("singular", "mid", "auto"): "K3",
    ("singular", "mid", "hybrid"): "K3", ("singular", "wide", "auto"): "K3",
    ("singular", "wide", "hybrid"): "K3",
    ("reduced", "narrow", "auto"): "K1", ("reduced", "narrow", "fused"): "K1",
    ("reduced", "narrow", "hybrid"): "K2", ("reduced", "mid", "auto"): "K3",
    ("reduced", "mid", "hybrid"): "K2", ("reduced", "wide", "auto"): "K2",
    ("reduced", "wide", "hybrid"): "K2",
}
_JAX_ROUTES = {
    "fused_dense_stack_pallas": "K1", "singular_forward_fused": "K1",
    "reduced_forward_fused": "K1", "dense_forward_hybrid": "K3",
    "reduced_forward_hybrid": "K2",
}


def _jax_route(monkeypatch, params, x) -> set:
    """The kernel the JAX package's predict(precision='fast') reaches on a
    TPU: its kernel entry points replaced by recorders, _on_tpu forced."""
    import jax.numpy as jnp
    from svd_lstm_tpu import api as japi
    from svd_lstm_tpu.ops import layouts as jlayouts
    from svd_lstm_tpu.ops import pallas_lstm

    seen = set()

    def recorder(name):
        def fn(p, x1, **kw):
            assert kw.get("dot_precision") == "default", (name, kw)
            seen.add(_JAX_ROUTES[name])
            return jnp.zeros((x1.shape[0], 1))
        return fn

    monkeypatch.setattr(japi, "_on_tpu", lambda: True)
    for mod, name in ((pallas_lstm, "fused_dense_stack_pallas"), (pallas_lstm, "dense_forward_hybrid"),
                      (pallas_lstm, "reduced_forward_hybrid"), (jlayouts, "singular_forward_fused"),
                      (jlayouts, "reduced_forward_fused")):
        monkeypatch.setattr(mod, name, recorder(name))
    return seen


def _port_route(monkeypatch) -> tuple:
    """Recorders around the port's kernel wrappers; returns (kernels seen,
    dot_precisions seen)."""
    seen, precisions = set(), set()

    def spy(name, real):
        def fn(*a, **kw):
            seen.add(name)
            precisions.add(kw.get("dot_precision"))
            return real(*a, **kw)
        return fn

    fused = spy("K1", ck.fused_dense_stack)
    monkeypatch.setattr(ck, "fused_dense_stack", fused)
    monkeypatch.setattr(layouts, "fused_dense_stack", fused)
    monkeypatch.setattr(ck, "lstm_recurrence", spy("K3", ck.lstm_recurrence))
    monkeypatch.setattr(ck, "reduced_recurrence", spy("K2", ck.reduced_recurrence))
    return seen, precisions


@pytest.mark.parametrize("family,width,impl", list(ROUTES))
def test_batch1_fast_routing_matches_jax(monkeypatch, family, width, impl):
    """impl='fused' above n = 128 raises in both packages (test_torch_api)."""
    units, _ = WIDTHS[width]
    params = _jax_family(units, family, seed=12)
    x = _x(4)
    model = from_numpy_tree(params, device="cpu")
    seen, precisions = _port_route(monkeypatch)
    P.predict(model, _t(x), impl=impl, precision="fast")
    jax_seen = _jax_route(monkeypatch, params, x)
    from svd_lstm_tpu import api as japi

    japi.predict(params, _jnp(x), impl=impl, precision="fast", consult_cache=False)
    assert seen == jax_seen == {ROUTES[(family, width, impl)]}
    assert precisions == {"default"}
