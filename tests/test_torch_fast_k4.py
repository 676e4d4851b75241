"""K4's bf16-operand variant (``fused_reduced_stack`` with ``dot_precision=
"default"``) against the JAX package on the CPU: the two K4 tests of
tests/test_torch_fast.py, in a file of their own so that pytest-xdist's
``--dist loadfile`` can run them on another worker. Their helpers, sizes and
tolerances are test_torch_fast's, imported from it (its docstring says what
each reference is)."""

import numpy as np
import pytest

from svd_lstm_tpu_torch.io.checkpoint import from_numpy_tree
from svd_lstm_tpu_torch.ops import cuda_lstm as ck
from test_torch_fast import (
    ATOL,
    NOOP_GAP,
    _band,
    _jax_family,
    _jnp,
    _k4_emulation,
    _maxdiff,
    _np,
    _rel,
    _t,
    _x,
)


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
