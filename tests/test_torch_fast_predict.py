"""Batch-1 ``predict(x, precision="fast")`` of every family and width of
the routing table against the JAX package on the CPU: the case of
tests/test_torch_fast.py moved into a file of its own so that
pytest-xdist's ``--dist loadfile`` can run it on another worker. Its
helpers, sizes and bands are test_torch_fast's, imported from it (its
docstring says what each reference is)."""

import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu_torch.io.checkpoint import from_numpy_tree
from svd_lstm_tpu_torch.ops import cuda_lstm as ck
from test_torch_fast import FAMILIES, WIDTHS, _band, _jax_family, _np, _rel, _t, _x


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
