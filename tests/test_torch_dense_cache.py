"""The fused route's cached dense reconstruction (svd_lstm_tpu_torch/ops/
layouts.py: ``cached_dense``), on the CPU.

``predict(impl="fused")`` of a reduced or singular model runs the model's
exact dense reconstruction through K1; the reconstruction is built once per
model and reused until a parameter is replaced or updated in place. Checked
on the 4×30 checkpoint's split r = 15 truncation (the narrow point of
``chip_smoke.py``): a cached call gives a fresh model's output bit for bit,
an in-place update of one factor is seen at the next call, and a call
changes neither ``state_dict()`` nor ``parameters()``.
"""

import copy
import os

import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu_torch.ops import layouts

SAVES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "model_saves")
DENSE_30 = os.path.join(SAVES, "pretrained_30units_v4_n1.5.npz")


@pytest.fixture(scope="module")
def models():
    dense = P.load_params(DENSE_30, device="cpu")
    singular = P.make_singular_model(dense, merged_kernel=False)
    return singular, P.make_reduced_model(singular, rank=15)


@pytest.fixture
def x():
    return torch.tensor(np.random.default_rng(0).normal(size=(24, 16)), dtype=torch.float32)


def _counted(monkeypatch):
    """Counts the reconstructions the cache builds."""
    builds = []
    for name in ("reconstruct_dense_model", "singular_to_dense"):
        fn = getattr(layouts, name)
        monkeypatch.setattr(layouts, name, lambda m, fn=fn: builds.append(m) or fn(m))
    return builds


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("family", ["reduced", "singular"])
def test_a_cached_call_equals_a_fresh_model(models, x, family, precision, monkeypatch):
    model = copy.deepcopy(models[1] if family == "reduced" else models[0])
    builds = _counted(monkeypatch)
    first = P.predict(model, x, impl="fused", precision=precision)
    second = P.predict(model, x, impl="fused", precision=precision)
    assert len(builds) == 1  # the second call reused the reconstruction
    fresh = P.predict(copy.deepcopy(model), x, impl="fused", precision=precision)
    assert torch.equal(first, second) and torch.equal(second, fresh)


@pytest.mark.parametrize("family", ["reduced", "singular"])
def test_an_in_place_update_rebuilds(models, x, family, monkeypatch):
    model = copy.deepcopy(models[1] if family == "reduced" else models[0])
    builds = _counted(monkeypatch)
    before = P.predict(model, x, impl="fused")
    with torch.no_grad():
        factor = model.layers[1].uB[2] if family == "reduced" else model.layers[1].us
        factor.mul_(1.5)
    after = P.predict(model, x, impl="fused")
    assert len(builds) == 2
    assert not torch.equal(before, after)
    assert torch.equal(after, P.predict(copy.deepcopy(model), x, impl="fused"))


def test_a_replaced_parameter_rebuilds(models, x):
    model = copy.deepcopy(models[1])
    P.predict(model, x, impl="fused")
    layer = model.layers[0]
    layer.b = torch.nn.Parameter(layer.b.detach() + 0.25)
    assert torch.equal(P.predict(model, x, impl="fused"),
                       P.predict(copy.deepcopy(model), x, impl="fused"))


def test_a_call_leaves_the_module_as_it_was(models, x):
    model = copy.deepcopy(models[1])
    keys = list(model.state_dict())
    params = [id(p) for p in model.parameters()]
    children = [name for name, _ in model.named_modules()]
    P.predict(model, x, impl="fused")
    P.predict(model, x, impl="fused", precision="fast")
    assert list(model.state_dict()) == keys
    assert [id(p) for p in model.parameters()] == params
    assert [name for name, _ in model.named_modules()] == children


def test_the_cache_goes_with_the_model(models, x):
    model = copy.deepcopy(models[1])
    P.predict(model, x, impl="fused")
    assert model in layouts._DENSE_CACHE
    size = len(layouts._DENSE_CACHE)
    del model
    assert len(layouts._DENSE_CACHE) == size - 1
