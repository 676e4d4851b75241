"""The port's ``predict`` path end to end, against the JAX package on the CPU.

The slice: load a committed checkpoint, predict with the dense model,
factorize, truncate, predict with the reduced model, report the RMSE. On the
CPU every impl runs the plain versions; tolerance atol 2e-5, rtol 1e-5
(float32 on both sides, different summation order).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from svd_lstm_tpu import api as japi
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.io.checkpoint import load_params as jax_load_params
from svd_lstm_tpu.models.reduced import reduced_lstm_apply
from svd_lstm_tpu.ops.layouts import reduced_forward_dense_recurrent
from svd_lstm_tpu.train.metrics import rmse as jax_rmse
from svd_lstm_tpu_torch import api

ATOL, RTOL = 2e-5, 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQUENTIAL = os.path.join(REPO, "model_saves", "pretrained_sequential.npz")
WIDE_R24 = os.path.join(REPO, "model_saves", "wide_r24_progressive.npz")


def _x(T, batch=None, seed=0):
    shape = (T, 16) if batch is None else (batch, T, 16)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def slice_jax():
    """The JAX package's run of the slice: 2x40, T=64, split, r=15."""
    x = _x(64)
    dense = jax_load_params(SEQUENTIAL)
    reduced = make_reduced_model(make_singular_model(dense, merged_kernel=False), rank=15)
    y_full = np.asarray(japi.predict(dense, jnp.asarray(x), consult_cache=False))
    y_red = np.asarray(japi.predict(reduced, jnp.asarray(x), consult_cache=False))
    return x, y_full, y_red, jax_rmse(y_full, y_red), sum(l.weight_count() for l in reduced.layers)


@pytest.mark.parametrize("impl", ["auto", "scan", "fused", "hybrid"])
def test_slice_end_to_end_matches_jax(slice_jax, impl):
    x, y_full_j, y_red_j, rmse_j, weights_j = slice_jax
    dense = P.load_params(SEQUENTIAL, device="cpu")
    reduced = P.make_reduced_model(P.make_singular_model(dense, merged_kernel=False), rank=15)
    y_full = P.predict(dense, torch.tensor(x), impl=impl)
    y_red = P.predict(reduced, torch.tensor(x), impl=impl)
    assert tuple(y_full.shape) == tuple(y_red.shape) == (64, 1)
    _close(y_full, y_full_j)
    _close(y_red, y_red_j)
    assert P.rmse(y_full.numpy(), y_red.numpy()) == pytest.approx(rmse_j, rel=1e-3, abs=1e-6)
    assert sum(l.weight_count() for l in reduced.layers) == weights_j


@pytest.mark.parametrize("impl", ["auto", "fused", "hybrid"])
def test_singular_predict_matches_jax(impl):
    x = _x(32, seed=1)
    sj = make_singular_model(jax_load_params(SEQUENTIAL), merged_kernel=True)
    want = japi.predict(sj, jnp.asarray(x), consult_cache=False)
    _close(P.predict(P.from_numpy_tree(sj, device="cpu"), torch.tensor(x), impl=impl), want)


@pytest.mark.parametrize("impl", ["scan", "hybrid", "apply"])
def test_wide_reduced_checkpoint_matches_jax(impl):
    """The checkpoint's C factors reach |C| ~ 200, which magnifies float32
    rounding in (x·B)·[I|C]: the JAX package's own two exact layouts of it
    (two-step scan, dense-reconstructed scan) already differ by ~6e-5 at
    T=16. The port is held to twice that spread."""
    x = _x(16, seed=2)
    params = jax_load_params(WIDE_R24)
    want = np.asarray(reduced_lstm_apply(params, jnp.asarray(x)[None])[0])
    spread = np.abs(
        np.asarray(reduced_forward_dense_recurrent(params, jnp.asarray(x)[None])[0]) - want
    ).max()
    model = P.load_params(WIDE_R24, device="cpu")
    if impl == "apply":
        got = P.reduced_lstm_apply(model, torch.tensor(x)[None])[0].detach()
    else:
        got = P.predict(model, torch.tensor(x), impl=impl)
    np.testing.assert_allclose(got.numpy(), want, atol=max(ATOL, 2 * spread), rtol=0)


@pytest.mark.parametrize("family", ["dense", "reduced"])
def test_batched_predict_matches_jax(family):
    x = _x(20, batch=3, seed=3)
    dj = jax_load_params(SEQUENTIAL)
    pj = dj if family == "dense" else make_reduced_model(make_singular_model(dj), rank=15)
    want = japi.predict(pj, jnp.asarray(x), consult_cache=False)
    got = P.predict(P.from_numpy_tree(pj, device="cpu"), torch.tensor(x))
    assert tuple(got.shape) == (3, 20, 1)
    _close(got, want)


@pytest.mark.parametrize("path", [SEQUENTIAL, WIDE_R24], ids=["narrow", "wide"])
@pytest.mark.parametrize("batched", [False, True], ids=["batch1", "batched"])
def test_valid_impls_and_input_dim_match_jax(path, batched):
    x = _x(8, batch=3 if batched else None)
    pj, pt = jax_load_params(path), P.load_params(path, device="cpu")
    assert P.valid_impls(pt, torch.tensor(x)) == japi.valid_impls(pj, jnp.asarray(x))
    assert P.model_input_dim(pt) == japi.model_input_dim(pj) == 16


def test_predict_contract():
    narrow, wide = P.load_params(SEQUENTIAL, device="cpu"), P.load_params(WIDE_R24, device="cpu")
    x1, xb = torch.tensor(_x(4)), torch.tensor(_x(4, batch=2))
    with pytest.raises(ValueError, match="unknown impl"):
        P.predict(narrow, x1, impl="pallas")
    with pytest.raises(ValueError, match="unknown precision"):
        P.predict(narrow, x1, precision="f64")
    fast = P.predict(narrow, x1, precision="fast")  # batch-1 fast: bf16-operand K1-K3
    assert fast.dtype == torch.float32 and tuple(fast.shape) == (4, 1)
    torch.testing.assert_close(P.predict(narrow, x1, precision="high"), P.predict(narrow, x1),
                               rtol=0, atol=0)  # batch-1 high runs the exact path
    for impl in ("fused", "hybrid"):
        with pytest.raises(ValueError, match="batch-1 only"):
            P.predict(narrow, xb, impl=impl)
    with pytest.raises(ValueError, match="n <= 128"):
        P.predict(wide, x1, impl="fused")
    with pytest.raises(TypeError, match="unknown model params"):
        P.predict(torch.nn.Linear(16, 1), x1)


@pytest.mark.parametrize("bad", ["bf16", "DEFAULT", "high"])
def test_unknown_dot_precision_raises(bad):
    """As the JAX package's _bad_dot_precision: only None, 'default' and
    'highest' name a kernel precision."""
    from svd_lstm_tpu_torch.ops import cuda_lstm as ck

    narrow = P.load_params(SEQUENTIAL, device="cpu")
    reduced = P.make_reduced_model(P.make_singular_model(narrow, merged_kernel=False), rank=15)
    x = torch.tensor(_x(4))
    calls = [
        lambda: ck.fused_dense_stack(narrow, x, dot_precision=bad),
        lambda: ck.fused_reduced_stack(reduced, x, dot_precision=bad),
        lambda: ck.dense_forward_hybrid(narrow, x, dot_precision=bad),
        lambda: ck.reduced_forward_hybrid(reduced, x, dot_precision=bad),
        lambda: ck.lstm_recurrence(torch.zeros((4, 8)), torch.zeros((2, 8)), dot_precision=bad),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="unknown dot_precision"):
            call()


def test_unknown_timing_impl_raises():
    from svd_lstm_tpu_torch.bench.timing import forward_fns, time_all_impls, time_full_vs_reduced

    narrow = P.load_params(SEQUENTIAL, device="cpu")
    x = torch.tensor(_x(4))
    for impl in ("fused", "pallas2", "cudnn"):
        with pytest.raises(ValueError, match="unknown impl"):
            time_full_vs_reduced(narrow, narrow, x, impl=impl)  # before any timing
    with pytest.raises(ValueError, match="unknown impl"):
        time_all_impls(narrow, narrow, x, impls=("bogus",))
    for precision in ("high", "bf16"):
        with pytest.raises(ValueError, match="unknown precision"):
            time_full_vs_reduced(narrow, narrow, x, precision=precision)
    assert [len(forward_fns(impl)) for impl in ("auto", "scan", "pallas", "hybrid")] == [2] * 4


@pytest.mark.parametrize("impl", ["auto", "scan", "pallas", "hybrid"])
def test_timing_forward_fns_in_fast_mode(impl):
    """The timing harness's fast mode runs each impl's bf16-operand kernels
    (their plain versions on CPU tensors); scan stays the exact loop."""
    from svd_lstm_tpu_torch.bench.timing import forward_fns
    from svd_lstm_tpu_torch.ops import cuda_lstm as ck

    dense = P.load_params(SEQUENTIAL, device="cpu")
    reduced = P.make_reduced_model(P.make_singular_model(dense, merged_kernel=False), rank=15)
    x = torch.tensor(_x(8))
    want = {
        "auto": (lambda m: P.predict(m, x, precision="fast"),) * 2,
        "scan": (None, None),  # the exact loop itself
        "pallas": (lambda m: ck.fused_dense_stack_plain(m, x, "default"),
                   lambda m: ck.fused_reduced_stack_plain(m, x, "default")),
        "hybrid": (lambda m: ck.dense_forward_hybrid(m, x, dot_precision="default"),
                   lambda m: ck.reduced_forward_hybrid(m, x, dot_precision="default")),
    }[impl]
    for model, fast, exact, ref in zip((dense, reduced), forward_fns(impl, "fast"),
                                       forward_fns(impl), want):
        got = fast(model, x)
        torch.testing.assert_close(got, exact(model, x) if ref is None else ref(model),
                                   rtol=0, atol=0)
        assert torch.equal(got, exact(model, x)) == (impl == "scan")


def test_jax_raises_alike():
    """The conditions of the contract above are the JAX package's."""
    narrow, wide = jax_load_params(SEQUENTIAL), jax_load_params(WIDE_R24)
    x1, xb = jnp.asarray(_x(4)), jnp.asarray(_x(4, batch=2))
    with pytest.raises(ValueError, match="unknown impl"):
        japi.predict(narrow, x1, impl="pallas", consult_cache=False)
    with pytest.raises(ValueError, match="unknown precision"):
        japi.predict(narrow, x1, precision="f64", consult_cache=False)
    with pytest.raises(ValueError, match="batch-1 only"):
        japi.predict(narrow, xb, impl="fused", consult_cache=False)
    with pytest.raises(ValueError, match="n <= 128"):
        japi.predict(wide, x1, impl="fused", consult_cache=False)


def test_exact_mode_is_set_per_call_and_restored(monkeypatch):
    seen = {}

    def spy(model, x, impl, batched, dp=None):
        seen["tf32"] = torch.backends.cuda.matmul.allow_tf32
        seen["precision"] = torch.get_float32_matmul_precision()
        seen["grad"] = torch.is_grad_enabled()
        return x

    monkeypatch.setattr(api, "_dispatch", spy)
    before = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    try:
        torch.set_float32_matmul_precision("high")  # TF32 on
        assert torch.backends.cuda.matmul.allow_tf32 is True
        P.predict(P.load_params(SEQUENTIAL, device="cpu"), torch.tensor(_x(4)))
        assert seen == {"tf32": False, "precision": "highest", "grad": False}
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before[1])
        torch.backends.cuda.matmul.allow_tf32 = before[0]


def test_import_loads_no_jax():
    from conftest import subprocess_env

    code = (
        "import sys, torch\n"
        "prec = torch.get_float32_matmul_precision()\n"
        "import svd_lstm_tpu_torch\n"
        "import svd_lstm_tpu_torch.data, svd_lstm_tpu_torch.train.loop, svd_lstm_tpu_torch.train.finetune\n"
        "import svd_lstm_tpu_torch.ops.cuda_train, svd_lstm_tpu_torch.ops.singular_train\n"
        "import svd_lstm_tpu_torch.ops.reduced_train\n"
        "from svd_lstm_tpu_torch import recover_reduced_gated, truncate_recover_progressive\n"
        "import svd_lstm_tpu_torch.ops.cuda_batched, svd_lstm_tpu_torch.utils.precision\n"
        "import svd_lstm_tpu_torch.utils.quantize, svd_lstm_tpu_torch.models.streaming\n"
        "import svd_lstm_tpu_torch.io.int8_export, svd_lstm_tpu_torch.io.csv_weights\n"
        "import svd_lstm_tpu_torch.io.native, svd_lstm_tpu_torch.__main__\n"
        "import svd_lstm_tpu_torch.bench.sweep, svd_lstm_tpu_torch.bench.trace\n"
        "import svd_lstm_tpu_torch.bench.roofline, svd_lstm_tpu_torch.bench.autotune\n"
        "import svd_lstm_tpu_torch.parallel, svd_lstm_tpu_torch.entry\n"
        "from svd_lstm_tpu_torch.examples import distributed_training, wide_rank_accuracy\n"
        "from svd_lstm_tpu_torch.examples import conv_compression, realtime_stream\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'svd_lstm_tpu')]\n"
        "assert not bad, bad\n"
        "assert torch.get_float32_matmul_precision() == prec\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=subprocess_env(), cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_in_the_port_sources():
    root = os.path.join(REPO, "svd_lstm_tpu_torch")
    seen = set()
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py"):
                seen.add(os.path.relpath(os.path.join(dirpath, name), root))
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                for banned in ("import jax", "from jax", "import optax", "from svd_lstm_tpu.", "import svd_lstm_tpu\n"):
                    assert banned not in src, (name, banned)
    # the deployment, evaluation and parallel slices' own copies of the JAX package's modules
    assert {"utils/quantize.py", "models/streaming.py", "io/int8_export.py", "io/csv_weights.py",
            "io/native.py", "__main__.py", "bench/sweep.py", "bench/trace.py", "bench/roofline.py",
            "bench/autotune.py", "parallel/mesh.py", "parallel/train.py", "parallel/fit.py",
            "parallel/pipeline.py", "entry.py", "examples/distributed_training.py",
            "examples/wide_rank_accuracy.py", "examples/conv_compression.py",
            "examples/realtime_stream.py"} <= seen


def test_entry_points_default_to_the_card():
    """Asked for nothing, the model goes to the card; with no card that
    raises (as torch does), it does not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tree = P.to_numpy_tree(P.load_params(SEQUENTIAL, device="cpu"))
    for make in (lambda: P.load_params(SEQUENTIAL), lambda: P.from_numpy_tree(tree),
                 lambda: P.init_stacked_lstm(torch.Generator().manual_seed(0)),
                 lambda: P.init_conv_lstm(torch.Generator().manual_seed(0))):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            make()


def test_devtime_needs_a_card():
    from svd_lstm_tpu_torch.bench.devtime import device_time_ms

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_time_ms(lambda: None)
