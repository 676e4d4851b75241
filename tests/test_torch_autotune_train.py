"""The training half of the port's autotune (``bench/autotune.py``), the
``auto_flags`` of ``fit`` and ``tune --train``, on the CPU: the
counterparts of tests/test_autotune.py's training tests.

On the CPU every regime runs (the kernel regimes through the train
kernels' plain versions) and is timed by the host's clock; the cache key is
the JAX package's for the same model and window batch, but for its device
field.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
import svd_lstm_tpu_torch.bench.autotune as at
from conftest import REPO_DIR, subprocess_env
from svd_lstm_tpu.bench import autotune as jat
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.models.lstm import init_stacked_lstm

REGIMES = ("f32_scan", "tf32_scan", "bf16_scan", "fused_kernel", "fused_kernel_compact")


@pytest.fixture()
def model():
    return P.from_numpy_tree(init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(6, 5)),
                             device="cpu")


def _train_xy(B=8, T=4, d=4):
    rng = np.random.default_rng(2)
    return (torch.tensor(rng.normal(size=(B, T, d)), dtype=torch.float32),
            torch.tensor(rng.normal(size=(B,)), dtype=torch.float32))


@pytest.fixture()
def clean_cache(tmp_path, monkeypatch):
    cache = str(tmp_path / "autotune.json")
    monkeypatch.setattr(at, "_MEM_CACHE", {})
    monkeypatch.setattr(at, "_DISK_MEMO", {})
    monkeypatch.setattr(at, "default_cache_path", lambda: cache)
    return cache


def test_train_regimes_are_the_jax_packages():
    assert at._TRAIN_REGIMES == jat._TRAIN_REGIMES
    assert [r[0] for r in at._TRAIN_REGIMES] == list(REGIMES)


def test_autotune_train_dense_measures_all_regimes(model):
    """Every regime runs, the winner is a relaxed one, f32_scan is context
    only; this stack is K8's, so the compact regime is measured too."""
    x, y = _train_xy()
    r = at.autotune_train(model, x, y, repeats=1)
    assert set(r.table) == set(REGIMES) and not r.failed
    assert (r.matmul_precision, r.recurrence_kernel) in {
        ("tensorfloat32", False), ("bfloat16", False), ("bfloat16", True)}
    assert r.ms == min(v for k, v in r.table.items() if k != "f32_scan")
    if not r.recurrence_kernel:
        assert r.compact_gates is False
    assert at.autotune_train(model, x, y, repeats=1, include_exact=False).table.keys() == set(REGIMES[1:])


def test_autotune_train_leaves_the_model_unchanged(model):
    before = [p.detach().clone() for p in model.parameters()]
    x, y = _train_xy()
    at.autotune_train(model, x, y, repeats=1)
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_autotune_train_singular_uses_masked_step(model, monkeypatch):
    """The singular family measures the σ-masked Hoyer fine-tune step; its
    compact regime is not a program of its own (the view keeps "auto")."""
    sm = P.make_singular_model(model, merged_kernel=False)
    x, y = _train_xy()
    seen = []
    real = at._train_step

    def spy(m, apply_fn, loss_extra, make_opt, *a):
        opt = make_opt(m)
        seen.append((loss_extra is not None, type(opt).__name__, len(opt.param_groups[0]["params"])))
        return real(m, apply_fn, loss_extra, make_opt, *a)

    monkeypatch.setattr(at, "_train_step", spy)
    r = at.autotune_train(sm, x, y, repeats=1)
    assert "bf16_scan" in r.table and "fused_kernel" in r.table and r.ms > 0
    assert "fused_kernel_compact" in r.failed
    n_sigma = 2 * len(sm.layers) + 2  # ws, us a layer, the head's w and b
    assert seen and all(s == (True, "Adam", n_sigma) for s in seen)


def test_autotune_train_reduced_runs_the_view(model):
    red = P.make_reduced_model(P.make_singular_model(model, merged_kernel=True), rank=3)
    x, y = _train_xy()
    r = at.autotune_train(red, x, y, repeats=1)
    assert {"tf32_scan", "bf16_scan", "fused_kernel"} <= set(r.table)


def test_autotune_train_conv_hybrid_is_not_ported():
    """Once the conv hybrids' refusal; they are ported now: the dense
    hybrid's regimes run its front end and then its stack's kernels (the
    compact regime is the dense family's alone, as in the JAX package)."""
    hybrid = P.init_conv_lstm(torch.Generator().manual_seed(0), in_channels=4, filters=3,
                              kernel_size=2, units=(5,), device="cpu")
    x, y = _train_xy()
    r = at.autotune_train(hybrid, x, y, repeats=1)
    assert {"tf32_scan", "bf16_scan", "fused_kernel"} <= set(r.table)
    assert r.failed == {"fused_kernel_compact": "compact layout ineligible for this model"}


def test_train_cache_key_is_the_jax_packages_but_the_device():
    params = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(6, 5))
    cases = [params, make_singular_model(params, merged_kernel=False),
             make_reduced_model(make_singular_model(params, merged_kernel=False), rank=3)]
    for jparams in cases:
        m = P.from_numpy_tree(jparams, device="cpu")
        x = np.zeros((8, 4, 4), np.float32)
        got, want = json.loads(at.train_cache_key(m, torch.tensor(x))), json.loads(jat.train_cache_key(jparams, x))
        assert got.pop("device") == "cpu"
        want.pop("device")
        assert got == json.loads(json.dumps(want))
        assert at.train_cache_key(m, (8, 4, 4)) == at.train_cache_key(m, torch.tensor(x))


def test_tuned_train_flags_cache_roundtrip(model, tmp_path, monkeypatch):
    x, y = _train_xy()
    cache = str(tmp_path / "autotune.json")
    monkeypatch.setattr(at, "_MEM_CACHE", {})
    flags = at.tuned_train_flags(model, x, y, cache_path=cache)
    prec, kernel, compact = flags
    assert prec in ("tensorfloat32", "bfloat16") and isinstance(kernel, bool) and isinstance(compact, bool)
    with open(cache) as f:
        assert len(json.load(f)) == 1

    def boom(*a, **k):
        raise AssertionError("re-measured despite the cache")

    monkeypatch.setattr(at, "autotune_train", boom)
    assert at.tuned_train_flags(model, x, y, cache_path=cache) == flags
    monkeypatch.setattr(at, "_MEM_CACHE", {})
    assert at.tuned_train_flags(model, x, y, cache_path=cache) == flags


def test_cached_train_flags_readonly(model, clean_cache, monkeypatch):
    x, _ = _train_xy()
    monkeypatch.setattr(at, "autotune_train", lambda *a, **k: pytest.fail("measured"))
    assert at.cached_train_flags(model, x) is None
    # an entry of two fields (the JAX package's older form): compact False
    at.store_tuned(at.train_cache_key(model, x), "bfloat16|1")
    monkeypatch.setattr(at, "_MEM_CACHE", {})  # through the file
    assert at.cached_train_flags(model, x) == ("bfloat16", True, False)
    at.store_tuned(at.train_cache_key(model, x), "bfloat16|1|1")
    assert at.cached_train_flags(model, x) == ("bfloat16", True, True)
    with open(clean_cache) as f:
        assert list(json.load(f).values()) == ["bfloat16|1|1"]


# ---------------------------------------------------------------------------
# fit's auto_flags
# ---------------------------------------------------------------------------

def _tiny_train_setup():
    m = P.from_numpy_tree(init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(6, 5)), device="cpu")
    X = np.random.default_rng(0).normal(size=(1, 64, 4)).astype(np.float32)
    y = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    cfg = P.TrainConfig(num_windows=8, window_len=16, batch_size=4, epochs=1, auto_flags=True)
    return m, X, y, cfg


def _spy_resolved_cfg(monkeypatch):
    import svd_lstm_tpu_torch.train.loop as loop

    seen = []
    orig = loop.resolve_train_apply_fn

    def spy(cfg, apply_fn):
        seen.append(cfg)
        return orig(cfg, apply_fn)

    monkeypatch.setattr(loop, "resolve_train_apply_fn", spy)
    return seen


def test_fit_consults_cached_train_flags(clean_cache, monkeypatch):
    """A stored entry for the window batch (batch_size, window_len, d)
    redirects fit's regime; the run then launches the bf16 kernels' path."""
    m, X, y, cfg = _tiny_train_setup()
    at.store_tuned(at.train_cache_key(m, (cfg.batch_size, cfg.window_len, 4)),
                   at.encode_train_flags("bfloat16", True, False))
    seen = _spy_resolved_cfg(monkeypatch)
    res = P.fit(m, X, y, cfg)
    assert len(res.history) == 1
    got = seen[-1]
    assert (got.matmul_precision, got.recurrence_kernel, got.compact_gates) == ("bfloat16", True, False)
    flagged = P.fit(m, X, y, P.TrainConfig(num_windows=8, window_len=16, batch_size=4, epochs=1,
                                           matmul_precision="bfloat16", recurrence_kernel=True,
                                           compact_gates=False))
    assert res.history == flagged.history


def test_fit_auto_flags_miss_keeps_config(clean_cache, monkeypatch):
    m, X, y, cfg = _tiny_train_setup()
    monkeypatch.setattr(at, "autotune_train", lambda *a, **k: pytest.fail("auto_flags measured on a miss"))
    seen = _spy_resolved_cfg(monkeypatch)
    P.fit(m, X, y, cfg)
    got = seen[-1]
    assert (got.matmul_precision, got.recurrence_kernel, got.compact_gates) == ("float32", False, "auto")


def test_fit_auto_flags_keys_on_the_windows(clean_cache, monkeypatch):
    """With windows given, the key's T is the windows' length."""
    m, X, y, cfg = _tiny_train_setup()
    windows = (X[0, :40].reshape(5, 8, 4), y[:5])
    at.store_tuned(at.train_cache_key(m, (cfg.batch_size, 8, 4)),
                   at.encode_train_flags("tensorfloat32", False, False))
    seen = _spy_resolved_cfg(monkeypatch)
    P.fit(m, X, y, cfg, windows=windows)
    assert seen[-1].matmul_precision == "tensorfloat32"


def test_finetune_consults_cached_train_flags(clean_cache, monkeypatch):
    """The σ fine-tune goes through the same lookup (finetune -> fit)."""
    m, X, y, cfg = _tiny_train_setup()
    sm = P.make_singular_model(m, merged_kernel=False)
    at.store_tuned(at.train_cache_key(sm, (cfg.batch_size, cfg.window_len, 4)),
                   at.encode_train_flags("tensorfloat32", True, False))
    seen = _spy_resolved_cfg(monkeypatch)
    P.finetune(sm, X, y, P.FactorConfig(), cfg)
    assert (seen[-1].matmul_precision, seen[-1].recurrence_kernel) == ("tensorfloat32", True)


def test_recovery_consults_cached_train_flags(clean_cache, monkeypatch):
    """recover_reduced_gated (and so truncate_recover_progressive) trains
    each epoch through fit, which looks the flags up for the reduced model."""
    m, X, y, cfg = _tiny_train_setup()
    red = P.make_reduced_model(P.make_singular_model(m, merged_kernel=False), rank=3)
    at.store_tuned(at.train_cache_key(red, (cfg.batch_size, cfg.window_len, 4)),
                   at.encode_train_flags("bfloat16", True, False))
    seen = _spy_resolved_cfg(monkeypatch)
    _, info = P.recover_reduced_gated(red, X, y, train_cfg=cfg, max_epochs=2)
    assert seen and all((c.matmul_precision, c.recurrence_kernel) == ("bfloat16", True) for c in seen)
    assert info["best_val_mse"] <= info["raw_val_mse"]


# ---------------------------------------------------------------------------
# tune --train
# ---------------------------------------------------------------------------

def test_tune_train_command_writes_the_flags(tmp_path):
    """``tune --train --device cpu`` in a subprocess, its cache under
    tmp_path; the stored flags then redirect this process's fit."""
    xdg = str(tmp_path / "xdg")
    out = subprocess.run([sys.executable, "-m", "svd_lstm_tpu_torch", "tune", "--train", "--batch", "4",
                          "--steps", "6", "--repeats", "1", "--device", "cpu"],
                         env=subprocess_env(XDG_CACHE_HOME=xdg), cwd=REPO_DIR, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "device: cpu" in out.stdout and "<- winner" in out.stdout and "cached ->" in out.stdout
    assert all(name in out.stdout for name in REGIMES)
    with open(os.path.join(xdg, "svd_lstm_tpu_torch", "autotune.json")) as f:
        data = json.load(f)
    (key, val), = data.items()
    m = P.init_stacked_lstm(torch.Generator().manual_seed(0), device="cpu")  # the command's model
    assert key == at.train_cache_key(m, (4, 6, 16))
    prec, kernel, compact = at._decode_train_flags(val)
    assert f"matmul_precision={prec!r}, recurrence_kernel={kernel}, compact_gates={compact}" in out.stdout


@pytest.mark.parametrize("error,skipped", [(ValueError, True), (RuntimeError, False)],
                         ids=["refusal", "launch-failure"])
def test_autotune_train_skips_only_a_refusal(model, monkeypatch, error, skipped):
    """A kernel regime whose wrapper refuses its inputs (ValueError, the
    wrappers' shape and limit checks) goes into ``failed`` and a scan may
    win; a kernel that fails to build or launch raises out of
    ``autotune_train`` instead of leaving the scan to win."""
    from svd_lstm_tpu_torch.ops import cuda_train as ct

    def broken(*a, **k):
        raise error("fused narrow train: kernel said no")

    monkeypatch.setattr(ct, "fused_narrow_train_fwd", broken)
    monkeypatch.setattr(ct, "fused_narrow_train_compact_fwd", broken)
    x, y = _train_xy()
    if skipped:
        r = at.autotune_train(model, x, y, repeats=1)
        assert set(r.failed) == {"fused_kernel", "fused_kernel_compact"}
        assert all("kernel said no" in v for v in r.failed.values())
        assert not r.recurrence_kernel and set(r.table) == set(REGIMES[:3])
    else:
        with pytest.raises(RuntimeError, match="kernel said no"):
            at.autotune_train(model, x, y, repeats=1)
