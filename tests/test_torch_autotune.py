"""``bench/autotune.py``, the inference half, and ``predict``'s cache
lookup on the CPU, ported from tests/test_autotune.py: the candidates
follow ``valid_impls``, a candidate that raises is isolated, the key's
fields other than ``device`` equal the JAX package's key, the disk and
memory layers, a cached winner redirects ``predict(impl="auto")``, a stale
one is ignored, and with no cache file ``predict`` routes exactly as it
did without the lookup. The ``tune`` command runs in a subprocess with its
cache under ``tmp_path``."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
import svd_lstm_tpu_torch.bench.autotune as at
from conftest import REPO_DIR, subprocess_env
from svd_lstm_tpu.bench import autotune as jat
from svd_lstm_tpu.factor.svd import make_reduced_model, make_singular_model
from svd_lstm_tpu.models.lstm import init_stacked_lstm
from svd_lstm_tpu.utils.precision import cast_params as jcast
from svd_lstm_tpu_torch import __main__ as cli
from svd_lstm_tpu_torch.ops import cuda_batched, cuda_lstm, layouts


@pytest.fixture(autouse=True)
def clean_cache(tmp_path, monkeypatch):
    """Every test starts from empty memory layers and a cache file under
    tmp_path (absent until written)."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    for name in ("_MEM_CACHE", "_DISK_MEMO", "_PATHS"):
        monkeypatch.setattr(at, name, {})
    return at.default_cache_path()


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture()
def model_x():
    jp = init_stacked_lstm(jax.random.PRNGKey(0), input_dim=4, units=(6, 5))
    x = _x((12, 4))
    return jp, P.from_numpy_tree(jp, device="cpu"), x, torch.tensor(x)


def test_cache_path_follows_xdg(clean_cache, tmp_path):
    assert clean_cache == str(tmp_path / "xdg" / "svd_lstm_tpu_torch" / "autotune.json")


def test_candidates_follow_api_rules(model_x):
    _, m, _, x = model_x
    assert at.candidates(m, x) == ["scan", "fused", "hybrid"]
    wide = P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=4, units=(256,), device="cpu")
    assert at.candidates(wide, x) == ["scan", "hybrid"]  # fused is n <= 128 only
    xb = x[None]
    # batched exact and high: 'auto' is the scan; fast diverges only on the card (K5)
    assert at.candidates(m, xb) == at.candidates(m, xb, "high") == at.candidates(m, xb, "fast") == ["scan"]


def test_autotune_times_every_candidate_and_isolates_a_failure(model_x, monkeypatch):
    _, m, _, x = model_x
    r = at.autotune(m, x, repeats=1)
    assert set(r.table) == {"scan", "fused", "hybrid"} and r.failed == {}
    assert r.table[r.impl] == min(r.table.values()) == r.ms > 0

    def refusing(*a, **k):
        raise ValueError("kernel refused")

    monkeypatch.setattr(cuda_lstm, "fused_dense_stack", refusing)
    r = at.autotune(m, x, repeats=1)
    assert set(r.failed) == {"fused"} and "kernel refused" in r.failed["fused"]
    assert set(r.table) == {"scan", "hybrid"}
    with pytest.raises(RuntimeError, match="every candidate failed"):
        at.autotune(m, x, impls=["fused"], repeats=1)

    def broken(*a, **k):
        raise RuntimeError("fused_dense_stack: kernel launch failed")

    # a kernel that fails to launch is an error, not a skipped candidate
    monkeypatch.setattr(cuda_lstm, "fused_dense_stack", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        at.autotune(m, x, repeats=1)


def _without_device(key: str) -> dict:
    d = json.loads(key)
    d.pop("device")
    return d


def _families(jp):
    sing = make_singular_model(jp, merged_kernel=False)
    return {"dense": jp, "singular": sing, "split": make_reduced_model(sing, rank=3),
            "merged": make_reduced_model(make_singular_model(jp, merged_kernel=True), rank=4)}


@pytest.mark.parametrize("family", ["dense", "singular", "split", "merged"])
@pytest.mark.parametrize("batched,precision", [(False, "exact"), (False, "fast"), (True, "high")])
def test_key_equals_jax_but_device(model_x, family, batched, precision):
    jp, _, x, _ = model_x
    jm = _families(jp)[family]
    xx = x[None] if batched else x
    got = at.cache_key(P.from_numpy_tree(jm, device="cpu"), torch.tensor(xx), precision)
    want = jat.cache_key(jm, jnp.asarray(xx), precision)
    assert _without_device(got) == _without_device(want)
    assert json.loads(got)["device"] == "cpu"


def test_key_of_a_bf16_model_equals_jax(model_x):
    jp, _, x, _ = model_x
    m = P.from_numpy_tree(jp, device="cpu").to(torch.bfloat16)
    got = at.cache_key(m, torch.tensor(x).bfloat16(), "exact")
    want = jat.cache_key(jcast(jp, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), "exact")
    assert _without_device(got) == _without_device(want)


def test_cache_key_distinguishes(model_x):
    _, m, _, x = model_x
    other = P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=4, units=(6, 6), device="cpu")
    k1 = at.cache_key(m, x, "exact")
    assert k1 == at.cache_key(m, x, "exact")
    assert k1 != at.cache_key(other, x, "exact")
    assert k1 != at.cache_key(m, x[:6], "exact")
    assert k1 != at.cache_key(m, x, "fast")
    assert k1 != at.cache_key(m, x.bfloat16(), "exact")
    bf = P.from_numpy_tree(P.to_numpy_tree(m), device="cpu").to(torch.bfloat16)
    assert k1 != at.cache_key(bf, x, "exact")


def test_cache_key_distinguishes_rank_permutations():
    """Split reduced models whose per-gate ranks permute each other have
    the same weight count but other kernel shapes: two entries."""
    d, n = 4, 8

    def mk(ranks):
        z = torch.zeros
        layer = P.ReducedLayer([z(d, r) for r in ranks], [z(r, n - r) for r in ranks],
                               [z(n, r) for r in ranks], [z(r, n - r) for r in ranks], z(4 * n))
        return P.ReducedLSTM([layer], P.DenseHead(z(n, 1), z(1)))

    ra, rb = mk((2, 6, 4, 4)), mk((4, 4, 6, 2))
    assert ra.layers[0].weight_count() == rb.layers[0].weight_count()
    x = torch.tensor(_x((12, d)))
    assert at.cache_key(ra, x, "exact") != at.cache_key(rb, x, "exact")


def test_tuned_impl_caches_to_disk_and_memory(model_x, clean_cache, monkeypatch):
    _, m, _, x = model_x
    impl = at.tuned_impl(m, x)
    assert impl in ("scan", "fused", "hybrid")
    with open(clean_cache) as f:
        assert list(json.load(f).values()) == [impl]

    def boom(*a, **k):
        raise AssertionError("re-measured despite the cache")

    monkeypatch.setattr(at, "autotune", boom)
    assert at.tuned_impl(m, x) == impl
    monkeypatch.setattr(at, "_MEM_CACHE", {})  # a disk-only hit also avoids measuring
    assert at.tuned_impl(m, x) == impl


def test_predict_tuned_matches_predict(model_x):
    _, m, _, x = model_x
    y = at.predict_tuned(m, x)
    np.testing.assert_allclose(y.numpy(), P.predict(m, x, impl="scan").numpy(), rtol=1e-6, atol=1e-6)


def test_cached_impl_redirects_predict_auto(model_x, monkeypatch):
    """A stored winner redirects predict(impl='auto') (on the CPU the table
    runs the scan for this narrow batch-1 model); consult_cache=False skips
    the lookup."""
    _, m, _, x = model_x
    at.store_tuned(at.cache_key(m, x, "exact"), "hybrid")
    hits = []
    orig = cuda_lstm.dense_forward_hybrid
    monkeypatch.setattr(cuda_lstm, "dense_forward_hybrid", lambda *a, **k: hits.append(1) or orig(*a, **k))
    y = P.predict(m, x)
    assert hits == [1]
    np.testing.assert_allclose(y.numpy(), P.predict(m, x, impl="scan").numpy(), atol=1e-5)
    P.predict(m, x, consult_cache=False)
    assert hits == [1]


def test_cached_impl_reads_disk_never_measures(model_x, monkeypatch):
    _, m, _, x = model_x
    at.store_tuned(at.cache_key(m, x, "exact"), "fused")
    monkeypatch.setattr(at, "_MEM_CACHE", {})
    monkeypatch.setattr(at, "_DISK_MEMO", {})

    def boom(*a, **k):
        raise AssertionError("cached_impl measured")

    monkeypatch.setattr(at, "autotune", boom)
    assert at.cached_impl(m, x, "exact") == "fused"
    assert at.cached_impl(m, x[:6], "exact") is None  # never tuned: None, no measurement


def test_stale_cache_entry_ignored():
    """A winner no longer valid for the input ('fused' for a 256-unit model,
    past its n <= 128 rule) is ignored, not raised."""
    wide = P.init_stacked_lstm(torch.Generator().manual_seed(0), input_dim=4, units=(256,), device="cpu")
    x = torch.tensor(_x((12, 4)))
    at.store_tuned(at.cache_key(wide, x, "exact"), "fused")
    np.testing.assert_array_equal(P.predict(wide, x).numpy(), P.predict(wide, x, impl="scan").numpy())


def test_store_tuned_populates_memo(model_x, clean_cache):
    _, m, _, x = model_x
    key = at.cache_key(m, x, "exact")
    at.store_tuned(key, "scan")
    assert at._MEM_CACHE[key] == "scan"
    with open(clean_cache) as f:
        assert json.load(f)[key] == "scan"


def test_repeated_lookup_skips_the_key(model_x, monkeypatch):
    """A repeated lookup does not rebuild the JSON key; a store, a replaced
    parameter of another shape, a dtype conversion or another process's
    write to the file makes it look again, and sees the change."""
    _, m, _, x = model_x
    built = []
    key_of = at.cache_key
    monkeypatch.setattr(at, "cache_key", lambda *a: built.append(1) or key_of(*a))
    assert at.cached_impl(m, x) is None and at.cached_impl(m, x) is None
    assert len(built) == 1
    at.store_tuned(key_of(m, x, "exact"), "hybrid")
    assert at.cached_impl(m, x) == "hybrid" and len(built) == 2
    m.layers[1].U = torch.nn.Parameter(torch.zeros(5, 24))  # another model shape, same object
    m.layers[1].W = torch.nn.Parameter(torch.zeros(6, 24))
    m.layers[1].b = torch.nn.Parameter(torch.zeros(24))
    m.head.w = torch.nn.Parameter(torch.zeros(6, 1))
    assert at.cached_impl(m, x) is None
    m.to(torch.float64)
    assert at.cached_impl(m, x) is None and len(built) == 4
    m.to(torch.float32)
    path = at.default_cache_path()
    with open(path) as f:
        data = json.load(f)
    data[key_of(m, x, "exact")] = "fused"  # as another process's tune would
    with open(path, "w") as f:
        json.dump(data, f)
    os.utime(path, (0, 1))  # an mtime the memo has not seen
    monkeypatch.setattr(at, "DISK_RECHECK_S", 0.0)
    assert at.cached_impl(m, x) == "fused"


def _routes(monkeypatch):
    """Record which route each predict takes: the wrappers predict calls."""
    seen = []
    for mod, names in ((cuda_lstm, ("fused_dense_stack", "dense_forward_hybrid", "reduced_forward_hybrid")),
                       (layouts, ("singular_forward_fused", "reduced_forward_fused",
                                  "reduced_forward_dense_recurrent")),
                       (cuda_batched, ("batched_forward_fast",))):
        for name in names:
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: seen.append(_n) or _f(*a, **k))
    return seen


@pytest.mark.parametrize("units", [(6, 5), (136,), (256,)])
def test_no_cache_file_routes_as_without_the_lookup(units, clean_cache, monkeypatch):
    """Every family (dense, singular, reduced merged and split), width
    (narrow, 128 < n < 256, wide), precision and input rank: with no cache
    file, predict(impl='auto') takes the route and gives the output of the
    lookup-free call, bit for bit, and writes no file."""
    seen = _routes(monkeypatch)
    jp = init_stacked_lstm(jax.random.PRNGKey(1), input_dim=4, units=units)
    for jm in _families(jp).values():
        m = P.from_numpy_tree(jm, device="cpu")
        for x in (torch.tensor(_x((6, 4))), torch.tensor(_x((2, 5, 4)))):
            for precision in ("exact", "high", "fast"):
                seen.clear()
                got = P.predict(m, x, precision=precision)
                route = list(seen)
                seen.clear()
                want = P.predict(m, x, precision=precision, consult_cache=False)
                assert route == seen and torch.equal(got, want), (type(m).__name__, x.shape, precision)
    assert not os.path.exists(clean_cache)


def test_tune_command_writes_its_cache(tmp_path):
    """``tune --device cpu`` in a subprocess, its cache under tmp_path; the
    stored winner then redirects this process's predict of the same shape."""
    xdg = str(tmp_path / "xdg")
    out = subprocess.run([sys.executable, "-m", "svd_lstm_tpu_torch", "tune", "--steps", "16", "--repeats",
                          "1", "--device", "cpu"], env=subprocess_env(XDG_CACHE_HOME=xdg), cwd=REPO_DIR,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "device: cpu" in out.stdout and "<- winner" in out.stdout and "cached ->" in out.stdout
    winner = next(line.split()[0] for line in out.stdout.splitlines() if "<- winner" in line)
    with open(os.path.join(xdg, "svd_lstm_tpu_torch", "autotune.json")) as f:
        data = json.load(f)
    assert list(data.values()) == [winner]
    m = P.init_stacked_lstm(torch.Generator().manual_seed(0), device="cpu")  # the command's model
    assert at.cached_impl(m, torch.zeros(16, 16)) == winner


def test_tune_train_is_not_ported():
    """Once the conv hybrids' refusal; they are ported now: a conv hybrid
    has the JAX package's keys ("conv+" its stack's family, the conv's
    shapes first) and is tuned and served like any model."""
    from svd_lstm_tpu.models.conv import init_conv_lstm

    jm = init_conv_lstm(jax.random.PRNGKey(0), in_channels=4, filters=3, kernel_size=2, units=(5,))
    m, x = P.from_numpy_tree(jm, device="cpu"), _x((12, 4))
    for got, want in ((at.cache_key(m, torch.tensor(x), "exact"), jat.cache_key(jm, jnp.asarray(x), "exact")),
                      (at.train_cache_key(m, (2, 3, 4)), jat.train_cache_key(jm, np.zeros((2, 3, 4))))):
        got, want = json.loads(got), json.loads(want)
        assert got.pop("device") == "cpu"
        want.pop("device")
        assert got == want and got["family"] == "conv+dense" and got["dims"][0][0] == "conv"
    impl = at.tuned_impl(m, torch.tensor(x))
    assert impl in ("scan", "fused", "hybrid") and at.cached_impl(m, torch.tensor(x)) == impl
