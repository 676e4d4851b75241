"""The port's workflow commands (``svd_lstm_tpu_torch/examples``, ``python -m
svd_lstm_tpu_torch <command>``) and ``viz/plots.py`` on the CPU, at tiny
sizes, against the JAX package: the plots' figure data, the timing curve's
outputs, the merge, the batched exact error and the native runtime; the
CLI's command list, and the default output paths outside the committed
``model_saves/`` and ``plots/``. ``compress``, ``train`` and ``sweep`` are
in tests/test_torch_examples_compress.py, ``rank-rmse`` and ``freq`` in
tests/test_torch_examples_rank.py (the files share the dataset fixture and
the tolerances below).

Tolerances: the fine-tune parity of tests/test_torch_train.py (loss
histories rtol 1e-5) for the RMSEs that follow a fine-tune; 1e-5 for a
forward on the same weights; 1e-4 for the native runtime
(tests/test_native.py) and for losses after Adam steps
(tests/test_torch_train.py's 1e-4 on parameters after training)."""

import inspect
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import svd_lstm_tpu_torch as P
from conftest import REPO_DIR, subprocess_env
from svd_lstm_tpu.io import checkpoint as jckpt
from svd_lstm_tpu.viz import plots as jplots
from svd_lstm_tpu_torch import __main__ as cli
from svd_lstm_tpu_torch import examples as ex
from svd_lstm_tpu_torch.examples import (
    batched_inference,
    bench_native,
    frequency_prediction,
    rank_rmse_published,
    rank_sweep,
    sequentialize_train,
    svd_acceleration,
    timing_curves,
    train_full_model,
)
from svd_lstm_tpu_torch.viz import plots

RMSE_RTOL = 1e-5    # after a fine-tune: tests/test_torch_train.py's loss-history rtol
FWD_TOL = 1e-5      # a forward on the same weights
LOSS_TOL = 1e-4
NATIVE_TOL = 1e-4
SEQUENTIAL = os.path.join(REPO_DIR, "model_saves", "pretrained_sequential.npz")
DENSE_30 = os.path.join(REPO_DIR, "model_saves", "pretrained_30units_v4_n1.5.npz")
needs_cxx = pytest.mark.skipif(shutil.which(os.environ.get("CXX", "g++")) is None,
                               reason="no C++ compiler")


@pytest.fixture(scope="module")
def ds():
    """The surrogate run from 1.2 s to 3 s, split at 2.2 s (2000 training
    steps, 1600 test): the pin holds still before 2.5 s and steps there."""
    from svd_lstm_tpu_torch.data import Dataset

    full = ex.quick_dataset(duration=4.5, split_time=2.2)
    keep, tr, te = full.t >= 1.2, full.t_train >= 1.2, full.t_test >= 1.2
    return Dataset(X=full.X[:, keep], y=full.y[keep], t=full.t[keep], X_train=full.X_train[:, tr],
                   y_train=full.y_train[tr], t_train=full.t_train[tr], X_test=full.X_test[:, te],
                   y_test=full.y_test[te], t_test=full.t_test[te], pin_scaler=full.pin_scaler,
                   acc_scaler=full.acc_scaler)


def _jax_params(model, tmp_path, name="m.npz"):
    """A port model carried over to the JAX package through the .npz format."""
    path = str(tmp_path / name)
    P.save_params(path, model)
    return jckpt.load_params(path)


# ---------------------------------------------------------------------------
# viz/plots.py
# ---------------------------------------------------------------------------

def _figure_data(fig):
    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "ylim": ax.get_ylim(), "lines": [l.get_xydata() for l in ax.get_lines()],
            "labels": [l.get_label() for l in ax.get_lines()],
            "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
            "texts": [t.get_text() for t in ax.texts],
        })
    return out


def _same_figure(got, want):
    a, b = _figure_data(got), _figure_data(want)
    assert len(a) == len(b) == 1
    for ka, kb in zip(a, b):
        for key in ("title", "xlabel", "ylabel", "labels", "legend", "texts"):
            assert ka[key] == kb[key], key
        np.testing.assert_allclose(ka["ylim"], kb["ylim"])
        assert len(ka["lines"]) == len(kb["lines"])
        for la, lb in zip(ka["lines"], kb["lines"]):
            np.testing.assert_array_equal(la, lb)


_RNG = np.random.default_rng(0)
_X = np.arange(12, dtype=np.float64)
_Y = 1 + _RNG.random(12)
_T = np.linspace(0, 1, 50)
_TRUE = np.sin(_T * 6)
_PREDS = {"reduced model": _TRUE + 0.1 * _RNG.random(50), "full model": _TRUE + 0.05}
FIGURES = {
    "rmse": lambda m, p: m.plot_rmse_curve(_X, _Y, xlabel="weights eliminated", savepath=p),
    "rmse_ylim": lambda m, p: m.plot_rmse_curve(_X, _Y, savepath=p, ylim=(0.8, 2.0), unit_line=False),
    "timing": lambda m, p: m.plot_timing_curve(_X, _Y, xlabel="kept rank r (n=512)", savepath=p),
    "overlay": lambda m, p: m.plot_prediction_overlay(_T, _TRUE, _PREDS, savepath=p, annotate="k = 3"),
}


@pytest.mark.parametrize("kind", list(FIGURES))
def test_plots_match_jax(kind, tmp_path):
    got = FIGURES[kind](plots, str(tmp_path / "port" / f"{kind}.png"))
    want = FIGURES[kind](jplots, str(tmp_path / "jax" / f"{kind}.png"))
    _same_figure(got, want)
    assert (tmp_path / "port" / f"{kind}.png").stat().st_size > 0
    plots.pyplot().close("all")


def test_plots_take_tensors():
    got = plots.plot_timing_curve(torch.tensor(_X), torch.tensor(_Y))
    _same_figure(got, jplots.plot_timing_curve(_X, _Y))
    plots.pyplot().close("all")


def test_prediction_gif_matches_jax(tmp_path):
    imageio = pytest.importorskip("imageio.v2")
    preds = [_TRUE + 0.1 * i for i in range(3)]
    labels = ["eliminated = 0", "eliminated = 8"]
    got = plots.save_prediction_gif(_T, _TRUE, preds, str(tmp_path / "p.gif"), labels=labels, dpi=40)
    jplots.save_prediction_gif(_T, _TRUE, preds, str(tmp_path / "j.gif"), labels=labels, dpi=40)
    a, b = imageio.mimread(got), imageio.mimread(str(tmp_path / "j.gif"))
    assert len(a) == len(b) == 3
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa, fb)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

TIMING = {  # wide, fast, units, cuts
    "narrow": (False, False, (6, 5), [1, 3]),
    "wide": (True, False, (12, 12), [8, 3]),
    "wide_fast": (True, True, (12, 12), [8, 3]),
}


@pytest.mark.parametrize("case", list(TIMING))
def test_timing_prints_a_ratio_per_rank_and_reduced_outputs_are_exact(case, tmp_path, capsys):
    wide, fast, units, cuts = TIMING[case]
    T = 20
    curve = timing_curves.run(wide=wide, fast=fast, T=T, cuts=cuts, units=units,
                              plots=str(tmp_path), device="cpu", repeats=1)
    out = capsys.readouterr().out
    assert out.count("ratio ") == len(cuts) == len(curve.ratios)
    assert list(tmp_path.iterdir())  # the figure
    dense, x, reduced = timing_curves.models(units, wide, curve.ranks, T, torch.device("cpu"))
    for r, y in zip(curve.ranks, curve.outputs):
        with P.exact_matmul(), torch.no_grad():
            want = P.stacked_lstm_apply(P.reconstruct_dense_model(reduced[r]), x[None])[0]
        assert tuple(y.shape) == (T, 1)
        if fast:  # bf16 operands: near the exact output, not on it
            assert 0 < float((y - want).abs().max()) < 2e-2
        else:
            torch.testing.assert_close(y, want, atol=FWD_TOL, rtol=0)


def test_timing_narrow_refuses_fast():
    with pytest.raises(ValueError, match="--wide"):
        timing_curves.run(fast=True, T=4, cuts=[1], units=(4,), plots="", device="cpu")


# ---------------------------------------------------------------------------
# rank-rmse, batched, freq, seq-train, native-bench
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_batched(precision, capsys):
    res = batched_inference.run((8, 6), batch=3, steps=10, precision=precision, rank=4, device="cpu",
                                repeats=1)
    assert tuple(res["out"].shape) == (3, 10, 1) and bool(torch.isfinite(res["out"]).all())
    assert "devices: 1 x cpu" in capsys.readouterr().out
    if precision == "exact":
        assert res["err"] <= FWD_TOL
    assert res["reduced_err"] > 0


def test_seq_train_merge_matches_jax(tmp_path):
    from svd_lstm_tpu.models.merge import merge_parallel_cell_weights as jax_merge

    got = sequentialize_train.run(epochs=1, out=str(tmp_path), n_series=256, n_steps=12, device="cpu")
    freq, ampl = (_jax_params(m, tmp_path, f"{i}.npz") for i, m in enumerate(got["toys"]))
    want = [jax_merge(freq.layers[0], ampl.layers[0], same_x=True),
            jax_merge(freq.layers[1], ampl.layers[1], same_x=False)]
    for layer, w in zip(got["merged"].layers, want):
        for name in ("W", "U", "b"):
            np.testing.assert_array_equal(getattr(layer, name).detach().numpy(), np.asarray(getattr(w, name)))
    assert got["merged"].layers[1].units == 30
    assert os.path.exists(got["checkpoint"]) and np.isfinite(got["losses"]).all()


@needs_cxx
def test_native_bench_matches_predict():
    res = bench_native.run(T=260, repeats=1, units=(6, 5), ranks=(3,), merged_ranks=(8,),
                           published_units=(6, 6, 6, 6), published_rank=3, device="cpu")
    assert len(res["errors"]) == 1 + 2 + 2 + 3
    assert res["max_err"] <= NATIVE_TOL
    assert all(v > 0 for v in res["us_per_step"].values())


# ---------------------------------------------------------------------------
# the CLI and the default paths
# ---------------------------------------------------------------------------

def test_cli_lists_every_command_and_runs_one():
    out = subprocess.run([sys.executable, "-m", "svd_lstm_tpu_torch"], env=subprocess_env(),
                         cwd=REPO_DIR, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    listed = out.stdout.strip().splitlines()[-1]
    for cmd in ("export", "stream", "trace", "tune", "train", "compress", "sweep", "rank-rmse",
                "timing", "freq", "batched", "seq-train", "native-bench"):
        assert cmd in listed.split(": ", 1)[1].split(", ")
    out = subprocess.run([sys.executable, "-m", "svd_lstm_tpu_torch", "batched", "--quick", "--device",
                          "cpu"], env=subprocess_env(), cwd=REPO_DIR, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "shard-vs-local err" in out.stdout


@pytest.mark.parametrize("cmd,item", [("bench", "item 1")])
def test_unported_commands_exit_2(cmd, item, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["svd_lstm_tpu_torch", cmd])
    with pytest.raises(SystemExit) as e:
        cli.main()
    assert e.value.code == 2
    assert item in capsys.readouterr().out


def test_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        batched_inference.main(["--quick"])


_WRITE_ARGS = ("out", "plots", "plot", "save", "export")
COMMANDS = {  # module, argv for main (quick paths: no dataset file is read)
    "train": (train_full_model, ["--quick"]),
    "compress": (svd_acceleration, ["--quick"]),
    "sweep": (rank_sweep, ["--quick"]),
    "rank-rmse": (rank_rmse_published, ["--quick"]),
    "timing": (timing_curves, ["--quick"]),
    "freq": (frequency_prediction, []),
    "batched": (batched_inference, []),
    "seq-train": (sequentialize_train, []),
    "native-bench": (bench_native, []),
}


def _committed_dirs():
    return [os.path.realpath(os.path.join(REPO_DIR, d)) for d in ("model_saves", "plots")]


def _writes_outside_committed(value):
    if not isinstance(value, str) or not value:
        return True
    path = os.path.realpath(os.path.join(REPO_DIR, value))
    return not any(path == d or path.startswith(d + os.sep) for d in _committed_dirs())


@pytest.mark.parametrize("name", list(COMMANDS))
def test_default_outputs_stay_out_of_committed_dirs(name, monkeypatch):
    module, argv = COMMANDS[name]
    monkeypatch.chdir(REPO_DIR)
    seen = {}
    monkeypatch.setattr(module, "run", lambda *a, **kw: seen.update(kw) or {"ratio_median": [1.0] * 20,
                                                                          "flat_max_per_seed": [1.0]})
    module.main(argv)
    for key, value in seen.items():
        if key in _WRITE_ARGS:
            assert _writes_outside_committed(value), (name, key, value)
    defaults = inspect.signature(module.run).parameters
    for key in _WRITE_ARGS:
        if key in defaults:
            assert _writes_outside_committed(defaults[key].default), (name, key)
    assert seen.get("device", "cuda") == "cuda"


def test_imports_and_plotless_runs_need_neither_jax_nor_matplotlib():
    """As on the card's machine: no matplotlib, no imageio. The package and
    every command import; a run with --plots '' draws nothing and works; a
    figure raises ImportError."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = sys.modules['imageio'] = None\n"
        "import svd_lstm_tpu_torch, svd_lstm_tpu_torch.__main__\n"
        "from svd_lstm_tpu_torch.examples import (batched_inference, bench_native, frequency_prediction,\n"
        "    rank_rmse_published, rank_sweep, sequentialize_train, svd_acceleration, timing_curves,\n"
        "    train_full_model)\n"
        "from svd_lstm_tpu_torch.viz import plots\n"
        "timing_curves.run(T=4, cuts=[1], units=(4,), plots='', device='cpu', repeats=1)\n"
        "try:\n"
        "    plots.plot_timing_curve([0, 1], [1, 1])\n"
        "except ImportError:\n"
        "    print('figure refused')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'svd_lstm_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=subprocess_env(), cwd=REPO_DIR,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "no figure written" in out.stdout and "figure refused" in out.stdout


def test_torch_runs_is_ignored_by_git():
    with open(os.path.join(REPO_DIR, ".gitignore")) as f:
        assert "torch_runs/" in f.read().split()
