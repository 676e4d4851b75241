"""Whole runs of the harness on the CPU at a tiny size, past its look for a
card: a sound run is correct; with the timed path broken underneath (an
answer altered where it is produced, a step that returns its state
unchanged, half of each batch left out; the training faults also from a
call's second step on, inside the call), ``correct`` comes out false under
the cells' own limits. The command itself refuses a machine without a card
and a checkout without the program."""

import copy
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.core import cell as cells

CPU = torch.device("cpu")
TINY = {"name": "tiny", "input_dim": 16, "units": [8, 8], "head_dim": 1,
        "forms": {"dense": {"init": "seeded"}, "reduced": {"merged": False, "rank": 5}}}
SIGNAL = {"duration": 2.5, "noise": 1.5}
PREDICT = {"name": "tiny_b1", "kind": "predict_b1_closed", "form": "dense", "T": 64,
           "impl": "auto", "precision": "exact", "warmup_calls": 1, "sample_calls": 4,
           "signal": SIGNAL}
FIT = {"name": "tiny_fit", "kind": "fit_epochs", "batch_size": 16, "window_len": 20,
       "num_windows": 64, "learning_rate": 1e-3, "matmul_precision": "float32",
       "recurrence_kernel": True, "checked_steps": 3, "split_time": 0.8, "signal": SIGNAL}
SEED = 2 ** 31 + 7  # seeds past 32 signed bits must work


def tiny(like: str, traffic: dict) -> cells.Cell:
    """A tiny cell with the metrics and output limits of the cell ``like``."""
    return dataclasses.replace(cells.resolve(like), name=f"tiny.{traffic['name']}", config=TINY,
                               traffic=traffic)


def predict_cell():
    return tiny("dropbear_4x40.dense_b1", PREDICT)


def fit_cell():
    return tiny("wide_3x512.fit_f32_b128", FIT)


def test_sound_predict_run():
    cell = predict_cell()
    res = run.run_cell(cell, SEED, 0.3, False, CPU)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 1
    assert set(res["metrics"]) == {"frames_per_s", "seq_p95_ms", "setup_s"}
    assert list(res)[-1] == "checks" and set(res["checks"]) == set(cell.limits)
    assert res["device"]["platform"] == "cpu"
    json.dumps(res)


def test_sound_fit_run():
    res = run.run_cell(fit_cell(), SEED, 0.3, False, CPU)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}


def test_answer_altered_where_it_is_produced(monkeypatch):
    from svd_lstm_tpu_torch import api

    real = api.predict

    def altered(model, x, **kw):
        out = real(model, x, **kw).clone()
        out[out.shape[0] // 2] += 0.01 * out.abs().max()
        return out

    monkeypatch.setattr(api, "predict", altered)
    res = run.run_cell(predict_cell(), SEED, 0.3, False, CPU)
    assert not res["correct"]
    assert res["checks"]["out_err"]["value"] > res["checks"]["out_err"]["limit"]


def test_step_that_returns_its_state_unchanged(monkeypatch):
    from svd_lstm_tpu_torch.train import loop

    real = loop.fit

    def unchanged(model, *a, **kw):
        return dataclasses.replace(real(model, *a, **kw), params=copy.deepcopy(model))

    monkeypatch.setattr(loop, "fit", unchanged)
    res = run.run_cell(fit_cell(), SEED, 0.3, False, CPU)
    assert not res["correct"]
    # no leaf moved: each leaf's gap is its whole change over max(its own, the median leaf's)
    assert res["checks"]["change_median_gap"]["value"] > 0.5


def test_half_of_each_batch_left_out(monkeypatch):
    from svd_lstm_tpu_torch.train import loop

    real = loop.fit

    def half(model, X, y, cfg, windows=None, **kw):
        x, t = windows
        keep = torch.cat([torch.arange(i, i + cfg.batch_size // 2)
                          for i in range(0, x.shape[0], cfg.batch_size)])
        cfg = dataclasses.replace(cfg, batch_size=cfg.batch_size // 2)
        return real(model, X, y, cfg, windows=(x[keep], t[keep]), **kw)

    monkeypatch.setattr(loop, "fit", half)
    res = run.run_cell(fit_cell(), SEED, 0.3, False, CPU)
    assert not res["correct"]
    assert res["checks"]["loss1_gap"]["value"] > res["checks"]["loss1_gap"]["limit"]


def test_updates_skipped_after_a_calls_first_step(monkeypatch):
    # each fit call makes its own Adam: only its first step updates
    real = torch.optim.Adam.step

    def first_only(self, *a, **kw):
        self.bench_steps = getattr(self, "bench_steps", 0) + 1
        return real(self, *a, **kw) if self.bench_steps == 1 else None

    monkeypatch.setattr(torch.optim.Adam, "step", first_only)
    res = run.run_cell(fit_cell(), SEED, 0.3, False, CPU)
    assert not res["correct"]
    assert res["checks"]["change_median_gap"]["value"] > res["checks"]["change_median_gap"]["limit"]


def test_later_steps_of_a_call_on_half_their_batch(monkeypatch):
    from svd_lstm_tpu_torch.train import loop

    real_fit, real_loss = loop.fit, loop.mse_last_step
    steps = []

    def fit(*a, **kw):
        steps.clear()
        return real_fit(*a, **kw)

    def loss(model, x, y, apply_fn, rng=None):
        steps.append(len(x))
        if len(steps) > 1:
            x, y = x[:len(x) // 2], y[:len(y) // 2]
        return real_loss(model, x, y, apply_fn, rng)

    monkeypatch.setattr(loop, "fit", fit)
    monkeypatch.setattr(loop, "mse_last_step", loss)
    res = run.run_cell(fit_cell(), SEED, 0.3, False, CPU)
    assert not res["correct"]
    assert res["checks"]["change_median_gap"]["value"] > res["checks"]["change_median_gap"]["limit"]


TRACE_READ = {"kernels_roofline", "kernels.us_per_layer_step", "device.idle_pct"}


@pytest.mark.parametrize("lost_in", [[1], [1, 2, 3]])
def test_trace_that_lost_kernels_is_taken_again_or_left_out(monkeypatch, lost_in):
    # the CPU has no device events: the trace reader is given one window with
    # a kernel, and its count of kernels disagrees with the counters in the
    # attempts ``lost_in``
    from benchmark.core import devtrace

    attempts = []

    def parse(events):
        attempts.append(len(attempts) + 1)
        return devtrace.Trace(window=(0.0, 1e6), device=[(0.0, 5e5, "k")], host=[])

    monkeypatch.setattr(run.devtrace, "parse", parse)
    monkeypatch.setattr(run.devtrace, "launch_mismatch",
                        lambda tr, launched, kernels: {"k": (2, 1)} if attempts[-1] in lost_in else {})
    res = run.run_cell(predict_cell(), SEED, 0.2, True, CPU)
    assert res["correct"]
    if len(lost_in) < run.TRACE_ATTEMPTS:
        assert len(attempts) == 2
        assert TRACE_READ <= set(res["metrics"]) and res["device"]["busy_s"] == pytest.approx(0.5)
        assert "breakdown" in res
    else:
        assert len(attempts) == run.TRACE_ATTEMPTS
        assert not TRACE_READ & set(res["metrics"]) and "entry.host_ms" in res["metrics"]
        assert "busy_s" not in res["device"] and "breakdown" not in res


@pytest.mark.parametrize("make", [predict_cell, fit_cell])
def test_control_reads_above_the_program(make):
    # the mechanics at a tiny size; at the cells' own sizes the control fails
    # their limits (test_benchmark_card.py)
    cell = make()
    kind = cells.kind(cell.traffic["kind"])
    st = kind.setup(cell, 3, CPU)
    kind.window(st, 0.2)
    got = kind.numbers(st, ("program", "control"))
    for name in cell.limits:
        assert got["control"][name] > got["program"][name], name


def _command(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "wide_3x512.dense_b1", "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_command_refuses_a_machine_without_a_card():
    p = _command(cells.ROOT)
    assert p.returncode == 2 and p.stdout == ""
    assert "CUDA card" in p.stderr


def test_command_refuses_a_checkout_without_the_program(tmp_path):
    shutil.copy(cells.SPEC, tmp_path / "BENCHMARK.json")
    shutil.copytree(cells.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _command(tmp_path, {"PYTHONPATH": ""})
    assert p.returncode == 2 and p.stdout == ""
    assert "the program is missing" in p.stderr
